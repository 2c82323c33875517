"""CUDA-graph capture and replay of the inference ops' kernel chains.

On the card the inference ops (``vfx_torch::fused_window_encoder``,
``vfx_torch::cre_stack``, ``vfx_torch::fused_gene_modulator``) are Python
chains of the kernels of ``ops/kernels.py``: a hundred to a few hundred
launches a call, each through ~26 us of Python (plans, checks,
``torch.empty``, ctypes). Beside threads that run Python (a sweep's host
builds), each launch also waits for the interpreter lock, and the card
idles between the launches. ``run`` captures a chain once for each input
signature as a CUDA graph and replays it (``CACHE.run``): a call is then a
few copies and one graph launch.

* Key: the op; each input's shape, dtype and strides; the device; the
  scalar arguments; the weights' data pointers, shapes, dtypes and strides.
  A new weight set (``set_params``, a reload) captures anew, so a graph
  never replays pointers that its key did not name.
* Miss: the inputs get static buffers outside the graphs' memory pool, the
  chain is captured on the device's capture stream into the pool that all
  graphs of the device share, and the graph replays for this call. The
  first call of an op on a device runs the chain as it is: it builds the
  kernels, loads their libraries and sets their attributes.
* Hit: the inputs are copied into the static buffers on the current
  stream, the graph replays there, and its output is copied into a fresh
  tensor, so that no caller holds graph memory.
* Memory: replays are serialised on one stream and each output is copied
  out before the next replay, so a graph's memory means something only
  during its own replay: the graphs share one pool, and an op's static
  inputs are views of one buffer an input, grown to the largest signature
  seen. A device keeps at most ``BOUND`` graphs and evicts the least
  recently used.
* Eager, as without graphs: a call inside a capture (the enclosing graph
  then takes the chain's launches), or with gradients enabled. CPU calls
  never come here: the ops' CPU kernels are the plain versions.

``kernels.GRAPHS`` counts, per op, the captures, replays and evictions; each
capture is the span ``graph.capture.<op>``. ``kernels.LAUNCHES`` counts host
launches, which only the first call and the captures make.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, NamedTuple, Sequence

import torch

from variantformer_tpu_torch.ops import kernels
from variantformer_tpu_torch.utils.profiling import span

# Graphs a device keeps: a sweep's bucket ladder at one batch size needs
# up to 10 encoder (6 CRE and 4 gene window counts), 6 CRE stack and 24
# gene stack graphs.
BOUND = 48

# One capture stream and one memory pool per device: the pool hands a block
# freed in one capture to a later one only on the stream it was freed on.
_CAPTURE: dict = {}


class CudaGraph:
    """One chain as a CUDA graph on ``device``: captured on the device's
    capture stream into the pool that its graphs share, replayed on the
    current stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.graph = torch.cuda.CUDAGraph()

    def capture(self, chain: Callable[[], torch.Tensor]) -> torch.Tensor:
        if self.device not in _CAPTURE:
            _CAPTURE[self.device] = (torch.cuda.Stream(self.device),
                                     torch.cuda.graph_pool_handle())
        stream, pool = _CAPTURE[self.device]
        stream.wait_stream(torch.cuda.current_stream(self.device))
        # Not torch.cuda.graph: its entry collects garbage and empties the
        # allocator's cache at every capture. Thread-local: the host-build
        # threads beside a capture may call CUDA.
        with torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                return chain()
            finally:
                self.graph.capture_end()

    def replay(self) -> None:
        self.graph.replay()


def capturing(device: torch.device) -> bool:
    """Whether the current stream is being captured (by another graph)."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


# What ``GraphCache`` captures with: a callable of the device that returns an
# object with ``capture(chain) -> output`` and ``replay()``.
graph_factory: Callable = CudaGraph


class _Entry(NamedTuple):
    op: str
    graph: object
    inputs: list          # the static inputs (None where the input is None)
    output: torch.Tensor  # the graph's output, in its pool


class _Device:
    """The graphs of one device, their static input buffers, the ops called
    there and the stream of the last replay."""

    def __init__(self):
        self.entries: OrderedDict = OrderedDict()
        self.slabs: dict = {}  # (op, input index) -> uint8 buffer
        self.seen: set = set()
        self.stream = None


def _signature(t: torch.Tensor | None):
    return None if t is None else (tuple(t.shape), t.dtype, t.stride())


def _static(slabs: dict, slot: tuple, x: torch.Tensor) -> torch.Tensor:
    """A contiguous buffer like ``x`` at the start of the slot's slab, which
    grows to the largest ``x`` seen (the graphs that read the smaller one
    keep it). Made outside inference mode, so that a call in any mode may
    copy into it."""
    nbytes = x.numel() * x.element_size()
    with torch.inference_mode(False):
        slab = slabs.get(slot)
        if slab is None or slab.numel() < nbytes:
            slab = slabs[slot] = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        return slab[:nbytes].view(x.dtype).view(x.shape)


class GraphCache:
    """The captured graphs of each device, at most ``bound`` a device."""

    def __init__(self, bound: int = BOUND):
        self.bound = bound
        self._devices: dict = {}
        self._lock = threading.Lock()

    def run(self, op: str, chain: Callable[..., torch.Tensor],
            inputs: Sequence[torch.Tensor | None], weights: Sequence[torch.Tensor],
            scalars: tuple) -> torch.Tensor:
        """``chain(*inputs)``, through the graph of this call's key. The
        chain reads ``weights`` and ``scalars`` from its closure; only
        ``inputs`` change between the replays of a graph."""
        device = inputs[0].device
        if torch.is_grad_enabled() or capturing(device):
            return chain(*inputs)
        key = (op, device, tuple(map(_signature, inputs)),
               tuple((w.data_ptr(), *_signature(w)) for w in weights), scalars)
        with self._lock:
            state = self._devices.setdefault(device, _Device())
            if op not in state.seen:
                state.seen.add(op)
                return chain(*inputs)
            entry = state.entries.get(key)
            if entry is None:
                entry = state.entries[key] = self._capture(state, op, chain, inputs)
                while len(state.entries) > self.bound:
                    kernels.GRAPHS[state.entries.popitem(last=False)[1].op]["evictions"] += 1
            else:
                state.entries.move_to_end(key)
            if device.type == "cuda":
                stream = torch.cuda.current_stream(device)
                if state.stream is not None and state.stream != stream:
                    stream.wait_stream(state.stream)
                state.stream = stream
            for static, x in zip(entry.inputs, inputs):
                if static is not None:
                    static.copy_(x)
            entry.graph.replay()
            kernels.GRAPHS[op]["replays"] += 1
            return entry.output.clone()

    def _capture(self, state: _Device, op: str, chain, inputs) -> _Entry:
        static = [None if x is None else _static(state.slabs, (op, i), x)
                  for i, x in enumerate(inputs)]
        graph = graph_factory(inputs[0].device)
        with span(f"graph.capture.{op}"):
            output = graph.capture(lambda: chain(*static))
        kernels.GRAPHS[op]["captures"] += 1
        return _Entry(op, graph, static, output)


CACHE = GraphCache()  # the process's graphs, which the ops' CUDA kernels run through

"""The device trace of a traced run, and what the readers take from it.

``Tracer`` records a ``torch.profiler`` trace (CPU and CUDA activities)
around a traced sub-window of whole calls, exports it as a Chrome trace
under the run's scratch directory and reduces it to a ``Trace``: the union
of device intervals (kernels, copies, sets), the kernel launches, the
device time by operation name, and the idle gaps named by the innermost
host event that covers each gap's middle: an aten op, a CUDA runtime call,
or else the harness's span around the call (``vfx_bench.<call>``), which
then means host work outside PyTorch (the host pipeline, Python). The
same events, read once, give ``Trace.spans``: the device and idle seconds
inside each of the program's spans (``spans.reduce_spans``).
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import os
import time
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    window_s: float                      # host seconds the profiler recorded
    busy_s: float                        # union of device intervals
    kernels: int                         # kernel launches that ran
    device_ops: list                     # [[name, seconds]] by total time, top 10
    idle_gaps: list                      # [[host event, seconds]] by total, top 10
    spans: object = None                 # spans.Spans of the same events


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce_events(events: list[dict], window_s: float) -> Trace:
    """A Chrome trace's complete events -> ``Trace`` (times in us there)."""
    dev, host = [], []
    kernels = 0
    by_name: dict[str, float] = defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            by_name[ev.get("name", "?")[:120]] += dur * 1e-6
            kernels += cat == "kernel"
        elif cat in HOST_CATS:
            host.append((ts, ts + dur, ev.get("name", "?")[:120]))
    merged = _union(dev)
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps: dict[str, float] = defaultdict(float)
    if merged:
        host.sort()
        lo = min(merged[0][0], host[0][0]) if host else merged[0][0]
        hi = max(merged[-1][1], max((h[1] for h in host), default=lo))
        edges = [lo] + [x for ab in merged for x in ab] + [hi]
        # Sweep the gaps in time order; a heap by duration holds the host
        # events begun so far, and its top, once no longer covering, never
        # covers a later gap.
        active: list = []
        i = 0
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            while i < len(host) and host[i][0] <= mid:
                heapq.heappush(active, (host[i][1] - host[i][0], host[i][1], host[i][2]))
                i += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            gaps[active[0][2] if active else "no host event"] += (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return Trace(window_s=window_s, busy_s=busy, kernels=kernels, device_ops=top(by_name),
                 idle_gaps=top(gaps))


class Tracer:
    """``with tracer.window(): ...`` profiles the block (a no-op when the
    run is not traced); ``tracer.trace`` is then its ``Trace``."""

    def __init__(self, enabled: bool, scratch: Path):
        self.enabled = enabled
        self.scratch = Path(scratch)
        self.trace: Trace | None = None

    def window(self):
        return _Window(self)


class _Window:
    def __init__(self, tracer: Tracer):
        self.t = tracer

    def __enter__(self):
        if not self.t.enabled:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.t.enabled:
            return False
        import torch

        from vfx_bench.spans import reduce_spans

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        path = self.t.scratch / "trace.json"
        self.prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        trace = reduce_events(events, window_s)
        trace.spans = reduce_spans(events)
        os.unlink(path)
        self.t.trace = trace
        return False

"""Serving export: the forward as a portable ``torch.export`` artifact.

The port of ``variantformer_tpu/api/serving.py``. A serving host should not
need the model-building Python: ``export_forward`` traces the forward once
for one batch shape into an ``ExportedProgram`` saved with
``torch.export.save``, and ``load_exported`` gives back a callable. The
weights stay outside the artifact, an input of the exported function
``fn(params, batch)``, so the artifact is the program (a few MB), not the
parameters (4.5 GiB at v4_pcg).

Contract: one artifact per device batch shape (D, C, G, L, T), the static
buckets the processors dispatch; the callable refuses a batch of another
shape with ``ValueError`` before it runs anything.

Two routes, as the JAX package's ``impl``:
  * ``"xla"`` (the default): ``seq2gene_forward_plain``, plain PyTorch ops;
  * ``"fused2"``: ``seq2gene_forward``, whose window encoders, gene stack
    and CRE stack are the ops ``vfx_torch::fused_window_encoder``,
    ``vfx_torch::fused_gene_modulator`` and ``vfx_torch::cre_stack``
    (``ops/fused_encoder.py``, ``ops/fused_modulator.py``,
    ``ops/cre_stack.py``): on the card they launch the hand-written kernel
    chains, built at first use, on the CPU their plain versions. Importing
    this module imports those modules, which registers the ops that
    ``load_exported`` needs.

The trace runs on fake tensors with the shapes and dtypes of ``params`` and
``batch`` on ``device``: nothing runs and no weight moves. On a host without
a card, ``device="cuda"`` cross-builds the card's artifact (the counterpart
of the JAX package's ``platforms=("tpu",)``).
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path

import torch
import torch.utils._pytree as pytree

from variantformer_tpu_torch.config import ModelConfig
from variantformer_tpu_torch.device import resolve_device
from variantformer_tpu_torch.models.seq2gene import (
    Seq2GeneBatch,
    Seq2GeneOutput,
    seq2gene_forward,
    seq2gene_forward_plain,
)

IMPLS = {"xla": seq2gene_forward_plain, "fused2": seq2gene_forward}
META = "vfx_serving.json"  # the artifact's extra file: route, device, batch shapes

_REGISTERED = False


def _register() -> None:
    """Serialized pytree names for the batch and output namedtuples (without
    them ``torch.export.save`` refuses the calling convention)."""
    global _REGISTERED
    if _REGISTERED:
        return
    for cls in (Seq2GeneBatch, Seq2GeneOutput):
        pytree._register_namedtuple(
            cls, serialized_type_name=f"variantformer_tpu_torch.{cls.__name__}")
    _REGISTERED = True


class _Forward(torch.nn.Module):
    def __init__(self, cfg: ModelConfig, forward):
        super().__init__()
        self.cfg, self.forward_fn = cfg, forward

    def forward(self, params, batch):
        return self.forward_fn(params, batch, self.cfg)


def _getitem(t: torch.Tensor, idx):
    """``t[idx]`` as the select, slice, unsqueeze and index ops that
    ``Tensor.__getitem__`` dispatches to, applied in its order (ints and
    slices first, then one ``index`` with the tensor indices at their
    dimensions)."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    given = sum(1 for i in idx if i is not None and i is not Ellipsis)
    out, dim, tensors = t, 0, []
    for item in idx:
        if item is Ellipsis:
            dim += t.dim() - given
        elif item is None:
            out = out.unsqueeze(dim)
            dim += 1
        elif isinstance(item, bool) or (isinstance(item, torch.Tensor)
                                        and item.dtype == torch.bool):
            raise NotImplementedError("boolean indexing in a cross-built forward")
        elif isinstance(item, int):
            out = out.select(dim, item)
        elif isinstance(item, slice):
            stop = out.shape[dim] if item.stop is None else item.stop
            out = torch.ops.aten.slice.Tensor(out, dim, item.start or 0, stop, item.step or 1)
            dim += 1
        elif isinstance(item, torch.Tensor):
            tensors += [None] * (dim - len(tensors)) + [item]
            dim += 1
        else:
            raise NotImplementedError(f"index {item!r} in a cross-built forward")
    return torch.ops.aten.index.Tensor(out, tensors) if tensors else out


class _DispatchedIndexing(torch.overrides.TorchFunctionMode):
    """A PyTorch built without CUDA cannot take ``Tensor.__getitem__`` on a
    fake CUDA tensor (it sets a CUDA device guard first); the ops it
    dispatches to can. Used only to cross-build a card's artifact on such a
    host."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.__getitem__:
            return _getitem(*args)
        return func(*args, **(kwargs or {}))


def _shape_meta(batch: Seq2GeneBatch) -> dict:
    return {name: None if leaf is None else [list(leaf.shape), str(leaf.dtype)]
            for name, leaf in batch._asdict().items()}


def export_forward(cfg: ModelConfig, params, batch: Seq2GeneBatch, out_path: str | Path,
                   impl: str = "xla", device: str | torch.device = "cuda") -> str:
    """Serialize the forward for ``batch``'s exact shapes, for ``device``.

    ``params`` and ``batch`` may be tensors on any device (only their shapes
    and dtypes are read). ``impl="xla"`` exports the plain forward,
    ``"fused2"`` the kernel route. Returns the artifact's path."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}: one of {sorted(IMPLS)}")
    dev = torch.device(device)
    cross = dev.type == "cuda" and not torch.cuda.is_available()
    if not cross:
        resolve_device(dev)
    _register()
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = lambda t: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=dev)
        args = pytree.tree_map_only(torch.Tensor, fake, (params, batch))
    with torch.no_grad(), (_DispatchedIndexing() if cross else contextlib.nullcontext()):
        exported = torch.export.export(_Forward(cfg, IMPLS[impl]), args)
    # The fake example inputs are not part of the contract (``fn`` checks the
    # batch's shapes itself) and would not load without unpickling arbitrary
    # objects.
    exported.example_inputs = None
    meta = {"impl": impl, "device": dev.type, "batch": _shape_meta(batch)}
    out_path = Path(out_path)
    torch.export.save(exported, out_path, extra_files={META: json.dumps(meta)})
    return str(out_path)


def load_exported(path: str | Path, device: str | torch.device = "cuda"):
    """Deserialize a serving artifact into ``fn(params, batch) ->
    Seq2GeneOutput`` on ``device`` (the artifact's own: an artifact for the
    card runs on the card, and raises where there is none). The batch's
    shapes and dtypes must be the export's, else ``ValueError``."""
    dev = resolve_device(device)
    _register()
    extra = {META: ""}
    exported = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[META])
    if meta["device"] != dev.type:
        raise ValueError(f"{path}: built for {meta['device']}, asked to run on {dev.type}")
    module = exported.module()

    def fn(params, batch: Seq2GeneBatch) -> Seq2GeneOutput:
        got = _shape_meta(batch)
        if got != meta["batch"]:
            diff = {k: (got[k], v) for k, v in meta["batch"].items() if got[k] != v}
            raise ValueError(f"batch shapes differ from the export's (got, exported): {diff}")
        with torch.inference_mode():
            return module(params, batch)

    return fn

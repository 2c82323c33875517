"""The mesh: ranks as a (data, model) grid, and the layouts of parameters,
batches and optimizer state over it. The port of
``variantformer_tpu/parallel/mesh.py`` on ``torch.distributed``.

JAX lays shardings on global arrays and lets GSPMD insert the collectives.
Here every rank runs the same program on its own slice and the collectives
are explicit (``parallel/comm.py``):

  * **model** (tensor parallelism, the layered route ``impl="xla"``): each
    rank of a data row holds a contiguous run of whole heads of ``wqkv``,
    ``wq``, ``wkv`` (head-major packing), chunk ``m`` of the value AND of
    the gate half of GeGLU's ``ffn_in`` (``[value | gate]``: a plain
    contiguous chunk would give rank 0 all values and rank 1 all gates), and
    the matching rows of ``out`` and ``ffn_out``, whose partial products are
    all-reduced over the model group (``models/core.py``);
  * **data**: donors (the donor partition) or tissues and windows (the
    tissue partition) split over the ranks of a model column, the outputs
    all-gathered over them.

The whole-stack kernels (#1, #2 and their backwards #3-#6) cannot be split
by head, but need not be: ``donor_dp_forward``/``donor_dp_train_step`` run
them intact on each rank's donors with whole weights, and
``tissue_dp_forward`` on each rank's windows and tissues, over ALL ranks
jointly (the JAX package's ``shard_map`` programs).

A leaf whose split axis does not divide its group is kept whole on every
rank (the JAX package's ``shard_batch`` rule, one warning per shape); every
rank of the group then computes all of it, and its outputs are not gathered.
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from variantformer_tpu_torch.models.params import leaves
from variantformer_tpu_torch.models.seq2gene import (
    Seq2GeneBatch,
    Seq2GeneOutput,
    WindowSplit,
    _forward,
    seq2gene_forward,
)
from variantformer_tpu_torch.parallel import comm, launch

log = logging.getLogger(__name__)


class Mesh:
    """The ranks ``devices`` ([data, model] array of global ranks) and this
    rank's process groups: its data row's ``model_group``, its model
    column's ``data_group`` and ``all_group`` (every rank of the mesh). Every
    rank builds the groups in the same order, as ``dist.new_group`` needs."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray, device: torch.device):
        self.devices = devices
        self.shape = {"data": devices.shape[0], "model": devices.shape[1]}
        self.device = device
        self.rank = dist.get_rank()
        rows, cols, self.all_group = _new_groups(devices)
        flat = [int(r) for r in devices.reshape(-1)]
        where = np.argwhere(devices == self.rank)
        if not len(where):
            raise ValueError(f"rank {self.rank} is not in the mesh {flat}")
        self.coords = tuple(int(i) for i in where[0])
        self.model_group = rows[self.coords[0]]
        self.data_group = cols[self.coords[1]]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']}, rank={self.rank})"


def _new_groups(devices: np.ndarray) -> tuple[list, list, object]:
    """The process groups of a mesh over ``devices``: each row's, each
    column's and all of its ranks'. Every rank of the world makes every
    group, members or not, in this order (``dist.new_group``'s rule)."""
    rows = [dist.new_group([int(r) for r in row]) for row in devices]
    cols = [dist.new_group([int(r) for r in col]) for col in devices.T]
    flat = [int(r) for r in devices.reshape(-1)]
    all_group = (dist.group.WORLD if flat == list(range(dist.get_world_size()))
                 else dist.new_group(flat))
    return rows, cols, all_group


def make_mesh(num_model: int | None = None, devices=None, device=None) -> Mesh:
    """The world's ranks (or the listed ones) reshaped (data, model) in
    order: rank ``r`` sits at ``(r // num_model, r % num_model)``.
    ``num_model`` defaults to the first of 4, 2, 1 that divides them.
    Needs a process group (``parallel/launch.initialize_distributed``)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel/launch.initialize_distributed() first")
    devices = list(range(dist.get_world_size())) if devices is None else list(devices)
    n = len(devices)
    if num_model is None:
        num_model = next(m for m in (4, 2, 1) if n % m == 0)
    if n % num_model:
        raise ValueError(f"{n} ranks do not split into model groups of {num_model}")
    return Mesh(np.asarray(devices).reshape(n // num_model, num_model),
                launch.rank_device(device))


def make_node_mesh(node_size: int, num_model: int | None = None, device=None) -> Mesh:
    """This rank's node's mesh, for runs where each node of ``node_size``
    consecutive ranks works alone (the genome-wide launcher's ``--mesh``:
    the JAX package's mesh over one host's local devices). Every rank makes
    every node's groups, in node order, as ``dist.new_group`` needs; only
    its own node's become a ``Mesh``."""
    if not dist.is_initialized():
        raise RuntimeError("make_node_mesh needs a process group: call "
                           "parallel/launch.initialize_distributed() first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if node_size < 1 or world % node_size:
        raise ValueError(f"{world} ranks do not split into nodes of {node_size}")
    if num_model is None:
        num_model = next(m for m in (4, 2, 1) if node_size % m == 0)
    if node_size % num_model:
        raise ValueError(f"{node_size} ranks do not split into model groups of {num_model}")
    mine = None
    for lo in range(0, world, node_size):
        devices = np.arange(lo, lo + node_size).reshape(node_size // num_model, num_model)
        if lo <= rank < lo + node_size:
            mine = Mesh(devices, launch.rank_device(device))
        else:
            _new_groups(devices)
    return mine


# -- parameters --------------------------------------------------------------

# Leaf-name -> which axis (counted from the end) carries the "model" split.
_MODEL_AXIS_FROM_END = {
    ("ffn_in", "w"): 1,
    ("ffn_in", "b"): 1,
    ("ffn_out", "w"): 2,
    ("wqkv", "w"): 1,
    ("wqkv", "b"): 1,
    ("wkv", "w"): 1,
    ("wkv", "b"): 1,
    ("wq", "w"): 1,
    ("wq", "b"): 1,
    ("out", "w"): 2,   # attention out-projection contracts the split dim
}


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    return fn(path, tree)


def _spec(path, leaf) -> int | None:
    axis_from_end = _MODEL_AXIS_FROM_END.get(tuple(path[-2:]))
    ndim = getattr(leaf, "ndim", 0)
    if axis_from_end is None or ndim < axis_from_end:
        return None
    return ndim - axis_from_end


def param_specs(params) -> dict:
    """The tree of split axes: each leaf's axis split over "model", or None
    (replicated)."""
    return _map_with_path(_spec, params)


def _model_slice(path, t: torch.Tensor, axis: int, m: int, j: int) -> torch.Tensor:
    """Rank ``j``'s slice of ``t`` along ``axis`` split ``m`` ways; for
    ``ffn_in`` chunk ``j`` of the value half and of the gate half."""
    size = t.shape[axis]
    if path[-2] == "ffn_in":
        half = size // 2
        if size % 2 or half % m:
            raise ValueError(f"{'/'.join(path)}: GeGLU width {half} does not split "
                             f"over a model axis of {m}")
        k = half // m
        return torch.cat([t.narrow(axis, j * k, k), t.narrow(axis, half + j * k, k)], axis)
    if size % m:
        raise ValueError(f"{'/'.join(path)}: axis {axis} of {size} does not split over "
                         f"a model axis of {m}")
    k = size // m
    return t.narrow(axis, j * k, k)


def _model_unslice(path, t: torch.Tensor, axis: int, mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every model rank's slice (the inverse of
    ``_model_slice``; a collective over the model group)."""
    parts = comm.all_gather_cat(t, mesh.model_group, axis).chunk(mesh.shape["model"], axis)
    if path[-2] == "ffn_in":
        halves = [p.chunk(2, axis) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], axis)
    return torch.cat(parts, axis)


def shard_params(params, mesh: Mesh):
    """This rank's slice of every split leaf (``param_specs``) on the mesh's
    device, the other leaves whole. A width the model axis does not divide
    raises ``ValueError``, as ``device_put`` refuses an uneven shard."""
    m, j = mesh.shape["model"], mesh.coords[1]

    def place(path, leaf):
        t = _tensor(leaf)
        axis = _spec(path, t)
        if axis is not None and m > 1:
            t = _model_slice(path, t, axis, m, j).contiguous()
        return t.to(mesh.device)

    return _map_with_path(place, params)


def unshard_params(params, mesh: Mesh):
    """Whole leaves from every rank's ``shard_params`` slices (a collective
    over each model group)."""
    if mesh.shape["model"] == 1:
        return params

    def whole(path, t):
        axis = _spec(path, t)
        return t if axis is None else _model_unslice(path, t, axis, mesh)

    return _map_with_path(whole, params)


def check_model_split(cfg, mesh: Mesh) -> None:
    """Raise ``ValueError`` unless the model axis divides every head count
    and GeGLU width (half of ``ffn_in``'s) of ``cfg``: a split inside a head
    would be wrong."""
    m = mesh.shape["model"]
    wcfg, mcfg = cfg.window_encoder, cfg.seq2gene
    for what, n in (("window-encoder heads", wcfg.num_heads),
                    ("window-encoder GeGLU width", wcfg.ffn_hidden_dim // 2),
                    ("gene/CRE heads", mcfg.num_heads),
                    ("gene/CRE GeGLU width", mcfg.ffn_hidden_dim // 2)):
        if n % m:
            raise ValueError(f"{what} {n} do not split over a model axis of {m}")


def replicate_params(params, mesh: Mesh):
    """Every leaf whole on the mesh's device (the donor and tissue
    partitions run the whole-stack kernels on whole weights)."""
    return _map_with_path(lambda _, leaf: _tensor(leaf).to(mesh.device), params)


# -- batches -----------------------------------------------------------------


class MeshBatch(NamedTuple):
    """This rank's shard of a batch, and what was split over ``group``."""

    local: Seq2GeneBatch
    group: Any
    donors: bool = False
    tissues: bool = False
    cre_windows: bool = False
    gene_windows: bool = False


def batch_specs(batch: Seq2GeneBatch, partition: str = "donor") -> Seq2GeneBatch:
    """The split axis of every leaf under a partition, or None.

    "donor": donor-leading leaves split; tissue ids and the dedup pools stay
    whole. "tissue" (single-donor scale-out): ``tissue_ids`` and the CRE and
    gene window axes of the tokens and token lengths split; counts, labels
    and token positions stay whole (they index GLOBAL window axes), and with
    dedup pools the windows stay whole too (their gathers are global)."""
    if partition not in ("donor", "tissue"):
        raise ValueError(f"unknown batch partition {partition!r}")
    pooled = batch.cre_pool_tokens is not None

    def donor_spec(name, leaf):
        if leaf is None or name == "tissue_ids" or "pool" in name:
            return None
        return 0

    def tissue_spec(name, leaf):
        if leaf is None:
            return None
        if name == "tissue_ids":
            return 0
        if name in ("cre_tokens", "gene_tokens", "cre_tok_len", "gene_tok_len"):
            return None if pooled else 1
        return None

    spec_for = donor_spec if partition == "donor" else tissue_spec
    return Seq2GeneBatch(**{name: spec_for(name, getattr(batch, name))
                            for name in batch._fields})


_UNEVEN_WARNED: set = set()

_WINDOWS = {"cre_tokens": "cre_windows", "cre_tok_len": "cre_windows",
            "gene_tokens": "gene_windows", "gene_tok_len": "gene_windows"}


def _tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))


def _split_batch(batch: Seq2GeneBatch, specs: Seq2GeneBatch, group, device,
                 uneven: str) -> MeshBatch:
    """``batch``'s leaves sliced to this rank's part of ``group`` along
    their spec axes. ``uneven="replicate"`` keeps a leaf whose axis the
    group does not divide whole (warned once per shape); ``"raise"``
    refuses it."""
    n, i = dist.get_world_size(group), dist.get_rank(group)
    split: dict[str, bool] = {}
    vals = {}
    for name in batch._fields:
        leaf = getattr(batch, name)
        if leaf is None:
            vals[name] = None
            continue
        t = _tensor(leaf)
        axis = getattr(specs, name)
        if axis is None:
            vals[name] = t.to(device)
            continue
        kind = "tissues" if name == "tissue_ids" else "donors" if axis == 0 else _WINDOWS[name]
        if t.shape[axis] % n:
            if uneven == "raise":
                raise ValueError(f"{name} axis {axis} ({t.shape[axis]}) does not split over "
                                 f"{n} ranks: pad it first")
            key = (name, axis, t.shape[axis], n)
            if key not in _UNEVEN_WARNED:  # once per shape, not per forward
                _UNEVEN_WARNED.add(key)
                log.warning("shard_batch: %s dim %d (%d) not divisible by %d ranks; "
                            "replicating", name, axis, t.shape[axis], n)
            axis = None
        if axis is not None:
            k = t.shape[axis] // n
            t = t.narrow(axis, i * k, k)
        split[kind] = split.get(kind, True) and axis is not None
        vals[name] = t.to(device)
    return MeshBatch(Seq2GeneBatch(**vals), group, **split)


def shard_batch(batch: Seq2GeneBatch, mesh: Mesh, partition: str = "donor") -> MeshBatch:
    """This rank's shard of ``batch`` over its data group (the layered
    route's layout; see ``batch_specs``)."""
    return _split_batch(batch, batch_specs(batch, partition), mesh.data_group, mesh.device,
                        "replicate")


def pad_tissue_axis(batch: Seq2GeneBatch, mesh: Mesh, multiple: int | None = None
                    ) -> tuple[Seq2GeneBatch, int]:
    """Pad every tissue-partition axis to a multiple of the data axis (or of
    ``multiple``: the kernel route splits over every rank): ``tissue_ids``
    repeating the last id, the CRE and gene window axes with zero windows
    past the counts (``cre_labels`` too). Returns the padded batch and the
    original tissue count: slice outputs back to ``[:, :t]``."""
    t = batch.tissue_ids.shape[0]
    data = multiple if multiple is not None else mesh.shape["data"]
    repl = {}
    tids = _tensor(batch.tissue_ids)
    if (-t) % data:
        repl["tissue_ids"] = torch.cat([tids, tids[-1:].repeat((-t) % data)])
    for names in (("cre_tokens", "cre_tok_len", "cre_labels"), ("gene_tokens", "gene_tok_len")):
        n = getattr(batch, names[0]).shape[1]
        pad = (-n) % data
        if not pad:
            continue
        for name in names:
            leaf = _tensor(getattr(batch, name))
            widths = [0, 0] * (leaf.dim() - 2) + [0, pad, 0, 0]
            repl[name] = torch.nn.functional.pad(leaf, widths)
    return (batch._replace(**repl) if repl else batch), t


def _gather_output(out: Seq2GeneOutput, mb: MeshBatch) -> Seq2GeneOutput:
    """The four outputs whole on every rank: gathered along the donor and/or
    tissue axis where ``mb`` split them, in rank order."""
    fields = list(out[:4])
    if mb.donors:
        fields = [comm.all_gather_cat(x, mb.group, 0) for x in fields]
    if mb.tissues:
        fields = [comm.all_gather_cat(x, mb.group, 1) for x in fields]
    return Seq2GeneOutput(*fields)


def sharded_forward(cfg, mesh: Mesh, impl: str = "xla"):
    """``fn(params, mesh_batch) -> Seq2GeneOutput`` for the layered route:
    ``shard_params`` weights, a ``shard_batch`` batch, heads and FFN
    columns split over the model group, the outputs whole on every rank."""

    def fn(params, mb: MeshBatch) -> Seq2GeneOutput:
        split = None
        if mb.cre_windows or mb.gene_windows:
            split = WindowSplit(mb.group, mb.cre_windows, mb.gene_windows)
        with torch.inference_mode(), comm.tensor_parallel(mesh.model_group):
            out = _forward(params, mb.local, cfg, plain=False, return_streams=False,
                           impl=impl, window_split=split)
            return _gather_output(out, mb)

    return fn


# -- the kernel route over every rank (the JAX package's shard_map programs) --


def shard_batch_donor_all(batch: Seq2GeneBatch, mesh: Mesh) -> MeshBatch:
    """Donor-leading leaves split over ALL ranks jointly; tissue ids and the
    dedup pools stay whole. The donor count must divide the rank count:
    pad first (``VCFProcessor._forward`` does)."""
    return _split_batch(batch, batch_specs(batch, "donor"), mesh.all_group, mesh.device,
                        "raise")


def shard_targets_donor_all(targets, mesh: Mesh) -> torch.Tensor:
    """[D, ...] per-donor targets/masks: this rank's rows of the split over
    ALL ranks (the donor-partition layout)."""
    return _split_leading(targets, mesh.all_group, mesh.device)


def _split_leading(x, group, device) -> torch.Tensor:
    t = _tensor(x)
    n, i = dist.get_world_size(group), dist.get_rank(group)
    if t.shape[0] % n:
        raise ValueError(f"leading axis {t.shape[0]} does not split over {n} ranks")
    k = t.shape[0] // n
    return t[i * k:(i + 1) * k].to(device)


def donor_dp_forward(cfg, mesh: Mesh, impl: str = "fused2"):
    """``fn(params, mesh_batch) -> Seq2GeneOutput``: each rank runs the
    intact forward (the whole-stack kernels on the card) on its donors with
    whole weights (``replicate_params``) and a ``shard_batch_donor_all``
    batch; the outputs are all-gathered along the donor axis."""

    def fn(params, mb: MeshBatch) -> Seq2GeneOutput:
        with torch.inference_mode():
            out = seq2gene_forward(params, mb.local, cfg, impl=impl)
            return _gather_output(out, mb)

    return fn


def shard_batch_tissue_all(batch: Seq2GeneBatch, mesh: Mesh) -> MeshBatch:
    """Window axes and the tissue axis split over ALL ranks jointly; counts,
    labels and token positions stay whole (they index GLOBAL window axes).
    Pad first with ``pad_tissue_axis(batch, mesh, multiple=mesh.size)``."""
    return _split_batch(batch, batch_specs(batch, "tissue"), mesh.all_group, mesh.device,
                        "raise")


def tissue_dp_forward(cfg, mesh: Mesh, impl: str = "fused2"):
    """``fn(params, mesh_batch) -> Seq2GeneOutput`` for the tissue
    partition over every rank: each rank encodes its window shard on the
    whole-stack encoder, the window embeddings are all-gathered, the CRE
    stack runs whole on every rank and the gene stack on its tissue shard;
    the four outputs are all-gathered along the tissue axis."""

    def fn(params, mb: MeshBatch) -> Seq2GeneOutput:
        group = mb.group if mb.cre_windows else None
        with torch.inference_mode():
            out = seq2gene_forward(params, mb.local, cfg, impl=impl, window_group=group)
            return _gather_output(out, mb)

    return fn


# -- training ----------------------------------------------------------------


def shard_train_state(state, mesh: Mesh):
    """The layered-route training layout, in place: every split leaf of
    ``state.params`` becomes this rank's ``shard_params`` slice (the
    optimizer holds the same tensors, and any optimizer moment is sliced
    alike, so its state follows its parameter's split). Returns the state
    with ``mesh`` set: its step then runs the layered route with heads and
    FFN columns split over the model group and all-reduces the gradients
    over the data group (``train/steps.py``)."""
    from variantformer_tpu_torch.train.optimizer import base_optimizer

    m, j = mesh.shape["model"], mesh.coords[1]
    slices: dict[int, tuple] = {}

    def place(path, t):
        axis = _spec(path, t)
        with torch.no_grad():
            if axis is not None and m > 1:
                slices[id(t)] = (path, axis)
                t.data = _model_slice(path, t.data, axis, m, j).contiguous().to(mesh.device)
            else:
                t.data = t.data.to(mesh.device)
        return t

    _map_with_path(place, state.params)
    inner = base_optimizer(state.opt)
    for p, moments in inner.state.items():
        for name, v in moments.items():
            if isinstance(v, torch.Tensor) and v.dim():
                v = v.to(mesh.device)
                if id(p) in slices:
                    path, axis = slices[id(p)]
                    v = _model_slice(path, v, axis, m, j).contiguous()
                moments[name] = v
    return state._replace(mesh=mesh)


def whole_train_state(state, opt_state: dict) -> tuple[dict, dict]:
    """(params, optimizer state_dict) of a ``shard_train_state`` state with
    every split leaf and moment whole again (a collective over the model
    group), the layout a checkpoint keeps."""
    from variantformer_tpu_torch.train.optimizer import base_optimizer

    mesh = state.mesh
    if mesh.shape["model"] == 1:
        return state.params, opt_state
    where: dict[int, tuple] = {}
    _map_with_path(lambda path, t: where.setdefault(id(t), (path, _spec(path, t))),
                   state.params)
    order = [where[id(t)] for g in base_optimizer(state.opt).param_groups for t in g["params"]]

    def whole(i, v):
        path, axis = order[i]
        if axis is None or not isinstance(v, torch.Tensor) or v.dim() == 0:
            return v
        return _model_unslice(path, v, axis, mesh)

    nested = "inner" in opt_state
    inner = dict(opt_state["inner"] if nested else opt_state)
    inner["state"] = {i: {k: whole(i, v) for k, v in m.items()}
                      for i, m in inner["state"].items()}
    if nested:
        opt_state = {**opt_state, "inner": inner}
        if opt_state.get("acc") is not None:
            opt_state["acc"] = [whole(i, a) for i, a in enumerate(opt_state["acc"])]
    else:
        opt_state = inner
    return unshard_params(state.params, mesh), opt_state


def _shard_step_arg(a, group, device):
    if isinstance(a, Seq2GeneBatch):
        return _split_batch(a, batch_specs(a, "donor"), group, device, "raise").local
    if getattr(a, "ndim", 0) >= 1:
        return _split_leading(a, group, device)
    return a


def shard_targets(targets, mesh: Mesh) -> torch.Tensor:
    """[D, ...] per-donor targets/masks: this rank's rows of the split over
    its data group."""
    return _split_leading(targets, mesh.data_group, mesh.device)


def shard_step_args(args: tuple, mesh: Mesh) -> tuple:
    """One train-step arg tuple as this rank's shard over its data group:
    a ``Seq2GeneBatch`` by donors (``batch_specs``), bare arrays by their
    leading axis, scalars as they are. The leading axes must divide the
    data axis (the JAX package's ``device_put`` refuses uneven shards)."""
    return tuple(_shard_step_arg(a, mesh.data_group, mesh.device) for a in args)


class ShardFn:
    """A batch placement for ``train.loop.fit(shard_fn=...)`` and the eval
    losses: args -> this rank's shard over ``group``; ``tp`` is the model
    group the step's layered route splits over (None: no split)."""

    def __init__(self, mesh: Mesh, group, tp=None):
        self.mesh, self.group, self.tp = mesh, group, tp

    def __call__(self, args: tuple) -> tuple:
        return tuple(_shard_step_arg(a, self.group, self.mesh.device) for a in args)


def data_shard_fn(mesh: Mesh) -> ShardFn:
    """``fit(mesh=...)``'s placement: shards over the data group, the layered
    route split over the model group."""
    return ShardFn(mesh, mesh.data_group, mesh.model_group)


def donor_dp_shard_fn(mesh: Mesh) -> ShardFn:
    """Per-batch placement for ``fit(shard_fn=...)`` under the donor
    partition: batches and targets split donor-leading over ALL ranks. Pair
    with ``donor_dp_train_step`` and ``replicate_train_state``."""
    return ShardFn(mesh, mesh.all_group)


def replicate_train_state(state, mesh: Mesh):
    """The donor-partition training layout: parameters and optimizer state
    whole on every rank (moved to the mesh's device in place); only the
    batch is split."""
    from variantformer_tpu_torch.train.optimizer import base_optimizer

    with torch.no_grad():
        for t in leaves(state.params):
            t.data = t.data.to(mesh.device)
        for moments in base_optimizer(state.opt).state.values():
            for name, v in moments.items():
                if isinstance(v, torch.Tensor) and v.dim():
                    moments[name] = v.to(mesh.device)
    return state


def donor_dp_value_and_grad(cfg, mesh: Mesh, impl: str = "fused2",
                            freeze_tokenizers: bool = False,
                            train_gene_tokenizer: bool = True):
    """``fn(params, local_batch, targets, mask) -> loss`` under the donor
    partition, leaving the gradients on the parameters: each rank's
    gradient of its masked-loss SUM (its backward the whole-stack autograd
    Functions, #3-#6 on the card), then ONE all-reduce over every rank of a
    flat bucket of the gradients in the parameters' order, the loss sums
    and the mask counts, and a division by ``max(count, 1)``: the
    single-device mean-loss gradient, reduced in a fixed order (the same
    bits run after run)."""
    from variantformer_tpu_torch.train.steps import seq2gene_loss_sum

    if impl not in ("xla", "fused", "fused2"):
        raise ValueError(f"training impl must be 'xla', 'fused' or 'fused2', got {impl!r}")

    def fn(params, b, targets, mask) -> torch.Tensor:
        if impl == "fused2" and "gene_layers_packed" in params:
            raise ValueError("fused2 training params must not contain 'gene_layers_packed'")
        s, c = seq2gene_loss_sum(params, b, targets, mask, cfg, impl=impl,
                                 stop_cre_grads=freeze_tokenizers,
                                 stop_gene_grads=freeze_tokenizers and not train_gene_tokenizer)
        s.backward()
        return comm.reduce_gradients(leaves(params), s, c, mesh.all_group)

    return fn


def donor_dp_train_step(cfg, mesh: Mesh, opt, impl: str = "fused2",
                        freeze_tokenizers: bool = False,
                        train_gene_tokenizer: bool = True, plateau: str = "epoch",
                        shard_optimizer: bool = False):
    """``step(state, local_batch, targets, mask, plateau_value=None) ->
    (state, loss)``: donor-partition training with the whole-stack kernels
    intact on every rank (``donor_dp_value_and_grad``), then the optimizer
    update, the same on every rank. With ``shard_optimizer`` the state's
    optimizer must be a ``Zero1Optimizer`` (checked):
    each rank updates its slice and the parameters are all-gathered."""
    from variantformer_tpu_torch.train.optimizer import apply_update
    from variantformer_tpu_torch.train.steps import TrainState, _check_plateau, _update_value

    _check_plateau(opt, plateau)
    vg = donor_dp_value_and_grad(cfg, mesh, impl=impl,
                                 freeze_tokenizers=freeze_tokenizers,
                                 train_gene_tokenizer=train_gene_tokenizer)

    def step(state: TrainState, b, targets, mask, plateau_value=None):
        if shard_optimizer != isinstance(state.opt, Zero1Optimizer):
            raise ValueError("shard_optimizer=True needs a Zero1Optimizer, and only it")
        state.opt.zero_grad(set_to_none=True)
        loss = vg(state.params, b, targets, mask)
        apply_update(state.opt, _update_value(plateau, plateau_value, loss))
        return state._replace(step=state.step + 1), loss

    return step


# -- ZeRO-1 ------------------------------------------------------------------


def _zero1_axis(shape, n: int) -> int | None:
    """The largest axis that ``n`` divides (the first of equal sizes)."""
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if s % n == 0 and s > best_size:
            best, best_size = i, s
    return best


def opt_state_specs(opt, mesh: Mesh) -> list:
    """The ZeRO-1 split axis of each parameter's Adam moments, in the
    optimizer's parameter order (None: the moments stay whole): the largest
    axis the rank count divides."""
    from variantformer_tpu_torch.train.optimizer import base_optimizer

    if isinstance(opt, Zero1Optimizer):
        return list(opt._axes)
    return [_zero1_axis(t.shape, mesh.size) if t.dim() else None
            for g in base_optimizer(opt).param_groups for t in g["params"]]


class Zero1Optimizer:
    """ZeRO-1 over every rank of a mesh: each parameter's Adam moments live
    as this rank's slice along ``opt_state_specs``'s axis. ``step(value)``
    updates the slice of each such parameter from the slice of its gradient
    (the update is elementwise, so the numbers are the replicated
    optimizer's), then all-gathers the parameter whole; parameters with no
    such axis are updated whole on every rank. The plateau scale and
    gradient accumulation of ``make_optimizer``'s optimizer are kept: the
    same wrapper is rebuilt around the sliced Adam/AdamW."""

    def __init__(self, opt, mesh: Mesh):
        from variantformer_tpu_torch.train.optimizer import ScheduledOptimizer, base_optimizer

        inner = base_optimizer(opt)
        self.mesh = mesh
        n, r = mesh.size, dist.get_rank(mesh.all_group)
        self._full, self._shards, self._axes = [], [], []
        groups = []
        for g in inner.param_groups:
            shards = []
            for t in g["params"]:
                axis = _zero1_axis(t.shape, n) if t.dim() else None
                if axis is None:
                    s = t
                else:
                    k = t.shape[axis] // n
                    s = t.detach().narrow(axis, r * k, k).clone().requires_grad_(True)
                self._full.append(t)
                self._shards.append(s)
                self._axes.append(axis)
                shards.append(s)
            groups.append({**{k: v for k, v in g.items() if k != "params"}, "params": shards})
        accepted = inspect.signature(type(inner)).parameters
        sliced = type(inner)(groups, **{k: v for k, v in inner.defaults.items()
                                        if k in accepted})
        if isinstance(opt, ScheduledOptimizer):
            self.opt = ScheduledOptimizer(sliced, opt.monitor, opt.every_k)
        else:
            self.opt = sliced
        self.plateau = getattr(opt, "plateau", "epoch")
        if inner.state:
            self.load_state_dict(opt.state_dict())

    @property
    def param_groups(self) -> list[dict]:
        return [{"params": self._full}]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for t in self._full:
            t.grad = None
        self.opt.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, value: float = 1.0) -> bool:
        from variantformer_tpu_torch.train.optimizer import ScheduledOptimizer, set_lr_scale

        n, r = self.mesh.size, dist.get_rank(self.mesh.all_group)
        for t, s, axis in zip(self._full, self._shards, self._axes):
            if axis is not None:
                k = t.shape[axis] // n
                s.grad = None if t.grad is None else t.grad.narrow(axis, r * k, k).clone()
        if isinstance(self.opt, ScheduledOptimizer):
            moved = self.opt.step(value)
        else:
            set_lr_scale(self.opt, value)
            self.opt.step()
            moved = True
        if moved:
            for t, s, axis in zip(self._full, self._shards, self._axes):
                if axis is not None:
                    t.copy_(comm.all_gather_cat(s, self.mesh.all_group, axis))
        return moved

    def state_dict(self) -> dict:
        """The unsliced optimizer's ``state_dict`` (moments all-gathered: a
        collective), so a checkpoint restores into either layout."""
        group = self.mesh.all_group

        def whole(i, v):
            axis = self._axes[i]
            if axis is None or not isinstance(v, torch.Tensor) or v.dim() == 0:
                return v
            return comm.all_gather_cat(v, group, axis)

        # New dicts throughout: ``Optimizer.state_dict`` hands out the live
        # per-parameter state, which must keep this rank's slices.
        d = self.opt.state_dict()
        nested = "inner" in d
        inner = dict(d["inner"] if nested else d)
        inner["state"] = {i: {k: whole(i, v) for k, v in m.items()}
                          for i, m in inner["state"].items()}
        if not nested:
            return inner
        d = {**d, "inner": inner}
        if d.get("acc") is not None:
            d["acc"] = [None if a is None else whole(i, a) for i, a in enumerate(d["acc"])]
        return d

    def load_state_dict(self, d: dict) -> None:
        """Restore an unsliced ``state_dict``, keeping this rank's slices."""
        import copy

        d = copy.copy(d)
        nested = "inner" in d
        inner = copy.copy(d["inner"] if nested else d)
        n, r = self.mesh.size, dist.get_rank(self.mesh.all_group)
        state = {}
        for i, moments in inner["state"].items():
            axis = self._axes[i]
            state[i] = {}
            for name, v in moments.items():
                if axis is not None and isinstance(v, torch.Tensor) and v.dim():
                    k = v.shape[axis] // n
                    v = v.narrow(axis, r * k, k).clone()
                state[i][name] = v
        inner["state"] = state
        if nested:
            d["inner"] = inner
            if d.get("acc") is not None:
                d["acc"] = [a if a is None or ax is None
                            else a.narrow(ax, r * (a.shape[ax] // n), a.shape[ax] // n).clone()
                            for a, ax in zip(d["acc"], self._axes)]
        self.opt.load_state_dict(d if nested else inner)


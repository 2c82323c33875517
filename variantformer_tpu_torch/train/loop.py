"""Epoch-level training driver: the port of ``variantformer_tpu/train/loop.py``.

  * ``PlateauTracker`` reproduces torch ``ReduceLROnPlateau`` (mode=min,
    relative threshold, patience in epochs, cooldown) and feeds the LR
    scale into the step as ``plateau_value``,
  * ``save_train_state``/``load_train_state`` snapshot the full
    ``TrainState`` (params, optimizer ``state_dict``, step) with
    ``torch.save``; ``fit(resume=True)`` continues from ``ckpt_dir/last``,
  * ``seq2gene_shard_batches`` and ``seq2reg_shard_batches`` feed the npz
    shards that ``data/train_pipeline.TrainingShardWriter`` and
    ``Seq2RegShardWriter`` write; ``make_seq2gene_eval_loss`` and
    ``make_seq2reg_eval_loss`` give ``fit`` its validation loss.

On a mesh (``parallel/mesh.py``): ``fit(mesh=...)`` places the state with
``shard_train_state`` (heads and FFN columns over the model axis, donors
over the data axis) and every batch with ``data_shard_fn``;
``fit(shard_fn=...)`` takes a placement as it is (e.g.
``donor_dp_shard_fn`` with ``donor_dp_train_step``). Checkpoints and
``history.json`` hold the whole state, written by rank 0 after every rank
has joined in gathering it, then a barrier; ``resume`` reads them on every
rank. The eval losses take the same ``shard_fn``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from variantformer_tpu_torch.device import resolve_device
from variantformer_tpu_torch.models.params import leaves
from variantformer_tpu_torch.parallel import comm
from variantformer_tpu_torch.train.steps import TrainState, seq2gene_loss_sum, seq2reg_loss_fn
from variantformer_tpu_torch.utils.profiling import span

log = logging.getLogger(__name__)


class PlateauTracker:
    """torch ``ReduceLROnPlateau`` (mode="min", threshold_mode="rel"),
    tracked at epoch cadence. ``update(val_loss)`` returns the LR scale to
    use for the next epoch's steps; ``min_scale`` is min_lr as a fraction of
    the base LR."""

    def __init__(self, patience: int = 2, factor: float = 0.5, threshold: float = 1e-4,
                 cooldown: int = 0, min_scale: float = 1e-3):
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.cooldown = cooldown
        self.min_scale = min_scale
        self.best = float("inf")
        self.num_bad = 0
        self.cooldown_left = 0
        self.scale = 1.0

    def update(self, value: float) -> float:
        # torch's order: best/bad first, then the cooldown counter (which
        # suppresses bad counts while active), then the reduction check.
        if value < self.best * (1.0 - self.threshold):
            self.best = value
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.scale = max(self.scale * self.factor, self.min_scale)
            self.cooldown_left = self.cooldown
            self.num_bad = 0
        return self.scale

    def state_dict(self) -> dict:
        return {"best": self.best, "num_bad": self.num_bad,
                "cooldown_left": self.cooldown_left, "scale": self.scale}

    def load_state_dict(self, d: dict) -> None:
        self.best = d["best"]
        self.num_bad = d["num_bad"]
        self.cooldown_left = d["cooldown_left"]
        self.scale = d["scale"]


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def save_train_state(path: str | Path, state: TrainState) -> None:
    """Snapshot the full TrainState into ``path/state.pt``. Under
    ``torch.distributed`` every rank must call it: the whole state is
    gathered from a mesh's slices (``parallel/mesh.whole_train_state``),
    rank 0 writes it, and a barrier follows."""
    params, opt_state = state.params, state.opt.state_dict()
    if state.mesh is not None:
        from variantformer_tpu_torch.parallel.mesh import whole_train_state

        params, opt_state = whole_train_state(state, opt_state)
    if _writer():
        path = Path(path).absolute()
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / "state.pt.tmp"
        torch.save({"params": params, "opt": opt_state, "step": state.step}, tmp)
        tmp.replace(path / "state.pt")
    _barrier()


def load_train_state(path: str | Path, template: TrainState) -> TrainState:
    """Restore a snapshot into ``template`` (a TrainState from the same
    config and optimizer): its parameters are overwritten in place on their
    own device, and the optimizer state is loaded into its optimizer."""
    saved = torch.load(Path(path).absolute() / "state.pt", map_location="cpu",
                       weights_only=True)
    with torch.no_grad():
        for dst, src in zip(leaves(template.params), leaves(saved["params"]), strict=True):
            dst.copy_(src)
    template.opt.load_state_dict(saved["opt"])
    return template._replace(step=int(saved["step"]))


class FitResult(NamedTuple):
    state: TrainState
    history: list[dict]      # per-epoch {epoch, train_loss, val_loss, lr_scale}
    best_val: float
    best_epoch: int


def fit(
    state: TrainState,
    step_fn: Callable,
    train_batches: Callable[[int], Iterable[tuple]],
    *,
    eval_loss: Callable[[TrainState], float] | None = None,
    epochs: int = 1,
    ckpt_dir: str | Path | None = None,
    plateau: PlateauTracker | None = None,
    early_stop_patience: int | None = None,
    resume: bool = False,
    mesh=None,
    shard_fn=None,
) -> FitResult:
    """Run the fit loop (the JAX package's semantics).

    ``step_fn`` is ``(state, *batch, plateau_value) -> (state, loss)`` from
    ``train/steps.py``; ``train_batches(epoch)`` yields step-argument tuples;
    ``eval_loss(state)`` is the per-epoch validation loss that drives the
    plateau scale, the best checkpoint and early stopping (without it the
    epoch's mean train loss is monitored). With ``ckpt_dir``, ``last/`` and
    ``history.json`` are written every epoch and ``best/`` whenever the
    monitored loss improves; ``resume`` restores ``last/`` and the history
    and continues. ``epochs`` counts the epochs already done when resuming.

    ``mesh``: train on a ``parallel/mesh.Mesh`` in one flag (the state is
    placed by ``shard_train_state`` after any resume, the batches by
    ``data_shard_fn`` unless ``shard_fn`` is given; build the step with
    ``impl="xla"`` when the mesh has a model axis). ``shard_fn``: the
    per-batch placement, the state used as given (e.g.
    ``donor_dp_shard_fn`` with ``donor_dp_train_step`` and a
    ``replicate_train_state`` state).

    Under a profiler, taking each batch from ``train_batches`` (and placing
    it) is the span ``fit.next_batch``."""
    plateau = plateau or PlateauTracker()
    history: list[dict] = []
    best_val = float("inf")
    best_epoch = -1
    start_epoch = 0
    if ckpt_dir is not None:
        ckpt_dir = Path(ckpt_dir).absolute()
    if resume:
        if ckpt_dir is None:
            raise ValueError("resume=True requires ckpt_dir")
        hist_file = ckpt_dir / "history.json"
        if hist_file.exists():
            saved = json.loads(hist_file.read_text())
            history = saved["epochs"]
            best_val = saved["best_val"]
            best_epoch = saved["best_epoch"]
            plateau.load_state_dict(saved["plateau"])
            start_epoch = len(history)
            state = load_train_state(ckpt_dir / "last", state)
            log.info("resumed at epoch %d (best_val=%.4g)", start_epoch, best_val)

    if mesh is not None:
        from variantformer_tpu_torch.parallel.mesh import data_shard_fn, shard_train_state

        state = shard_train_state(state, mesh)
        if shard_fn is None:
            shard_fn = data_shard_fn(mesh)

    def _save() -> None:
        if ckpt_dir is None:
            return
        save_train_state(ckpt_dir / "last", state)
        if _writer():
            (ckpt_dir / "history.json").write_text(json.dumps({
                "epochs": history, "best_val": best_val, "best_epoch": best_epoch,
                "plateau": plateau.state_dict(),
            }, indent=2))
        _barrier()

    for epoch in range(start_epoch, epochs):
        # checked at the top so a resumed run that already early-stopped
        # does not train (and checkpoint) one extra epoch
        if (early_stop_patience is not None and best_epoch >= 0
                and len(history) - 1 - best_epoch >= early_stop_patience):
            log.info("early stop at epoch %d (best epoch %d)", len(history) - 1, best_epoch)
            break
        lr_scale = plateau.scale
        losses = []
        batches = iter(train_batches(epoch))
        while True:
            with span("fit.next_batch"):  # the feed: loads, packing, copies to the card
                batch = next(batches, None)
                if batch is not None and shard_fn is not None:
                    batch = shard_fn(tuple(batch))
            if batch is None:
                break
            state, loss = step_fn(state, *batch, lr_scale)
            losses.append(loss)
        if not losses:
            raise ValueError(f"train_batches({epoch}) yielded no batches")
        train_loss = float(np.mean([float(v) for v in losses]))
        val = float(eval_loss(state)) if eval_loss is not None else train_loss
        plateau.update(val)
        history.append({"epoch": epoch, "train_loss": train_loss, "val_loss": val,
                        "lr_scale": lr_scale})
        improved = val < best_val
        if improved:
            best_val, best_epoch = val, epoch
        _save()
        if improved and ckpt_dir is not None:
            save_train_state(ckpt_dir / "best", state)
        log.info("epoch %d: train %.4g val %.4g lr_scale %.3g%s", epoch, train_loss, val,
                 lr_scale, " *best*" if improved else "")
    return FitResult(state, history, best_val, best_epoch)


def seq2gene_shard_batches(
    shard_dir: str | Path,
    tissue_ids: list[int],
    *,
    batch_size: int = 1,
    shuffle: bool = True,
    bucket_step: int = 64,
    gene_cap: int | None = 200,
    process_split: tuple[int, int] | None = None,
    device: str | torch.device = "cuda",
) -> Callable[[int], Iterable[tuple]]:
    """Batch iterator over ``TrainingShardWriter`` output for the seq2gene
    train step: yields ``(Seq2GeneBatch, targets, target_mask)`` as tensors
    on ``device`` (the card unless the caller asks for the CPU). Every donor
    is scored against the same ``tissue_ids``; each shard's sparse (tissue,
    expression) labels fill ``targets`` where present and the mask
    elsewhere. A short final batch repeats its last sample with a zeroed
    mask. Shard order reshuffles every epoch (seeded by the epoch).

    ``process_split=(process_index, process_count)`` takes this process's
    round-robin share of each epoch's shard order, the multi-process data
    parallelism of ``scripts/launch_train.py``: every process derives the
    same permutation (the epoch seeds it), truncated to a multiple of
    ``process_count`` so that every process steps the same number of times
    (one extra step would wait on a collective the others never join)."""
    from variantformer_tpu_torch.data.pipeline import GeneSample, pack_samples
    from variantformer_tpu_torch.models.seq2gene import Seq2GeneBatch

    device = resolve_device(device)
    shard_dir = Path(shard_dir)
    files = sorted(shard_dir.glob("*__*.npz"))
    if not files:
        raise FileNotFoundError(f"no seq2gene shards under {shard_dir}")
    if process_split is not None:
        pc = process_split[1]
        if len(files) < pc:
            raise ValueError(f"{len(files)} shard(s) under {shard_dir} cannot feed "
                             f"{pc} processes one batch each")
        if len(files) % pc and not shuffle:
            log.warning("multi-host split drops the %d trailing shard(s) of %d "
                        "every epoch (shuffle=False)", len(files) % pc, len(files))
    tissue_arr = np.asarray(tissue_ids, np.int32)
    pos = {int(t): i for i, t in enumerate(tissue_arr)}

    def _load(path: Path):
        z = np.load(path)
        sample = GeneSample(
            gene_id=path.stem.split("__")[0],
            strand="+" if int(z["strand"]) == 0 else "-",
            cre_tokens=z["cre_tokens"].astype(np.int32),
            cre_tok_len=z["cre_tok_len"].astype(np.int32),
            cre_labels=z["cre_labels"].astype(np.int32),
            gene_tokens=z["gene_tokens"].astype(np.int32),
            gene_tok_len=z["gene_tok_len"].astype(np.int32),
        )
        tgt = np.zeros((len(tissue_arr),), np.float32)
        msk = np.zeros((len(tissue_arr),), bool)
        for tid, val in zip(z["tissue_ids"], z["targets"]):
            i = pos.get(int(tid))
            if i is not None:
                tgt[i] = val
                msk[i] = True
        return sample, tgt, msk

    def batches(epoch: int):
        order = np.arange(len(files))
        if shuffle:
            np.random.default_rng(epoch).shuffle(order)
        if process_split is not None:
            pi, pc = process_split
            order = order[pi:len(order) - len(order) % pc:pc]
        for lo in range(0, len(order), batch_size):
            loaded = [_load(files[i]) for i in order[lo:lo + batch_size]]
            pad = batch_size - len(loaded)
            if pad:
                sample, tgt, _ = loaded[-1]
                loaded += [(sample, tgt, np.zeros_like(tgt, bool))] * pad
            batch = pack_samples([s for s, _, _ in loaded], tissue_ids=list(tissue_arr),
                                 bucket_step=bucket_step, gene_cap=gene_cap)
            yield (
                Seq2GeneBatch(*(None if v is None else torch.from_numpy(v).to(device)
                                for v in batch)),
                torch.from_numpy(np.stack([t for _, t, _ in loaded])).to(device),
                torch.from_numpy(np.stack([m for _, _, m in loaded])).to(device),
            )

    return batches


def _mean_eval_loss(one, batches_fn, shard_fn) -> Callable[[TrainState], float]:
    """state -> the mean over ``batches_fn(0)`` of ``one(params, *batch)``,
    a (sum, count) pair or a sum. With ``shard_fn`` (the one ``fit`` takes)
    each batch is this rank's shard: the pair is summed over the shard's
    group, the layered route split over its model group."""

    def eval_loss(state: TrainState) -> float:
        vals = []
        with torch.no_grad():
            for b in batches_fn(0):
                if shard_fn is None:
                    out = one(state.params, *b)
                else:
                    with comm.tensor_parallel(shard_fn.tp):
                        out = one(state.params, *shard_fn(tuple(b)))
                s, c = out if isinstance(out, tuple) else (out, None)
                pair = torch.stack([s.float()] + ([] if c is None else [c.float()]))
                if shard_fn is not None:
                    comm.all_reduce(pair, shard_fn.group)
                vals.append(float(pair[0] if c is None else pair[0] / pair[1].clamp(min=1)))
        if not vals:
            raise ValueError("eval batches yielded nothing")
        return float(np.mean(vals))

    return eval_loss


def make_seq2gene_eval_loss(cfg, batches_fn, shard_fn=None,
                            impl: str = "fused2") -> Callable[[TrainState], float]:
    """state -> the mean loss over one pass of ``batches_fn(0)``, without
    gradients (the stacks take their inference chains on the ``impl``
    routes). On a mesh pass the ``shard_fn`` given to ``fit``."""
    return _mean_eval_loss(
        lambda params, batch, targets, mask: seq2gene_loss_sum(
            params, batch, targets, mask, cfg, impl=impl),
        batches_fn, shard_fn)


def seq2reg_shard_batches(
    shard_dir: str | Path,
    tissue_vocab: dict[str, int],
    *,
    split: str = "train",
    label_key: str = "tissue_class",
    shuffle: bool = True,
    device: str | torch.device = "cuda",
) -> Callable[[int], Iterable[tuple]]:
    """Batch iterator over ``data/train_pipeline.Seq2RegShardWriter`` output
    for the seq2reg train step: each npz shard of ``shard_dir/split`` is one
    step's ``(tokens, tok_len, context, tissue_ids, labels)``, int32 tensors
    on ``device`` (the card unless the caller asks for the CPU). ``context``
    is each window's reference cCRE class, ``labels`` the ``label_key``
    class to predict. Shard order reshuffles every epoch (seeded by the
    epoch).

    A shard without a ``tissue`` key (written before the writer stored one)
    takes its tissue from its ``{subject}_{tissue}_{chrom}_chunk_{n}`` name,
    and only when exactly one vocabulary tissue matches the end of the
    middle part: subject and tissue names may hold underscores, so any other
    case raises ``ValueError`` rather than train against a guessed tissue."""
    device = resolve_device(device)
    shard_dir = Path(shard_dir)
    files = sorted((shard_dir / split).glob("*.npz"))
    if not files:
        raise FileNotFoundError(f"no shards under {shard_dir / split}")

    def tissue_of(path: Path, z) -> str:
        if "tissue" in z.files:
            return str(z["tissue"])
        middle = "_".join(path.stem.split("_")[:-3])
        hits = [t for t in tissue_vocab if middle == t or middle.endswith("_" + t)]
        if len(hits) != 1:
            raise ValueError(
                f"cannot {'recover a' if not hits else 'unambiguously pick the'} "
                f"vocab tissue from legacy shard name {path.name!r} (matches: "
                f"{sorted(hits)}); re-write the shards with the current "
                "Seq2RegShardWriter, which embeds a 'tissue' key"
            )
        return hits[0]

    def batches(epoch: int):
        order = np.arange(len(files))
        if shuffle:
            np.random.default_rng(epoch).shuffle(order)
        for i in order:
            z = np.load(files[i])
            tid = tissue_vocab[tissue_of(files[i], z)]
            n = z["tokens"].shape[0]
            yield tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
                for a in (z["tokens"], z["tok_len"], z["ref_class"], np.full((n,), tid),
                          z[label_key])
            )

    return batches


def make_seq2reg_eval_loss(cfg, batches_fn, shard_fn=None) -> Callable[[TrainState], float]:
    """state -> the mean seq2reg loss (the step's default cross-entropy) over
    one pass of ``batches_fn(0)``, without gradients (use
    ``seq2reg_shard_batches(..., split="test", shuffle=False)``). On a mesh
    pass the ``shard_fn`` given to ``fit``."""

    def one(params, *b):
        device = params["token_embedding"].device
        return seq2reg_loss_fn(params, *(torch.as_tensor(a).to(device) for a in b), cfg)[0]

    return _mean_eval_loss(one, batches_fn, shard_fn)

"""Epoch-level training driver: the port of ``variantformer_tpu/train/loop.py``.

  * ``PlateauTracker`` reproduces torch ``ReduceLROnPlateau`` (mode=min,
    relative threshold, patience in epochs, cooldown) and feeds the LR
    scale into the step as ``plateau_value``,
  * ``save_train_state``/``load_train_state`` snapshot the full
    ``TrainState`` (params, optimizer ``state_dict``, step) with
    ``torch.save``; ``fit(resume=True)`` continues from ``ckpt_dir/last``,
  * ``seq2gene_shard_batches`` feeds the npz shards that
    ``data/train_pipeline.TrainingShardWriter`` writes.

Single device only: ``fit``'s ``mesh``/``shard_fn`` are not ported yet.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch

from variantformer_tpu_torch.device import resolve_device
from variantformer_tpu_torch.models.params import leaves
from variantformer_tpu_torch.train.steps import TrainState, seq2gene_loss_fn

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


def save_train_state(path: str | Path, state: TrainState) -> None:
    """Snapshot the full TrainState into ``path/state.pt``."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / "state.pt.tmp"
    torch.save({"params": state.params, "opt": state.opt.state_dict(), "step": state.step}, tmp)
    tmp.replace(path / "state.pt")


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
    return TrainState(template.params, template.opt, int(saved["step"]))


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
    and continues. ``epochs`` counts the epochs already done when resuming."""
    if mesh is not None or shard_fn is not None:
        raise NotImplementedError("multi-device fit (mesh, shard_fn) is not ported yet")
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

    def _save() -> None:
        if ckpt_dir is None:
            return
        save_train_state(ckpt_dir / "last", state)
        (ckpt_dir / "history.json").write_text(json.dumps({
            "epochs": history, "best_val": best_val, "best_epoch": best_epoch,
            "plateau": plateau.state_dict(),
        }, indent=2))

    for epoch in range(start_epoch, epochs):
        # checked at the top so a resumed run that already early-stopped
        # does not train (and checkpoint) one extra epoch
        if (early_stop_patience is not None and best_epoch >= 0
                and len(history) - 1 - best_epoch >= early_stop_patience):
            log.info("early stop at epoch %d (best epoch %d)", len(history) - 1, best_epoch)
            break
        lr_scale = plateau.scale
        losses = []
        for batch in train_batches(epoch):
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
    device: str | torch.device = "cuda",
) -> Callable[[int], Iterable[tuple]]:
    """Batch iterator over ``TrainingShardWriter`` output for the seq2gene
    train step: yields ``(Seq2GeneBatch, targets, target_mask)`` as tensors
    on ``device`` (the card unless the caller asks for the CPU). Every donor
    is scored against the same ``tissue_ids``; each shard's sparse (tissue,
    expression) labels fill ``targets`` where present and the mask
    elsewhere. A short final batch repeats its last sample with a zeroed
    mask. Shard order reshuffles every epoch (seeded by the epoch)."""
    from variantformer_tpu_torch.data.pipeline import GeneSample, pack_samples
    from variantformer_tpu_torch.models.seq2gene import Seq2GeneBatch

    device = resolve_device(device)
    shard_dir = Path(shard_dir)
    files = sorted(shard_dir.glob("*__*.npz"))
    if not files:
        raise FileNotFoundError(f"no seq2gene shards under {shard_dir}")
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


def make_seq2gene_eval_loss(cfg, batches_fn) -> Callable[[TrainState], float]:
    """state -> the mean loss over one pass of ``batches_fn(0)``, without
    gradients (both stacks take their inference chains)."""

    def eval_loss(state: TrainState) -> float:
        vals = []
        with torch.no_grad():
            for batch, targets, mask in batches_fn(0):
                vals.append(float(seq2gene_loss_fn(state.params, batch, targets, mask, cfg)))
        if not vals:
            raise ValueError("eval batches yielded nothing")
        return float(np.mean(vals))

    return eval_loss

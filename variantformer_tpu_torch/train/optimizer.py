"""Optimizer construction: Adam/AdamW with the reference's decay/no-decay
parameter split, a hard freeze of the tokenizers, plateau LR scaling (per
epoch, or per step as ``optax.contrib.reduce_on_plateau``) and gradient
accumulation (``optax.MultiSteps``).

The port of ``variantformer_tpu/train/optimizer.py`` on ``torch.optim``.
Biases, LayerNorm and embedding parameters are exempt from weight decay:
every leaf named ``b``, ``bias``, ``scale``, ``ln_scale``, ``ln_bias``,
``b1``..``b3``, and the embedding tables (token/context embeddings,
registry). The CRE tokenizer, and the gene tokenizer unless
``train_gene_tokenizer``, are frozen: ``requires_grad_(False)`` and in no
parameter group, so autograd never computes their gradients.

The update follows optax's choice, not torch's names: any non-zero
``weight_decay`` (or ``optimizer="adamw"``) takes the decoupled-decay chain
(``torch.optim.AdamW``), never the L2-coupled ``Adam(weight_decay=...)``;
betas (0.9, 0.999) and eps 1e-8 as optax's defaults.

``apply_update(opt, value)`` is the port of optax's ``tx.update(grads,
value=value)`` + ``apply_updates``: ``value`` is the LR scale under
``plateau="epoch"`` and the monitored loss under ``plateau="step"``.
"""

from __future__ import annotations

import numpy as np
import torch

from variantformer_tpu_torch.models.params import leaves

_NO_DECAY_LEAVES = {"b", "bias", "scale", "ln_scale", "ln_bias", "b1", "b2", "b3"}
_EMBEDDING_LEAVES = {"token_embedding", "context_embedding", "registry"}


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    return fn(path, tree)


def decay_mask(params: dict) -> dict:
    """True where weight decay applies."""
    return _map_with_path(
        lambda path, _: bool(path) and path[-1] not in _NO_DECAY_LEAVES | _EMBEDDING_LEAVES,
        params,
    )


def trainable_mask(params: dict, train_gene_tokenizer: bool = True) -> dict:
    """False for the frozen subtrees (the CRE tokenizer; the gene tokenizer
    unless ``train_gene_tokenizer``)."""

    def trainable(path, _):
        if path and path[0] == "cre_tokenizer":
            return False
        return not (path and path[0] == "gene_tokenizer" and not train_gene_tokenizer)

    return _map_with_path(trainable, params)


def make_optimizer(
    params: dict,
    learning_rate: float = 1e-4,
    weight_decay: float = 0.0,
    optimizer: str = "adam",
    train_gene_tokenizer: bool = True,
    plateau_patience: int = 2,
    plateau_factor: float = 0.5,
    min_scale: float = 1e-3,
    plateau: str = "epoch",
    accumulate_steps: int = 1,
):
    """Adam or AdamW over two parameter groups (decay, no-decay) of the
    trainable leaves of ``params``, on whatever device they live; frozen
    leaves get ``requires_grad_(False)``.

    Each group keeps its ``base_lr``; ``set_lr_scale`` sets ``lr = base_lr *
    value`` for the per-epoch plateau scale (``plateau="epoch"``, what
    ``train.loop.fit`` feeds). For Adam and AdamW that equals optax's
    ``update * value``.

    ``plateau="step"`` monitors the value fed to each update with
    ``ReduceOnPlateau`` (optax ``reduce_on_plateau``: ``plateau_patience``,
    ``plateau_factor``, ``min_scale``, ``accumulation_size=accumulate_steps``);
    do not combine it with ``fit``, which feeds a scale near 1.0.
    ``accumulate_steps > 1`` averages the trainable leaves' gradients over
    that many calls of ``apply_update`` and updates on the last (optax
    ``MultiSteps``); the plateau ticks per real update on the mean of the
    window's values. Either returns a ``ScheduledOptimizer`` around the
    Adam/AdamW; with neither the Adam/AdamW itself is returned."""
    if optimizer not in ("adam", "adamw"):
        raise ValueError(f"optimizer must be 'adam' or 'adamw', got {optimizer!r}")
    if plateau not in ("epoch", "step"):
        raise ValueError(f"plateau must be 'epoch' or 'step', got {plateau!r}")
    if accumulate_steps < 1:
        raise ValueError(f"accumulate_steps must be >= 1, got {accumulate_steps}")
    trainable = leaves(trainable_mask(params, train_gene_tokenizer))
    decay = leaves(decay_mask(params))
    groups: tuple[list, list] = ([], [])
    for t, train, dec in zip(leaves(params), trainable, decay):
        t.requires_grad_(train)
        if train:
            groups[0 if dec else 1].append(t)
    decoupled = optimizer == "adamw" or bool(weight_decay)
    cls = torch.optim.AdamW if decoupled else torch.optim.Adam
    opt = cls(
        [
            {"params": groups[0], "weight_decay": weight_decay if decoupled else 0.0,
             "base_lr": learning_rate},
            {"params": groups[1], "weight_decay": 0.0, "base_lr": learning_rate},
        ],
        lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
    )
    if plateau == "epoch" and accumulate_steps == 1:
        return opt
    monitor = None
    if plateau == "step":
        monitor = ReduceOnPlateau(factor=plateau_factor, patience=plateau_patience,
                                  min_scale=min_scale, accumulation_size=accumulate_steps)
    return ScheduledOptimizer(opt, monitor, accumulate_steps)


def set_lr_scale(opt: torch.optim.Optimizer, value: float) -> None:
    """The per-epoch plateau scale: every group's ``lr = base_lr * value``
    (``base_lr`` is the learning rate the optimizer was built with)."""
    for group in opt.param_groups:
        group["lr"] = group["base_lr"] * float(value)


class ReduceOnPlateau:
    """``optax.contrib.reduce_on_plateau``'s state machine, in float32 as
    optax keeps it, at the settings the JAX package's chain uses (optax's
    ``rtol=1e-4``, ``atol=0``, no cooldown). ``update(value)`` averages the
    values it is fed; every ``accumulation_size`` values it compares the
    mean with the best so far (improved when below ``(1 - 1e-4) * best``),
    counts the calls without improvement, and at ``patience`` of them
    multiplies the scale by ``factor`` (never below ``min_scale``). Returns
    the scale after this call."""

    RTOL = 1e-4

    def __init__(self, factor: float = 0.1, patience: int = 10, accumulation_size: int = 1,
                 min_scale: float = 0.0):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"factor must be in (0, 1), got {factor}")
        self.factor, self.patience = factor, patience
        self.accumulation_size, self.min_scale = accumulation_size, min_scale
        self.scale = np.float32(1.0)
        self.best = np.float32(np.inf)
        self.plateau_count = 0
        self.count = 0
        self.avg = np.float32(0.0)

    def update(self, value: float) -> float:
        f32 = np.float32
        new_count = self.count + 1
        self.avg = f32((f32(self.count) * self.avg + f32(value)) / f32(new_count))
        self.count = new_count
        if new_count == self.accumulation_size:
            improved = bool(self.avg < f32(1 - self.RTOL) * self.best)
            if improved:
                self.best = self.avg
            count = 0 if improved else self.plateau_count + 1
            reduce = count == self.patience
            self.plateau_count = 0 if reduce else count
            scale = f32(self.scale * f32(self.factor)) if reduce else self.scale
            self.scale = max(scale, f32(self.min_scale))
            self.count = 0
            self.avg = f32(0.0)
        return float(self.scale)

    def state_dict(self) -> dict:
        return {"scale": float(self.scale), "best": float(self.best),
                "plateau_count": self.plateau_count, "count": self.count,
                "avg": float(self.avg)}

    def load_state_dict(self, d: dict) -> None:
        self.scale, self.best, self.avg = (np.float32(d[k]) for k in ("scale", "best", "avg"))
        self.plateau_count = d["plateau_count"]
        self.count = d["count"]


class ScheduledOptimizer:
    """An Adam/AdamW with the per-step plateau scale and gradient
    accumulation of the JAX package's optax chain around it.

    ``step(value)`` is one optax update: ``value`` goes to the plateau
    monitor when there is one (the monitored loss), else it is the LR scale.
    With ``every_k > 1`` the trainable leaves' gradients (a missing one
    counts as zero) are averaged in float32 as optax's ``MultiSteps`` does
    (``acc += (grad - acc) / (i + 1)`` at micro-step i), and only the k-th
    call updates the parameters and the Adam moments."""

    def __init__(self, inner: torch.optim.Optimizer, monitor: ReduceOnPlateau | None,
                 every_k: int = 1):
        self.inner = inner
        self.monitor = monitor
        self.every_k = every_k
        self.mini_step = 0
        self._params = [t for g in inner.param_groups for t in g["params"]]
        self._acc: list[torch.Tensor | None] = [None] * len(self._params)

    @property
    def param_groups(self) -> list[dict]:
        return self.inner.param_groups

    @property
    def plateau(self) -> str:
        return "epoch" if self.monitor is None else "step"

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, value: float = 1.0) -> bool:
        """One update; returns whether the parameters moved."""
        scale = value if self.monitor is None else self.monitor.update(value)
        if self.every_k > 1:
            n = self.mini_step
            for i, t in enumerate(self._params):
                acc = self._acc[i]
                if acc is None:
                    acc = self._acc[i] = torch.zeros_like(t, dtype=torch.float32)
                grad = torch.zeros_like(acc) if t.grad is None else t.grad.float()
                acc.add_((grad - acc) / (n + 1))
            self.mini_step = (n + 1) % self.every_k
            if self.mini_step:
                return False
            for t, acc in zip(self._params, self._acc):
                t.grad = acc.to(t.dtype)
            self._acc = [None] * len(self._params)
        set_lr_scale(self.inner, scale)
        self.inner.step()
        return True

    def state_dict(self) -> dict:
        return {
            "inner": self.inner.state_dict(), "mini_step": self.mini_step,
            "monitor": None if self.monitor is None else self.monitor.state_dict(),
            "acc": [None if a is None else a.clone() for a in self._acc],
        }

    def load_state_dict(self, d: dict) -> None:
        self.inner.load_state_dict(d["inner"])
        self.mini_step = d["mini_step"]
        if self.monitor is not None:
            self.monitor.load_state_dict(d["monitor"])
        self._acc = [None if a is None else a.to(t.device)
                     for a, t in zip(d["acc"], self._params, strict=True)]


def apply_update(opt, value: float) -> None:
    """One optimizer update from the gradients on the parameters: optax's
    ``tx.update(grads, value=value)`` then ``apply_updates``. ``value`` is
    the LR scale for an optimizer built with ``plateau="epoch"`` and the
    monitored loss for ``plateau="step"``. A trainable leaf the loss does
    not reach gets a zero gradient, as under ``jax.grad``: Adam's moments
    decay and AdamW's weight decay applies, where ``torch.optim`` would
    skip the leaf."""
    with torch.no_grad():
        for group in opt.param_groups:
            for t in group["params"]:
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
    if isinstance(opt, torch.optim.Optimizer):
        set_lr_scale(opt, value)
        opt.step()
        return
    opt.step(value)  # ScheduledOptimizer, parallel/mesh.Zero1Optimizer


def plateau_mode(opt) -> str:
    """The ``plateau`` an optimizer from ``make_optimizer`` was built with."""
    return "epoch" if isinstance(opt, torch.optim.Optimizer) else opt.plateau


def base_optimizer(opt) -> torch.optim.Optimizer:
    """The ``torch.optim`` Adam/AdamW inside ``make_optimizer``'s optimizer
    (or inside the ZeRO-1 optimizer of ``parallel/mesh.Zero1Optimizer``)."""
    while not isinstance(opt, torch.optim.Optimizer):
        opt = opt.inner if isinstance(opt, ScheduledOptimizer) else opt.opt
    return opt

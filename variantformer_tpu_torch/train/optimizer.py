"""Optimizer construction: Adam/AdamW with the reference's decay/no-decay
parameter split, a hard freeze of the tokenizers, and the per-epoch LR
scale.

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
"""

from __future__ import annotations

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
    plateau: str = "epoch",
    accumulate_steps: int = 1,
) -> torch.optim.Optimizer:
    """Adam or AdamW over two parameter groups (decay, no-decay) of the
    trainable leaves of ``params``, on whatever device they live; frozen
    leaves get ``requires_grad_(False)``.

    Each group keeps its ``base_lr``; ``set_lr_scale`` sets ``lr = base_lr *
    value`` for the per-epoch plateau scale (``plateau="epoch"``, what
    ``train.loop.fit`` feeds). For Adam and AdamW that equals optax's
    ``update * value``. ``plateau="step"`` (optax ``reduce_on_plateau``) and
    ``accumulate_steps > 1`` (``optax.MultiSteps``) are not ported yet."""
    if optimizer not in ("adam", "adamw"):
        raise ValueError(f"optimizer must be 'adam' or 'adamw', got {optimizer!r}")
    if plateau != "epoch":
        raise NotImplementedError("plateau='step' (reduce_on_plateau) is not ported yet")
    if accumulate_steps != 1:
        raise NotImplementedError("gradient accumulation (accumulate_steps > 1) is not ported yet")
    trainable = leaves(trainable_mask(params, train_gene_tokenizer))
    decay = leaves(decay_mask(params))
    groups: tuple[list, list] = ([], [])
    for t, train, dec in zip(leaves(params), trainable, decay):
        t.requires_grad_(train)
        if train:
            groups[0 if dec else 1].append(t)
    decoupled = optimizer == "adamw" or bool(weight_decay)
    cls = torch.optim.AdamW if decoupled else torch.optim.Adam
    return cls(
        [
            {"params": groups[0], "weight_decay": weight_decay if decoupled else 0.0,
             "base_lr": learning_rate},
            {"params": groups[1], "weight_decay": 0.0, "base_lr": learning_rate},
        ],
        lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
    )


def set_lr_scale(opt: torch.optim.Optimizer, value: float) -> None:
    """The per-epoch plateau scale: every group's ``lr = base_lr * value``
    (``base_lr`` is the learning rate the optimizer was built with)."""
    for group in opt.param_groups:
        group["lr"] = group["base_lr"] * float(value)

"""The training steps of both model stages: the port of
``variantformer_tpu/train/steps.py``.

  * seq2gene: Poisson NLL (or MSE) on per-(donor, tissue) expression,
    masked per (donor, tissue). The gradients cross the whole-stack autograd
    Functions where the config routes the stacks to them (the window
    encoder's and the gene stack's recompute backwards, on the card chains
    of hand-written CUDA kernels); the plain loops, the CRE stack, maps,
    registry and heads get theirs from autograd.
  * seq2reg: per-tissue cCRE classification of windows (cross-entropy,
    class-weighted cross-entropy or focal loss), optionally plus the dual
    contrastive loss over the window embeddings. It runs at float32 through
    the plain layer loop (``encode_windows``), as the JAX step runs on XLA:
    it launches no hand-written kernel (they are bf16).

Each step updates the parameters in place through the optimizer from
``train.optimizer.make_optimizer`` (``apply_update``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from variantformer_tpu_torch.config import ModelConfig
from variantformer_tpu_torch.models.core import AttnSpec
from variantformer_tpu_torch.models.params import map_tree
from variantformer_tpu_torch.models.seq2gene import (
    Seq2GeneBatch,
    seq2gene_forward,
    seq2gene_forward_plain,
)
from variantformer_tpu_torch.models.seq2reg import classify_windows, encode_windows
from variantformer_tpu_torch.train import losses as L
from variantformer_tpu_torch.train.optimizer import apply_update, plateau_mode


class TrainState(NamedTuple):
    params: dict
    opt: torch.optim.Optimizer
    step: int


def seq2gene_loss_fn(
    params: dict, batch: Seq2GeneBatch, targets: torch.Tensor, target_mask: torch.Tensor,
    cfg: ModelConfig, stop_cre_grads: bool = False, stop_gene_grads: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """targets/target_mask: [D, T] expression labels and validity.

    ``stop_cre_grads``/``stop_gene_grads`` detach the tokenizer subtrees: a
    stack none of whose inputs needs a gradient takes the inference chain,
    so a frozen tokenizer costs no backward (and keeps no layer inputs).
    ``plain`` runs ``seq2gene_forward_plain`` instead: the yardstick the
    kernels' gradients are held against on the card."""
    if stop_cre_grads or stop_gene_grads:
        params = dict(params)
        for name, stop in (("cre_tokenizer", stop_cre_grads), ("gene_tokenizer", stop_gene_grads)):
            if stop:
                params[name] = map_tree(torch.Tensor.detach, params[name])
    forward = seq2gene_forward_plain if plain else seq2gene_forward
    pred = forward(params, batch, cfg).pred_expression
    if cfg.seq2gene.loss_fn == "poisson":
        elem = L.poisson_nll(pred, targets)
    else:
        elem = L.mse(pred, targets)
    elem = torch.where(target_mask, elem, 0.0)
    return elem.sum() / target_mask.sum().clamp(min=1)


def make_seq2gene_train_step(
    cfg: ModelConfig, opt: torch.optim.Optimizer, plateau: str = "epoch",
    freeze_tokenizers: bool = False, train_gene_tokenizer: bool = False,
):
    """Returns ``step(state, batch, targets, target_mask, plateau_value=None)
    -> (state, loss)``.

    The step updates ``state.params`` in place (the optimizer holds the
    same tensors), so the returned state shares them with the one passed
    in: keep a copy yourself if you need the old values, which at v4_pcg is
    a second copy of 1.2 B f32 weights. ``plateau`` must be the mode the
    optimizer was built with: it picks the value fed to the update when
    ``plateau_value`` is omitted, a neutral 1.0 LR scale for ``"epoch"``
    and the step's own loss for ``"step"``. ``freeze_tokenizers`` detaches
    the CRE tokenizer, and the gene tokenizer too unless
    ``train_gene_tokenizer`` (which must match the optimizer's flag). The
    batch is moved to the parameters' device when it lies elsewhere."""
    _check_plateau(opt, plateau)

    def step(state: TrainState, batch, targets, target_mask, plateau_value=None):
        device = state.params["registry"].device
        batch = Seq2GeneBatch(*(None if v is None else v.to(device) for v in batch))
        state.opt.zero_grad(set_to_none=True)
        loss = seq2gene_loss_fn(
            state.params, batch, targets.to(device), target_mask.to(device), cfg,
            stop_cre_grads=freeze_tokenizers,
            stop_gene_grads=freeze_tokenizers and not train_gene_tokenizer,
        )
        loss.backward()
        apply_update(state.opt, _update_value(plateau, plateau_value, loss))
        return TrainState(state.params, state.opt, state.step + 1), loss.detach()

    return step


def _check_plateau(opt, plateau: str) -> None:
    if plateau not in ("epoch", "step"):
        raise ValueError(f"plateau must be 'epoch' or 'step', got {plateau!r}")
    if plateau_mode(opt) != plateau:
        raise ValueError(f"the optimizer was built with plateau={plateau_mode(opt)!r}, "
                         f"the step with plateau={plateau!r}")


def _update_value(plateau: str, plateau_value, loss: torch.Tensor) -> float:
    """The value the update reads: ``plateau_value`` when given, else the
    step's loss under ``plateau="step"`` (a constant would read as a loss
    that never improves) and a neutral 1.0 LR scale under ``"epoch"``."""
    if plateau_value is not None:
        return float(plateau_value)
    return float(loss.detach()) if plateau == "step" else 1.0


def seq2reg_loss_fn(
    params: dict, tokens, tok_len, context, tissue_ids, labels, cfg: ModelConfig,
    loss_type: str = "cross_entropy", gamma: float = 0.0, class_weight=None,
    use_dual_loss: bool = False, logit_scale=None, dual_fraction=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Summed window-classification loss at float32: (loss, logits [N, C]).

    ``tokens`` [N, L], ``tok_len`` [N], ``context`` [N] (the reference cCRE
    class, read by the context flavour), ``tissue_ids`` [N] and ``labels``
    [N] (the tissue's class to predict). ``use_dual_loss`` adds the dual
    contrastive loss, weighted by ``dual_fraction`` or else by the ratio of
    the two losses clipped to [0.01, 100] (no gradient through it)."""
    wcfg = cfg.window_encoder
    spec = AttnSpec(wcfg.num_heads, wcfg.embedding_dim // wcfg.num_heads)
    emb = encode_windows(params, tokens, tok_len, context, wcfg, spec, torch.float32)
    logits = classify_windows(params, emb, tissue_ids)
    loss = L.get_classification_loss(loss_type, gamma, class_weight)(logits, labels).sum()
    if use_dual_loss:
        if logit_scale is not None:
            logit_scale = torch.as_tensor(logit_scale, dtype=torch.float32, device=emb.device)
        dual = L.dual_contrastive_loss(emb, logit_scale)
        if dual_fraction is not None:
            frac = dual_fraction
        else:
            with torch.no_grad():
                frac = (loss / dual).clamp(0.01, 100.0)
        loss = loss + frac * dual
    return loss, logits


def make_seq2reg_train_step(cfg: ModelConfig, opt, plateau: str = "epoch", **loss_kwargs):
    """Returns ``step(state, tokens, tok_len, context, tissue_ids, labels,
    plateau_value=None) -> (state, loss)`` for the window classifier
    (``init_window_encoder``'s tree); ``loss_kwargs`` go to
    ``seq2reg_loss_fn``. See ``make_seq2gene_train_step`` for the in-place
    update and the ``plateau`` contract. The inputs are moved to the
    parameters' device when they lie elsewhere."""
    _check_plateau(opt, plateau)

    def step(state: TrainState, tokens, tok_len, context, tissue_ids, labels,
             plateau_value=None):
        device = state.params["token_embedding"].device
        args = [torch.as_tensor(a).to(device) for a in (tokens, tok_len, context, tissue_ids,
                                                        labels)]
        state.opt.zero_grad(set_to_none=True)
        loss, _ = seq2reg_loss_fn(state.params, *args, cfg, **loss_kwargs)
        loss.backward()
        apply_update(state.opt, _update_value(plateau, plateau_value, loss))
        return TrainState(state.params, state.opt, state.step + 1), loss.detach()

    return step

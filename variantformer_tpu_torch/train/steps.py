"""The seq2gene training step: the port of ``variantformer_tpu/train/steps.py``.

Poisson NLL (or MSE) on per-(donor, tissue) expression, masked per (donor,
tissue). The gradients cross the two whole-stack autograd Functions (the
window encoder's and the gene stack's recompute backwards, on the card
chains of hand-written CUDA kernels); the CRE stack, maps, registry and
heads get theirs from autograd. The step updates the parameters in place
with a ``torch.optim`` optimizer from ``train.optimizer.make_optimizer``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from variantformer_tpu_torch.config import ModelConfig
from variantformer_tpu_torch.models.params import map_tree
from variantformer_tpu_torch.models.seq2gene import (
    Seq2GeneBatch,
    seq2gene_forward,
    seq2gene_forward_plain,
)
from variantformer_tpu_torch.train import losses as L
from variantformer_tpu_torch.train.optimizer import set_lr_scale


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
    a second copy of 1.2 B f32 weights. ``plateau_value`` is the per-epoch
    LR scale (1.0 when omitted); ``plateau`` must be ``"epoch"``, as the
    optimizer was built with. ``freeze_tokenizers`` detaches the CRE
    tokenizer, and the gene tokenizer too unless ``train_gene_tokenizer``
    (which must match the optimizer's flag). The batch is moved to the
    parameters' device when it lies elsewhere."""
    if plateau != "epoch":
        raise NotImplementedError("plateau='step' (reduce_on_plateau) is not ported yet")

    def step(state: TrainState, batch, targets, target_mask, plateau_value=None):
        device = state.params["registry"].device
        batch = Seq2GeneBatch(*(None if v is None else v.to(device) for v in batch))
        set_lr_scale(state.opt, 1.0 if plateau_value is None else plateau_value)
        state.opt.zero_grad(set_to_none=True)
        loss = seq2gene_loss_fn(
            state.params, batch, targets.to(device), target_mask.to(device), cfg,
            stop_cre_grads=freeze_tokenizers,
            stop_gene_grads=freeze_tokenizers and not train_gene_tokenizer,
        )
        loss.backward()
        state.opt.step()
        return TrainState(state.params, state.opt, state.step + 1), loss.detach()

    return step

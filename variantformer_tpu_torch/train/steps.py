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
``train.optimizer.make_optimizer`` (``apply_update``). A state placed by
``parallel/mesh.shard_train_state`` (``state.mesh`` set) trains on the
mesh: each rank takes the gradient of its shard's loss SUM on the layered
route with heads and FFN columns split over its model group, and one
all-reduce of the gradients, loss and count over its data group gives the
single-device mean-loss gradient (``parallel/comm.reduce_gradients``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from variantformer_tpu_torch.config import ModelConfig
from variantformer_tpu_torch.models.core import AttnSpec
from variantformer_tpu_torch.models.params import leaves, map_tree
from variantformer_tpu_torch.models.seq2gene import (
    Seq2GeneBatch,
    seq2gene_forward,
    seq2gene_forward_plain,
)
from variantformer_tpu_torch.models.seq2reg import classify_windows, encode_windows
from variantformer_tpu_torch.parallel import comm
from variantformer_tpu_torch.train import losses as L
from variantformer_tpu_torch.train.optimizer import apply_update, plateau_mode
from variantformer_tpu_torch.utils.profiling import span


class TrainState(NamedTuple):
    params: dict
    opt: torch.optim.Optimizer
    step: int
    mesh: Any = None  # parallel/mesh.Mesh after shard_train_state


def seq2gene_loss_sum(
    params: dict, batch: Seq2GeneBatch, targets: torch.Tensor, target_mask: torch.Tensor,
    cfg: ModelConfig, stop_cre_grads: bool = False, stop_gene_grads: bool = False,
    plain: bool = False, impl: str = "fused2",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(the masked loss SUM, the mask count) of ``seq2gene_loss_fn``."""
    if stop_cre_grads or stop_gene_grads:
        params = dict(params)
        for name, stop in (("cre_tokenizer", stop_cre_grads), ("gene_tokenizer", stop_gene_grads)):
            if stop:
                params[name] = map_tree(torch.Tensor.detach, params[name])
    if plain:
        pred = seq2gene_forward_plain(params, batch, cfg).pred_expression
    else:
        pred = seq2gene_forward(params, batch, cfg, impl=impl).pred_expression
    if cfg.seq2gene.loss_fn == "poisson":
        elem = L.poisson_nll(pred, targets)
    else:
        elem = L.mse(pred, targets)
    elem = torch.where(target_mask, elem, 0.0)
    return elem.sum(), target_mask.sum()


def seq2gene_loss_fn(
    params: dict, batch: Seq2GeneBatch, targets: torch.Tensor, target_mask: torch.Tensor,
    cfg: ModelConfig, stop_cre_grads: bool = False, stop_gene_grads: bool = False,
    plain: bool = False, impl: str = "fused2",
) -> torch.Tensor:
    """targets/target_mask: [D, T] expression labels and validity.

    ``stop_cre_grads``/``stop_gene_grads`` detach the tokenizer subtrees: a
    stack none of whose inputs needs a gradient takes the inference chain,
    so a frozen tokenizer costs no backward (and keeps no layer inputs).
    ``plain`` runs ``seq2gene_forward_plain`` instead: the yardstick the
    kernels' gradients are held against on the card. ``impl`` picks the
    forward's routes (``models/seq2gene.py``)."""
    s, c = seq2gene_loss_sum(params, batch, targets, target_mask, cfg, stop_cre_grads,
                             stop_gene_grads, plain, impl)
    return s / c.clamp(min=1)


def make_seq2gene_train_step(
    cfg: ModelConfig, opt: torch.optim.Optimizer, plateau: str = "epoch",
    freeze_tokenizers: bool = False, train_gene_tokenizer: bool = False,
    impl: str = "fused2",
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
    ``train_gene_tokenizer`` (which must match the optimizer's flag).
    ``impl`` picks the forward's routes; a state on a mesh with a model
    axis needs ``"xla"`` (the route tensor parallelism splits). The batch
    is moved to the parameters' device when it lies elsewhere.

    Under a profiler the step is the span ``train.step``, with the spans
    ``train.forward`` (the loss), ``train.backward`` and
    ``train.optimizer`` (the update); on a mesh the forward runs inside
    the backward's span (``_mesh_backward``)."""
    _check_plateau(opt, plateau)

    def loss_sum(state, batch, targets, target_mask):
        with span("train.forward"):
            return seq2gene_loss_sum(
                state.params, batch, targets, target_mask, cfg,
                stop_cre_grads=freeze_tokenizers,
                stop_gene_grads=freeze_tokenizers and not train_gene_tokenizer, impl=impl,
            )

    def step(state: TrainState, batch, targets, target_mask, plateau_value=None):
        with span("train.step"):
            device = state.params["registry"].device
            batch = Seq2GeneBatch(*(None if v is None else v.to(device) for v in batch))
            state.opt.zero_grad(set_to_none=True)
            args = (state, batch, targets.to(device), target_mask.to(device))
            if state.mesh is None:
                s, c = loss_sum(*args)
                loss = s / c.clamp(min=1)
                with span("train.backward"):
                    loss.backward()
            else:
                with span("train.backward"):
                    loss = _mesh_backward(state, lambda: loss_sum(*args))
            with span("train.optimizer"):
                apply_update(state.opt, _update_value(plateau, plateau_value, loss))
            return state._replace(step=state.step + 1), loss.detach()

    return step


def _mesh_backward(state: TrainState, loss_sum) -> torch.Tensor:
    """The gradient of ``loss_sum()`` (a (sum, count) pair, or a sum) on
    ``state.mesh``: forward and backward with the layered route split over
    the model group, then the gradients reduced over the data group."""
    mesh = state.mesh
    with comm.tensor_parallel(mesh.model_group):
        out = loss_sum()
        s, c = out if isinstance(out, tuple) else (out, None)
        s.backward()
    return comm.reduce_gradients(leaves(state.params), s, c, mesh.data_group)


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
        if state.mesh is None:
            loss, _ = seq2reg_loss_fn(state.params, *args, cfg, **loss_kwargs)
            loss.backward()
        else:
            if loss_kwargs.get("use_dual_loss"):
                raise ValueError("the dual contrastive loss spans the whole batch: "
                                 "it does not train on a mesh")
            loss = _mesh_backward(
                state, lambda: seq2reg_loss_fn(state.params, *args, cfg, **loss_kwargs)[0])
        apply_update(state.opt, _update_value(plateau, plateau_value, loss))
        return state._replace(step=state.step + 1), loss.detach()

    return step

"""Faults planted under the timed path, to see ``correct`` come out false
(the CPU tests at a tiny size; ``control.py --fault`` on the card at the
cell's size). Never used by a benchmark run.

  * ``answer``: an answer altered where it is produced (the first gene's
    first prediction, in the forward and in the processor's forward);
  * ``half_batch``: half of the batch left out: the forward runs the first
    half of its genes and hands their outputs to the rest, the training
    loss takes the mean over the first half of its genes;
  * ``unchanged``: a training step that returns its state unchanged;
  * ``token``: a token altered where it is produced (the host build).
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("answer", "half_batch", "unchanged", "token")


def _shifted(real):
    def altered(*a, **k):
        out = real(*a, **k)
        pred = out.pred_expression.clone()
        pred[0, 0] = pred[0, 0] * 1.1 + 0.1
        return out._replace(pred_expression=pred)

    return altered


def _half_forward(real):
    from variantformer_tpu_torch.models.seq2gene import Seq2GeneBatch

    def half(params, batch, cfg, **k):
        d = batch.cre_tokens.shape[0]
        h = max(d // 2, 1)
        cut = Seq2GeneBatch(*(v if v is None or n == "tissue_ids" else v[:h]
                              for n, v in zip(batch._fields, batch)))
        out = real(params, cut, cfg, **k)
        idx = torch.arange(d, device=out.pred_expression.device) % h
        return out._replace(**{n: getattr(out, n)[idx]
                               for n in ("pred_expression", "pooled_embedding")})

    return half


def _half_loss(real):
    def half(params, batch, targets, mask, cfg, *a, **k):
        keep = torch.zeros_like(mask)
        keep[: max(mask.shape[0] // 2, 1)] = True
        return real(params, batch, targets, mask & keep, cfg, *a, **k)

    return half


def _token(real):
    def altered(self, gene_id):
        s = real(self, gene_id)
        s.gene_tokens[0, 0] = 4 + (int(s.gene_tokens[0, 0]) - 3) % 400
        return s

    return altered


@contextlib.contextmanager
def planted(name: str | None):
    """The fault ``name`` (None: none) in place for the block."""
    if name is None:
        yield
        return
    import variantformer_tpu_torch.models.seq2gene as s2g
    import variantformer_tpu_torch.train.steps as steps
    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
    from variantformer_tpu_torch.data.pipeline import GeneSampleBuilder

    patches = {
        "answer": [(s2g, "seq2gene_forward", _shifted), (VCFProcessor, "_forward", _shifted)],
        "half_batch": [(s2g, "seq2gene_forward", _half_forward),
                       (steps, "seq2gene_loss_sum", _half_loss)],
        "unchanged": [(steps, "apply_update", lambda real: lambda opt, value: opt.zero_grad())],
        "token": [(GeneSampleBuilder, "build", _token)],
    }[name]
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, wrap in patches:
            setattr(obj, attr, wrap(getattr(obj, attr)))
        yield
    finally:
        for obj, attr, real in saved:
            setattr(obj, attr, real)

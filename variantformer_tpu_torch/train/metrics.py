"""Classification eval metrics for seq2reg training: the port of
``variantformer_tpu/train/metrics.py``.

Per-class F1 and accuracy over a full validation pass, computed on the host
with numpy, returned as one flat dict in the reference's naming scheme:

  ``{prefix}val_f1_class_{class_name}`` / ``{prefix}val_acc``

with ``prefix = ""`` for the global metrics and ``"{tissue}_"`` for the
per-tissue ones (commas stripped from class names). On a mesh the batches
pass the ``shard_fn`` given to ``train.loop.fit``, and each rank's
predictions are all-gathered before the metrics.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from variantformer_tpu_torch.models.core import AttnSpec
from variantformer_tpu_torch.models.seq2reg import classify_windows, encode_windows
from variantformer_tpu_torch.parallel import comm


def per_class_f1(preds: np.ndarray, labels: np.ndarray, num_classes: int) -> dict[int, float]:
    """F1 per class, skipping classes with no true samples (classes absent
    from the labels are not logged)."""
    out: dict[int, float] = {}
    for c in range(num_classes):
        t = labels == c
        if not t.any():
            continue
        p = preds == c
        tp = float((p & t).sum())
        fp = float((p & ~t).sum())
        fn = float((~p & t).sum())
        precision = tp / (tp + fp) if tp + fp > 0 else 0.0
        recall = tp / (tp + fn) if tp + fn > 0 else 0.0
        out[c] = (2 * precision * recall / (precision + recall)
                  if precision + recall > 0 else 0.0)
    return out


def classification_metrics(
    preds: np.ndarray,
    labels: np.ndarray,
    class_names: Sequence[str],
    tissue_ids: np.ndarray | None = None,
    tissue_names: dict[int, str] | None = None,
) -> dict[str, float]:
    """Flat metric dict: global acc + per-class F1, then the same per
    tissue when ``tissue_ids`` is given."""
    preds = np.asarray(preds)
    labels = np.asarray(labels)
    metrics: dict[str, float] = {}

    def emit(prefix: str, p: np.ndarray, y: np.ndarray) -> None:
        for c, f1 in per_class_f1(p, y, len(class_names)).items():
            metrics[f"{prefix}val_f1_class_{str(class_names[c]).replace(',', '')}"] = f1
        metrics[f"{prefix}val_acc"] = float((p == y).mean())

    emit("", preds, labels)
    if tissue_ids is not None:
        tissue_ids = np.asarray(tissue_ids)
        for tid in np.unique(tissue_ids):
            sel = tissue_ids == tid
            tname = (tissue_names.get(int(tid), str(int(tid))) if tissue_names
                     else str(int(tid)))
            emit(f"{tname}_", preds[sel], labels[sel])
    return metrics


def make_seq2reg_eval_metrics(
    cfg,
    batches_fn: Callable,
    class_names: Sequence[str],
    tissue_names: dict[int, str] | None = None,
    shard_fn=None,
) -> Callable:
    """state -> metric dict over one pass of ``batches_fn(0)`` (pair with
    ``loop.make_seq2reg_eval_loss``, with the same ``shard_fn``): the
    classifier's argmax at float32, without gradients, on the parameters'
    device."""
    wcfg = cfg.window_encoder
    spec = AttnSpec(wcfg.num_heads, wcfg.embedding_dim // wcfg.num_heads)

    def eval_metrics(state) -> dict[str, float]:
        device = state.params["token_embedding"].device
        preds, labels, tissues = [], [], []
        tp = None if shard_fn is None else shard_fn.tp
        with torch.no_grad(), comm.tensor_parallel(tp):
            for b in batches_fn(0):
                if shard_fn is not None:
                    b = shard_fn(tuple(b))
                tokens, tok_len, context, tissue_ids, y = (torch.as_tensor(a).to(device)
                                                           for a in b)
                emb = encode_windows(state.params, tokens, tok_len, context, wcfg, spec,
                                     torch.float32)
                out = (classify_windows(state.params, emb, tissue_ids).argmax(dim=-1), y,
                       tissue_ids)
                if shard_fn is not None:
                    out = tuple(comm.all_gather_cat(x, shard_fn.group) for x in out)
                for acc, x in zip((preds, labels, tissues), out):
                    acc.append(x.cpu().numpy())
        if not preds:
            raise ValueError("eval batches yielded nothing")
        return classification_metrics(
            np.concatenate(preds), np.concatenate(labels), class_names,
            tissue_ids=np.concatenate(tissues), tissue_names=tissue_names,
        )

    return eval_metrics

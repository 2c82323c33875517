"""What decides ``correct``: the plain reference run over the samples the
window produced, and the numbers compared.

  * ``pred_gap``: the largest |program - reference| over the sampled
    (gene, tissue) predictions, over the largest distance of a reference
    prediction from its tissue's mean over the sampled genes;
  * ``emb_gap``: the largest, over the sampled genes, L2 distance of the
    program's pooled [tissues, E] embedding from the reference's, over the
    mean distance of a reference embedding from the sampled genes' mean.

Both are measured against how far genes differ from one another, not
against the outputs' size: with seeded random weights the outputs of two
genes share all but a few percent, so a gap relative to the outputs' size
would pass an answer given for the wrong gene.
"""

from __future__ import annotations

import numpy as np
import torch

from vfx_bench.reference.model import Seq2GeneReference, strict_fp32
from vfx_bench.weights import make_weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def reference_params(cfg: dict, seed: int, device, dtype: str) -> dict:
    """The run's weights made again from the seed (in the dtype the program
    was handed), read as float32."""
    tree = make_weights(cfg, seed, device, DTYPES[dtype])

    def f32(t):
        return {k: f32(v) for k, v in t.items()} if isinstance(t, dict) else t.float()

    return f32(tree)


def reference_outputs(cfg: dict, params: dict, samples: list[dict], tissue_ids, device,
                      fp8: bool = False) -> list[tuple[np.ndarray, np.ndarray]]:
    """(pred [T], pooled [T, E]) of each sample (a gene's valid windows:
    ``cre_tokens`` [C, L], ``cre_tok_len``, ``cre_labels``, ``gene_tokens``
    [G, L], ``gene_tok_len``), one gene at a time in float32."""
    strict_fp32()
    ref = Seq2GeneReference(cfg, params, fp8=fp8)
    tis = torch.as_tensor(np.asarray(tissue_ids), device=device)
    out = []
    with torch.no_grad():
        for s in samples:
            t = {k: torch.as_tensor(np.asarray(v), device=device) for k, v in s.items()}
            pred, pooled = ref.forward_gene(t["cre_tokens"], t["cre_tok_len"], t["cre_labels"],
                                            t["gene_tokens"], t["gene_tok_len"], tis)
            out.append((pred.cpu().numpy(), pooled.cpu().numpy()))
    return out


def serve_gaps(prog: list, ref: list, embeddings: bool = True) -> dict:
    """``prog`` and ``ref``: per sample (pred [T], pooled [T, E] or None)."""
    if len(ref) < 2:
        raise ValueError("the gaps are measured against the spread of two genes or more")
    p = np.stack([np.asarray(a[0], np.float64) for a in prog])
    r = np.stack([np.asarray(b[0], np.float64) for b in ref])
    out = {"pred_gap": float(np.abs(p - r).max() / max(np.abs(r - r.mean(0)).max(), 1e-30))}
    if embeddings:
        pe = np.stack([np.asarray(a[1], np.float64) for a in prog])
        re = np.stack([np.asarray(b[1], np.float64) for b in ref])
        spread = np.linalg.norm((re - re.mean(0)).reshape(len(re), -1), axis=1).mean()
        gap = np.linalg.norm((pe - re).reshape(len(re), -1), axis=1).max()
        out["emb_gap"] = float(gap / max(spread, 1e-30))
    return out


def valid_windows(batch: dict, i: int) -> dict:
    """Row ``i`` of a padded batch (numpy leaves) cut to its valid windows."""
    c, g = int(batch["cre_count"][i]), int(batch["gene_count"][i])
    return {"cre_tokens": batch["cre_tokens"][i, :c], "cre_tok_len": batch["cre_tok_len"][i, :c],
            "cre_labels": batch["cre_labels"][i, :c], "gene_tokens": batch["gene_tokens"][i, :g],
            "gene_tok_len": batch["gene_tok_len"][i, :g]}

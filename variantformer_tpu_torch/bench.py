"""Benchmark of the port: vcf2exp model throughput, genes/s on one GPU at
54 tissues (``python -m variantformer_tpu_torch.bench``).

The counterpart of the repository's root ``bench.py``, with its workload:
the full released model (1536-d, 25 gene layers, 63-way tissue heads,
seeded random weights in bf16) on a batch of D genes (``VFX_BENCH_D``,
default 4), each 384 CRE windows and 200 gene windows of 200 BPE tokens,
fanned out over 54 tissues, through ``seq2gene_forward`` on the card (the
window encoders and the gene stack on the hand-written kernels). One
warm-up call, then the median of 5 calls, each synced by copying
``pred_expression`` to the host. Prints ONE JSON line with ``bench.py``'s
keys.

baseline: 1 gene / 210 s on an H100 (reference notebooks/README.md:17).
Runs on the card only: without one it raises ``device.resolve_device``'s
error.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from variantformer_tpu_torch.config import ModelConfig
from variantformer_tpu_torch.device import resolve_device
from variantformer_tpu_torch.models.init import init_seq2gene
from variantformer_tpu_torch.models.seq2gene import (
    Seq2GeneBatch,
    pack_for_inference,
    seq2gene_forward,
)

BASELINE_GENES_PER_S = 1.0 / 210.0  # H100 end to end, 1 gene x all tissues
TISSUES = 54
CRE_WINDOWS = 384
ITERS = 5


def example_batch(d: int, c: int, g: int, length: int, t: int, vocab: int,
                  rng_seed: int = 0, *, device) -> Seq2GeneBatch:
    """The bench's batch on ``device``: the same numpy draws, in the same
    order, as the root package's ``__graft_entry__._example_batch``, so the
    arrays are equal (every window full, random token and class ids)."""
    rng = np.random.default_rng(rng_seed)
    arrays = dict(
        cre_tokens=rng.integers(4, vocab, (d, c, length)),
        cre_tok_len=np.full((d, c), length),
        cre_count=np.full((d,), c),
        cre_labels=rng.integers(0, 9, (d, c)),
        gene_tokens=rng.integers(4, vocab, (d, g, length)),
        gene_tok_len=np.full((d, g), length),
        gene_count=np.full((d,), g),
        tissue_ids=rng.integers(0, 63, (t,)),
    )
    dev = torch.device(device)
    return Seq2GeneBatch(**{name: torch.as_tensor(a.astype(np.int32), device=dev)
                            for name, a in arrays.items()})


def packed_params(cfg: ModelConfig, params: dict) -> dict:
    """``params`` with the stacks the forward runs through the whole-stack
    ops packed once, as ``VCFProcessor.set_params`` packs them."""
    return pack_for_inference(params, cfg)


def main() -> dict:
    dev = resolve_device("cuda")
    d = int(os.environ.get("VFX_BENCH_D", "4"))
    cfg = ModelConfig()
    params = packed_params(cfg, init_seq2gene(cfg, 0, device=dev, dtype=torch.bfloat16))
    batch = example_batch(d, CRE_WINDOWS, cfg.dataset.max_chunks, cfg.dataset.max_length,
                          TISSUES, cfg.window_encoder.vocab_size, device=dev)

    def call() -> np.ndarray:
        return seq2gene_forward(params, batch, cfg).pred_expression.cpu().numpy()

    with torch.inference_mode():
        out = call()  # warm-up: builds the kernels on first use
        if out.shape != (d, TISSUES) or not np.isfinite(out).all():
            raise RuntimeError(f"bench forward gave {out.shape}, finite={np.isfinite(out).all()}")
        times = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    genes_per_sec = d / dt
    line = {
        "metric": "genes_per_sec_per_gpu_vcf2exp_54tissues",
        "value": round(genes_per_sec, 4),
        "unit": "genes/s",
        "vs_baseline": round(genes_per_sec / BASELINE_GENES_PER_S, 2),
    }
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()

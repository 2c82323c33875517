"""Whole-stack gene modulator: the port of the Pallas ``fused_gene_modulator``.

Replaces ``variantformer_tpu/ops/fused_modulator.py`` ``_kernel`` (entry
``fused_gene_modulator_packed``). Each of the 25 gene layers runs, on the
gene stream [D, T, G1, E]:

  phase 0: LN1 -> QKV -> ALiBi self-attention per (donor, tissue), masked by
           gene_len -> out-proj + x -> LN2 -> cross-Q -> cross-attention to
           the layer's donor-shared CRE K/V, masked by cre_len,
  phase 1: cross out-proj + h -> LN3 -> GeGLU -> + layer input (res_long).

On Hopper each phase is a chain of the shared kernels (``ops/kernels.py``):
eleven launches per layer. The TPU kernel's tissue blocks, donor-innermost
grid, phase-packed weight slabs and 16-row padding are artefacts of VMEM
residency and are gone; all donors and tissues run in each launch, and the
cross-attention kernel reads a donor's K/V for every tissue through a
stride instead of broadcasting it. The cross K/V projection per (layer,
donor) stays a ``torch.matmul`` outside the kernels, as it is XLA outside
the Pallas kernel in the JAX package. At the main-path shapes the GEMMs
dominate, so what bounds the chain is tensor-core throughput.

Weights are packed once at load (``pack_gene_layers``, ~1.2 GB in bf16 at
v4_pcg), never per forward.
"""

from __future__ import annotations

import torch

from variantformer_tpu_torch.models.core import geglu, layer_norm
from variantformer_tpu_torch.ops import kernels
from variantformer_tpu_torch.ops.attention import attend
from variantformer_tpu_torch.ops.fused_encoder import regroup_qkv


def pack_gene_layers(layers: dict, num_heads: int, dtype: torch.dtype) -> dict:
    """Stacked gene-layer params (models/init layout) -> the chain's operands,
    each [num_layers, ...] contiguous: QKV regrouped to q | k | v and cross
    K/V to k | v, matrices and biases in ``dtype``, norms in f32."""
    wqkv, bqkv = regroup_qkv(
        layers["mixer"]["wqkv"]["w"], layers["mixer"]["wqkv"]["b"], num_heads
    )
    wkv, bkv = regroup_qkv(
        layers["cross"]["wkv"]["w"], layers["cross"]["wkv"]["b"], num_heads, num=2
    )
    cast = lambda t: t.to(dtype).contiguous()
    packed = {
        "wqkv": cast(wqkv), "bqkv": cast(bqkv),
        "wo": cast(layers["mixer"]["out"]["w"]), "bo": cast(layers["mixer"]["out"]["b"]),
        "wcq": cast(layers["cross"]["wq"]["w"]), "bcq": cast(layers["cross"]["wq"]["b"]),
        "wckv": cast(wkv), "bckv": cast(bkv),
        "wco": cast(layers["cross"]["out"]["w"]), "bco": cast(layers["cross"]["out"]["b"]),
        "wf1": cast(layers["ffn_in"]["w"]), "bf1": cast(layers["ffn_in"]["b"]),
        "wf2": cast(layers["ffn_out"]["w"]), "bf2": cast(layers["ffn_out"]["b"]),
    }
    for n in ("norm1", "norm2", "norm3"):
        packed[f"{n}_scale"] = layers[n]["scale"].float().contiguous()
        packed[f"{n}_bias"] = layers[n]["bias"].float().contiguous()
    return packed


def cross_kv(cre: torch.Tensor, packed: dict, i: int) -> torch.Tensor:
    """Layer ``i``'s cross K|V [D, C, 2E] from its CRE intermediate [D, C, E],
    projected once per donor and shared by every tissue."""
    return torch.matmul(cre.to(packed["wckv"].dtype), packed["wckv"][i]) + packed["bckv"][i]


def _norm(packed: dict, which: str, i: int) -> dict:
    return {"scale": packed[f"{which}_scale"][i], "bias": packed[f"{which}_bias"][i]}


def fused_gene_modulator_plain(
    gene_stream: torch.Tensor,        # [D, T, G1, E]
    cre_intermediates: torch.Tensor,  # [num_layers, D, C, E]
    gene_len: torch.Tensor,           # [D] valid gene rows (incl. registry)
    cre_len: torch.Tensor,            # [D] valid CRE windows
    packed: dict,
    slopes: torch.Tensor | None,
    scale: float,
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version: the JAX ``_gene_layer`` math (impl="xla",
    only_cross_attention=False) on the packed weights. Returns [D, T, G1, E]."""
    d, t, g1, e = gene_stream.shape
    hd = e // num_heads
    x = gene_stream
    for i in range(packed["wqkv"].shape[0]):
        qkv = layer_norm(_norm(packed, "norm1", i), x) @ packed["wqkv"][i] + packed["bqkv"][i]
        q, k, v = (c.reshape(d * t, g1, num_heads, hd) for c in qkv.chunk(3, dim=-1))
        sa = attend(q, k, v, gene_len.repeat_interleave(t), slopes, scale)
        h = (sa.reshape(d, t, g1, e) @ packed["wo"][i] + packed["bo"][i]) + x
        cq = layer_norm(_norm(packed, "norm2", i), h) @ packed["wcq"][i] + packed["bcq"][i]
        ck, cv = cross_kv(cre_intermediates[i], packed, i).chunk(2, dim=-1)
        c = ck.shape[1]
        # No ALiBi on the cross side, so the query position is irrelevant:
        # fold the tissues into the query axis of each donor.
        ca = attend(
            cq.reshape(d, t * g1, num_heads, hd), ck.reshape(d, c, num_heads, hd),
            cv.reshape(d, c, num_heads, hd), cre_len, None, scale,
        )
        h2 = (ca.reshape(d, t, g1, e) @ packed["wco"][i] + packed["bco"][i]) + h
        f = geglu(layer_norm(_norm(packed, "norm3", i), h2) @ packed["wf1"][i] + packed["bf1"][i])
        x = (f @ packed["wf2"][i] + packed["bf2"][i]) + x
    return x


def fused_gene_modulator(
    gene_stream: torch.Tensor,
    cre_intermediates: torch.Tensor,
    gene_len: torch.Tensor,
    cre_len: torch.Tensor,
    packed: dict,
    slopes: torch.Tensor | None,
    scale: float,
    num_heads: int,
) -> torch.Tensor:
    """Final gene stream [D, T, G1, E] (bf16 on the card).

    CPU tensors take ``fused_gene_modulator_plain``; CUDA tensors run the
    kernel chain (bf16 only) or raise."""
    if not gene_stream.is_cuda:
        return fused_gene_modulator_plain(
            gene_stream, cre_intermediates, gene_len, cre_len, packed, slopes,
            scale, num_heads,
        )
    d, t, g1, e = gene_stream.shape
    gene_len = gene_len.to(torch.int32).contiguous()
    cre_len = cre_len.to(torch.int32).contiguous()
    rows = gene_stream.reshape(d * t * g1, e).contiguous()
    for i in range(packed["wqkv"].shape[0]):
        # phase 0: self-attention, then cross-attention queries and scores
        h1 = kernels.layernorm(rows, packed["norm1_scale"][i], packed["norm1_bias"][i])
        qkv = kernels.gemm(h1, packed["wqkv"][i], packed["bqkv"][i]).view(d * t, g1, 3 * e)
        sa = kernels.attention(
            qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:],
            gene_len, slopes, scale, num_heads, len_div=t,
        )
        h = kernels.gemm(sa.view(-1, e), packed["wo"][i], packed["bo"][i], rows)
        h2n = kernels.layernorm(h, packed["norm2_scale"][i], packed["norm2_bias"][i])
        cq = kernels.gemm(h2n, packed["wcq"][i], packed["bcq"][i]).view(d * t, g1, e)
        ckv = cross_kv(cre_intermediates[i], packed, i)
        ca = kernels.attention(
            cq, ckv[..., :e], ckv[..., e:], cre_len, None, scale, num_heads,
            kv_div=t, len_div=t,
        )
        # phase 1: cross out-projection, GeGLU FFN, res_long
        h2 = kernels.gemm(ca.view(-1, e), packed["wco"][i], packed["bco"][i], h)
        g = kernels.layernorm(h2, packed["norm3_scale"][i], packed["norm3_bias"][i])
        f = kernels.geglu(kernels.gemm(g, packed["wf1"][i], packed["bf1"][i]))
        rows = kernels.gemm(f, packed["wf2"][i], packed["bf2"][i], rows)
    kernels.LAUNCHES["fused_gene_modulator"] += 1
    return rows.view(d, t, g1, e)

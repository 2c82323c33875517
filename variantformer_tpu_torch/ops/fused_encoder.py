"""Whole-stack window encoder: the port of the Pallas ``fused_window_encoder``.

Replaces ``variantformer_tpu/ops/fused_encoder.py`` ``_kernel`` (driven by
``_run_encoder``, entry points ``fused_window_encoder`` and
``fused_window_encoder_dual``). For each of the layers and each window:
LN1 -> fused QKV -> softmax(QK^T*scale - slope*|i-j| + key mask from
tok_len) V -> out-proj + x -> LN2 -> GeGLU -> + layer input; then a masked
mean pool over tok_len.

On Hopper the whole-stack call is a chain of the shared kernels
(``ops/kernels.py``), eight launches per layer plus the pool. The TPU
kernel's reasons for one call (VMEM-resident activations, grid-step
overhead) do not carry over: its window block, 16-row padding and 64-lane
head padding are TPU artefacts and are gone. Activations round-trip device
memory between the launches; the GEMMs dominate the time at the main-path
shapes, so what bounds the chain is tensor-core throughput.

Weights are packed once (``pack_encoder_layers``): QKV columns are
regrouped from head-major (H, 3, D) to q | k | v blocks so the attention
kernel reads each of q, k, v as a strided column slice of one projection.
"""

from __future__ import annotations

import torch

from variantformer_tpu_torch.models.core import geglu, layer_norm
from variantformer_tpu_torch.ops import kernels
from variantformer_tpu_torch.ops.attention import attend


def regroup_qkv(w: torch.Tensor, b: torch.Tensor, num_heads: int, num: int = 3):
    """Head-major packed projection [L, E, H*num*D] -> [L, E, num*H*D] with
    slot-major columns (all heads of q, then of k, ...); same for the bias."""
    nl, e, width = w.shape
    d = width // (num_heads * num)
    w = w.reshape(nl, e, num_heads, num, d).transpose(2, 3).reshape(nl, e, width)
    b = b.reshape(nl, num_heads, num, d).transpose(1, 2).reshape(nl, width)
    return w, b


def pack_encoder_layers(layers: dict, num_heads: int, dtype: torch.dtype) -> dict:
    """Stacked plain-layer params (models/init layout) -> the chain's operands,
    each [num_layers, ...] contiguous: matrices and biases in ``dtype``,
    norm parameters in f32."""
    wqkv, bqkv = regroup_qkv(
        layers["mixer"]["wqkv"]["w"], layers["mixer"]["wqkv"]["b"], num_heads
    )
    cast = lambda t: t.to(dtype).contiguous()
    f32 = lambda t: t.float().contiguous()
    return {
        "norm1_scale": f32(layers["norm1"]["scale"]),
        "norm1_bias": f32(layers["norm1"]["bias"]),
        "wqkv": cast(wqkv), "bqkv": cast(bqkv),
        "wout": cast(layers["mixer"]["out"]["w"]),
        "bout": cast(layers["mixer"]["out"]["b"]),
        "norm2_scale": f32(layers["norm2"]["scale"]),
        "norm2_bias": f32(layers["norm2"]["bias"]),
        "wf1": cast(layers["ffn_in"]["w"]), "bf1": cast(layers["ffn_in"]["b"]),
        "wf2": cast(layers["ffn_out"]["w"]), "bf2": cast(layers["ffn_out"]["b"]),
    }


def _norm(packed: dict, which: str, i: int) -> dict:
    return {"scale": packed[f"{which}_scale"][i], "bias": packed[f"{which}_bias"][i]}


def fused_window_encoder_plain(
    x: torch.Tensor,              # [N, L, E] embedded tokens
    tok_len: torch.Tensor,        # [N] int32
    packed: dict,                 # pack_encoder_layers output
    slopes: torch.Tensor | None,  # [H] f32 or None
    scale: float,
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version: the JAX ``impl="xla"`` math of the plain layer
    flavour, on the packed weights. Returns [N, E] in x's dtype."""
    n, length, e = x.shape
    d = e // num_heads
    for i in range(packed["wqkv"].shape[0]):
        qkv = layer_norm(_norm(packed, "norm1", i), x) @ packed["wqkv"][i] + packed["bqkv"][i]
        q, k, v = (t.reshape(n, length, num_heads, d) for t in qkv.chunk(3, dim=-1))
        a = attend(q, k, v, tok_len, slopes, scale).reshape(n, length, e)
        h = (a @ packed["wout"][i] + packed["bout"][i]) + x
        f = geglu(layer_norm(_norm(packed, "norm2", i), h) @ packed["wf1"][i] + packed["bf1"][i])
        x = (f @ packed["wf2"][i] + packed["bf2"][i]) + x
    return kernels.masked_mean_pool_plain(x, tok_len)


def fused_window_encoder(
    x: torch.Tensor,
    tok_len: torch.Tensor,
    packed: dict,
    slopes: torch.Tensor | None,
    scale: float,
    num_heads: int,
) -> torch.Tensor:
    """Pooled window embeddings [N, E] (bf16 on the card).

    CPU tensors take ``fused_window_encoder_plain``; CUDA tensors run the
    kernel chain (bf16 only) or raise."""
    if not x.is_cuda:
        return fused_window_encoder_plain(x, tok_len, packed, slopes, scale, num_heads)
    n, length, e = x.shape
    tok_len = tok_len.to(torch.int32).contiguous()
    rows = x.reshape(n * length, e).contiguous()
    for i in range(packed["wqkv"].shape[0]):
        h = kernels.layernorm(rows, packed["norm1_scale"][i], packed["norm1_bias"][i])
        qkv = kernels.gemm(h, packed["wqkv"][i], packed["bqkv"][i]).view(n, length, 3 * e)
        a = kernels.attention(
            qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:],
            tok_len, slopes, scale, num_heads,
        )
        h = kernels.gemm(a.view(n * length, e), packed["wout"][i], packed["bout"][i], rows)
        g = kernels.layernorm(h, packed["norm2_scale"][i], packed["norm2_bias"][i])
        f = kernels.geglu(kernels.gemm(g, packed["wf1"][i], packed["bf1"][i]))
        rows = kernels.gemm(f, packed["wf2"][i], packed["bf2"][i], rows)
    kernels.LAUNCHES["fused_window_encoder"] += 1
    return kernels.masked_mean_pool(rows.view(n, length, e), tok_len)


def fused_window_encoder_dual(
    x_a, tok_len_a, packed_a, x_b, tok_len_b, packed_b, slopes, scale, num_heads,
):
    """Encode two window sets with different weight stacks (the CRE and gene
    tokenizers); returns (pooled_a, pooled_b). The Pallas version runs both
    in one grid to save a pipeline fill; here the two stacks are two passes
    of the chain, and the token lengths of the two sets may differ."""
    return (
        fused_window_encoder(x_a, tok_len_a, packed_a, slopes, scale, num_heads),
        fused_window_encoder(x_b, tok_len_b, packed_b, slopes, scale, num_heads),
    )


def fused_window_encoder_dual_plain(
    x_a, tok_len_a, packed_a, x_b, tok_len_b, packed_b, slopes, scale, num_heads,
):
    """Plain version of ``fused_window_encoder_dual`` on any device."""
    return (
        fused_window_encoder_plain(x_a, tok_len_a, packed_a, slopes, scale, num_heads),
        fused_window_encoder_plain(x_b, tok_len_b, packed_b, slopes, scale, num_heads),
    )

"""Core building blocks in plain PyTorch: projections, norms, GeGLU, attention.

The port of ``variantformer_tpu/models/core.py``. Parameters are nested
dicts of tensors. Linear weights are stored [in, out]; the packed QKV output
dimension is head-major ``(heads, 3, head_dim)``, so a contiguous chunk of
the flat output is one whole head.

Layer topology: pre-LN self-attention with symmetric ALiBi, pre-LN
cross-attention, then a GeGLU FFN whose residual adds the *original layer
input* (``res_long``) — the attention stream reaches the output only through
norm3.

Rounding follows the JAX package: a projection is rounded to the compute
dtype before its bias is added, and every residual sum is rounded again.

Under a mesh's tensor parallelism (``parallel/comm.tensor_parallel``, the
layered route only) each rank holds a contiguous run of whole heads and of
FFN columns (``parallel/mesh.shard_params``): ``wqkv``, ``wq``, ``wkv`` and
``ffn_in`` are column-split (``column_linear``), ``out`` and ``ffn_out``
row-split, their partial products summed over the model group before the
bias is added once (``row_linear``), as Megatron-LM splits a layer. Head
counts are read from the local weights and the ALiBi slopes sliced to the
rank's heads.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from variantformer_tpu_torch.ops.attention import attend
from variantformer_tpu_torch.parallel import comm

Params = dict


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Static attention geometry shared by a layer stack."""

    num_heads: int
    head_dim: int

    @property
    def scale(self) -> float:
        return self.head_dim ** -0.5


def layer_slice(stacked: Params, i: int) -> Params:
    """Layer ``i`` of a tree of stacked [num_layers, ...] parameters."""
    if isinstance(stacked, dict):
        return {k: layer_slice(v, i) for k, v in stacked.items()}
    return stacked[i]


def linear(p: Params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    out = torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype))
    return out + p["b"].to(compute_dtype)


def column_linear(p: Params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """A projection whose output columns may be split over the model group."""
    return linear(p, comm.copy_to_tp(x), compute_dtype)


def row_linear(p: Params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """A projection whose input rows may be split over the model group: the
    partial products are summed there, then the bias is added once."""
    out = torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype))
    return comm.reduce_from_tp(out) + p["b"].to(compute_dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with f32 statistics; output in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * p["scale"].float() + p["bias"].float()).to(x.dtype)


def geglu(h: torch.Tensor) -> torch.Tensor:
    """value * gelu(gate) over the [:half] | [half:] split, exact (erf) GELU."""
    value, gate = h.chunk(2, dim=-1)
    return value * F.gelu(gate)


def geglu_ffn(p: Params, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    h = geglu(column_linear(p["ffn_in"], x, compute_dtype))
    return row_linear(p["ffn_out"], h, compute_dtype)


def split_packed_heads(x: torch.Tensor, num: int, heads: int, head_dim: int):
    """[..., heads*num*head_dim] -> ``num`` tensors of [..., heads, head_dim]."""
    x = x.reshape(*x.shape[:-1], heads, num, head_dim)
    return tuple(x[..., i, :] for i in range(num))


def self_attention_block(
    p: Params,
    x: torch.Tensor,                # [B, S, E]
    kv_len: torch.Tensor | None,    # [B] valid (prefix) positions
    slopes: torch.Tensor | None,    # [H] ALiBi slopes or None
    spec: AttnSpec,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    b, s, _ = x.shape
    qkv = column_linear(p["wqkv"], x, compute_dtype)
    q, k, v = split_packed_heads(qkv, 3, comm.local_heads(spec.num_heads), spec.head_dim)
    out = attend(q, k, v, kv_len, comm.local_slopes(slopes), spec.scale).reshape(b, s, -1)
    return row_linear(p["out"], out, compute_dtype)


def cross_attention_block(
    p: Params,
    x: torch.Tensor,                # [B, Sq, E] queries
    ctx: torch.Tensor,              # [B, Sk, E] keys/values source
    ctx_len: torch.Tensor | None,   # [B]
    spec: AttnSpec,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    b, sq, _ = x.shape
    heads = comm.local_heads(spec.num_heads)
    q = column_linear(p["wq"], x, compute_dtype).reshape(b, sq, heads, spec.head_dim)
    kv = column_linear(p["wkv"], ctx, compute_dtype)
    k, v = split_packed_heads(kv, 2, heads, spec.head_dim)
    out = attend(q, k, v, ctx_len, None, spec.scale).reshape(b, sq, -1)
    return row_linear(p["out"], out, compute_dtype)


def context_encoder_layer(
    p: Params,
    x: torch.Tensor,                # [B, S, E] main stream
    ctx: torch.Tensor,              # [B, Sk, E] context stream
    x_len: torch.Tensor | None,
    ctx_len: torch.Tensor | None,
    slopes: torch.Tensor | None,
    spec: AttnSpec,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Self-attn + context cross-attn + GeGLU; the FFN residual adds the
    original ``x`` (res_long), not the post-attention stream."""
    res_long = x
    h = self_attention_block(
        p["mixer"], layer_norm(p["norm1"], x), x_len, slopes, spec, compute_dtype
    )
    h = h + x
    h2 = cross_attention_block(
        p["cross"], layer_norm(p["norm2"], h), ctx, ctx_len, spec, compute_dtype
    )
    h2 = h2 + h
    out = geglu_ffn(p, layer_norm(p["norm3"], h2), compute_dtype)
    return out + res_long


def maybe_remat(fn, remat: bool, *args):
    """``fn(*args)``, checkpointed under autograd when ``remat`` (its
    internals recomputed in the backward)."""
    if remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def cre_loop(
    layers: Params,                 # stacked [num_layers, ...] context layers
    x: torch.Tensor,                # [D, C, E] the CRE stream
    ctx: torch.Tensor,              # [D, C, E] its context rows
    cre_len: torch.Tensor | None,   # [D] valid CRE slots
    slopes: torch.Tensor | None,
    spec: AttnSpec,
    compute_dtype=torch.bfloat16,
    remat: bool = False,
) -> torch.Tensor:
    """The CRE stack as a loop of ``context_encoder_layer``, each layer
    checkpointed under autograd with ``remat``: the intermediates
    [num_layers + 1, D, C, E], the stack's input first."""
    body = lambda x, p: context_encoder_layer(p, x, ctx, cre_len, cre_len, slopes, spec,
                                              compute_dtype)
    steps = [x]
    for i in range(layers["norm1"]["scale"].shape[0]):
        x = maybe_remat(body, remat, x, layer_slice(layers, i))
        steps.append(x)
    return torch.stack(steps)


def cross_only_encoder_layer(
    p: Params,
    x: torch.Tensor,                # [B, S, E] main stream
    ctx: torch.Tensor,              # [B, Sk, E] context stream
    ctx_len: torch.Tensor | None,
    spec: AttnSpec,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Cross-attention-only block: norm1 before the cross-attention, norm2
    before the GeGLU, whose residual adds the original ``x`` (res_long)."""
    h = cross_attention_block(
        p["cross"], layer_norm(p["norm1"], x), ctx, ctx_len, spec, compute_dtype
    )
    h = h + x
    out = geglu_ffn(p, layer_norm(p["norm2"], h), compute_dtype)
    return out + x


def self_only_encoder_layer(
    p: Params,
    x: torch.Tensor,                # [B, S, E]
    x_len: torch.Tensor | None,
    slopes: torch.Tensor | None,
    spec: AttnSpec,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Self-attention-only block (the plain window-encoder layer): both
    residuals add the layer input."""
    h = self_attention_block(
        p["mixer"], layer_norm(p["norm1"], x), x_len, slopes, spec, compute_dtype
    )
    h = h + x
    out = geglu_ffn(p, layer_norm(p["norm2"], h), compute_dtype)
    return out + x

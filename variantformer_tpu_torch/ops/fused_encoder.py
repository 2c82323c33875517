"""Whole-stack window encoder: the port of the Pallas ``fused_window_encoder``
and of its recompute backward.

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

Training (``fused_window_encoder_diff``, the counterpart of the JAX
``fused_window_encoder_diff`` / ``_dual_diff`` custom VJPs): the forward
keeps each layer's input rows (the Pallas ``save_inputs=True`` forward),
and the backward replaces ``_run_layer_bwd`` (``_bwd_kernel``): seeded by
the pool backward, per layer in reverse it recomputes LN1 -> QKV ->
attention (with the rows' log-sum-exp) -> out-proj -> LN2 -> FFN-in from
the saved input and runs the backward chain, with f32 weight gradients
from one GEMM over all rows each (the Pallas grid's VMEM accumulators have
no Hopper counterpart: blocks run in no order). The dual form is two calls:
a frozen stack is never differentiated, so it costs no backward.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from variantformer_tpu_torch.models.core import geglu, layer_norm
from variantformer_tpu_torch.ops import kernels
from variantformer_tpu_torch.ops.attention import attend

# Leaves of a stacked plain-layer tree (models/init layout), in the order
# of the packed operands of pack_encoder_layers.
LEAVES = (
    ("norm1", "scale"), ("norm1", "bias"),
    ("mixer", "wqkv", "w"), ("mixer", "wqkv", "b"),
    ("mixer", "out", "w"), ("mixer", "out", "b"),
    ("norm2", "scale"), ("norm2", "bias"),
    ("ffn_in", "w"), ("ffn_in", "b"),
    ("ffn_out", "w"), ("ffn_out", "b"),
)
PACKED = (
    "norm1_scale", "norm1_bias", "wqkv", "bqkv", "wout", "bout",
    "norm2_scale", "norm2_bias", "wf1", "bf1", "wf2", "bf2",
)


def regroup_qkv(w: torch.Tensor, b: torch.Tensor, num_heads: int, num: int = 3):
    """Head-major packed projection [L, E, H*num*D] -> [L, E, num*H*D] with
    slot-major columns (all heads of q, then of k, ...); same for the bias."""
    nl, e, width = w.shape
    d = width // (num_heads * num)
    w = w.reshape(nl, e, num_heads, num, d).transpose(2, 3).reshape(nl, e, width)
    b = b.reshape(nl, num_heads, num, d).transpose(1, 2).reshape(nl, width)
    return w, b


def ungroup_qkv(w: torch.Tensor, b: torch.Tensor, num_heads: int, num: int = 3):
    """Inverse of ``regroup_qkv``: slot-major columns back to head-major."""
    nl, e, width = w.shape
    d = width // (num_heads * num)
    w = w.reshape(nl, e, num, num_heads, d).transpose(2, 3).reshape(nl, e, width)
    b = b.reshape(nl, num, num_heads, d).transpose(1, 2).reshape(nl, width)
    return w, b


def get_leaf(tree: dict, path: tuple) -> torch.Tensor:
    for key in path:
        tree = tree[key]
    return tree


def unflatten(paths: tuple, leaves) -> dict:
    """Nested dict with ``leaves`` at ``paths``."""
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


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


def _plain_layer(x, tok_len, layer, slopes, scale, num_heads):
    """One layer of ``fused_window_encoder_plain`` (``layer``: one layer's
    packed operands)."""
    n, length, e = x.shape
    d = e // num_heads
    ln = lambda which, t: layer_norm(
        {"scale": layer[f"{which}_scale"], "bias": layer[f"{which}_bias"]}, t)
    qkv = ln("norm1", x) @ layer["wqkv"] + layer["bqkv"]
    q, k, v = (t.reshape(n, length, num_heads, d) for t in qkv.chunk(3, dim=-1))
    a = attend(q, k, v, tok_len, slopes, scale).reshape(n, length, e)
    h = (a @ layer["wout"] + layer["bout"]) + x
    f = geglu(ln("norm2", h) @ layer["wf1"] + layer["bf1"])
    return (f @ layer["wf2"] + layer["bf2"]) + x


def per_layer(fn, packed: dict, x, *args):
    """``x`` through ``fn(x, *args, layer_i)`` for each layer of ``packed``;
    under autograd each layer is checkpointed (its internals are recomputed
    in the backward), so the plain stacks' gradients fit at full width."""
    for i in range(next(iter(packed.values())).shape[0]):
        layer = {k: v[i] for k, v in packed.items()}
        if torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(fn, x, *args, layer, use_reentrant=False)
        else:
            x = fn(x, *args, layer)
    return x


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
    layer_fn = lambda x, layer: _plain_layer(x, tok_len, layer, slopes, scale, num_heads)
    x = per_layer(layer_fn, packed, x)
    return kernels.masked_mean_pool_plain(x, tok_len)


def _chain(ops, x, tok_len, packed, slopes, scale, num_heads, saved=None):
    """The forward chain on ``ops``; appends each layer's input rows
    [N*L, E] to ``saved`` when given."""
    n, length, e = x.shape
    rows = x.reshape(n * length, e).contiguous()
    for i in range(packed["wqkv"].shape[0]):
        if saved is not None:
            saved.append(rows)
        h = ops.layernorm(rows, packed["norm1_scale"][i], packed["norm1_bias"][i])
        qkv = ops.gemm(h, packed["wqkv"][i], packed["bqkv"][i]).view(n, length, 3 * e)
        a = ops.attention(
            qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:],
            tok_len, slopes, scale, num_heads,
        )
        h = ops.gemm(a.view(n * length, e), packed["wout"][i], packed["bout"][i], rows)
        g = ops.layernorm(h, packed["norm2_scale"][i], packed["norm2_bias"][i])
        f = ops.geglu(ops.gemm(g, packed["wf1"][i], packed["bf1"][i]))
        rows = ops.gemm(f, packed["wf2"][i], packed["bf2"][i], rows)
    return ops.masked_mean_pool(rows.view(n, length, e), tok_len)


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
    out = _chain(kernels.KERNELS, x, tok_len.to(torch.int32).contiguous(), packed, slopes,
                 scale, num_heads)
    kernels.LAUNCHES["fused_window_encoder"] += 1
    return out


def _layer_bwd(ops, i, x, dnext, tok_len, packed, grads, slopes, scale, num_heads, n, length):
    """Layer ``i``'s recompute backward (the work of one Pallas
    ``_run_layer_bwd`` call): x is the layer's saved input [N*L, E], dnext
    the cotangent of its output; fills layer i of the packed-layout f32
    ``grads`` and returns the cotangent of x."""
    e = x.shape[1]
    # recompute the forward internals from the layer input
    h1 = ops.layernorm(x, packed["norm1_scale"][i], packed["norm1_bias"][i])
    qkv = ops.gemm(h1, packed["wqkv"][i], packed["bqkv"][i]).view(n, length, 3 * e)
    q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
    a, lse, a32 = ops.attention(q, k, v, tok_len, slopes, scale, num_heads, for_backward=True)
    a2 = a.view(n * length, e)
    h = ops.gemm(a2, packed["wout"][i], packed["bout"][i], x)
    g = ops.layernorm(h, packed["norm2_scale"][i], packed["norm2_bias"][i])
    f = ops.gemm(g, packed["wf1"][i], packed["bf1"][i])
    m = ops.geglu(f)
    # x_next = FFN(LN2(h)) + x (res_long): FFN-out, GeGLU, FFN-in, LN2
    ops.gemm_wgrad(m, dnext, out=grads["wf2"][i])
    grads["bf2"][i] = ops.colsum(dnext)
    df = ops.geglu_bwd(f, ops.gemm_dgrad(dnext, packed["wf2"][i]))
    ops.gemm_wgrad(g, df, out=grads["wf1"][i])
    grads["bf1"][i] = ops.colsum(df)
    dh, grads["norm2_scale"][i], grads["norm2_bias"][i] = ops.layernorm_bwd(
        h, ops.gemm_dgrad(df, packed["wf1"][i]), packed["norm2_scale"][i]
    )
    # h = out-proj(attention) + x
    ops.gemm_wgrad(a2, dh, out=grads["wout"][i])
    grads["bout"][i] = ops.colsum(dh)
    da = ops.gemm_dgrad(dh, packed["wout"][i]).view(n, length, e)
    dqkv = torch.empty_like(qkv)
    ops.attention_bwd(
        q, k, v, a32, lse, da, tok_len, slopes, scale, num_heads,
        dq=dqkv[..., :e], dk=dqkv[..., e:2 * e], dv=dqkv[..., 2 * e:],
    )
    dqkv = dqkv.view(n * length, 3 * e)
    ops.gemm_wgrad(h1, dqkv, out=grads["wqkv"][i])
    grads["bqkv"][i] = ops.colsum(dqkv)
    # dx = dnext + dh + LN1 backward
    dx, grads["norm1_scale"][i], grads["norm1_bias"][i] = ops.layernorm_bwd(
        x, ops.gemm_dgrad(dqkv, packed["wqkv"][i]), packed["norm1_scale"][i], (dnext, dh)
    )
    if ops is kernels.KERNELS:
        kernels.LAUNCHES["fused_window_encoder_bwd"] += 1
    return dx


def fused_window_encoder_bwd(dpool, xsave, tok_len, packed, slopes, scale, num_heads,
                             ops=kernels.KERNELS):
    """Backward of the whole stack from the pooled cotangent dpool [N, E]
    and the saved layer inputs (one [N*L, E] per layer): returns (dx
    [N, L, E], packed-layout f32 weight gradients). Pad windows and token
    rows past tok_len get exactly 0."""
    n, e = dpool.shape
    length = xsave[0].shape[0] // n
    grads = {k: torch.zeros(packed[k].shape, dtype=torch.float32, device=dpool.device)
             for k in PACKED}
    dnext = ops.masked_mean_pool_bwd(dpool.contiguous(), tok_len, length).view(n * length, e)
    for i in reversed(range(len(xsave))):
        dnext = _layer_bwd(ops, i, xsave[i], dnext, tok_len, packed, grads, slopes, scale,
                           num_heads, n, length)
    return dnext.view(n, length, e), grads


def fused_window_encoder_bwd_plain(dpool, xsave, tok_len, packed, slopes, scale, num_heads):
    """``fused_window_encoder_bwd`` on the plain versions of the kernels (the
    CPU's path, and the card's yardstick)."""
    return fused_window_encoder_bwd(dpool, xsave, tok_len, packed, slopes, scale, num_heads,
                                    ops=kernels.PLAIN)


def unpack_grads(grads: dict, num_heads: int) -> list:
    """Packed-layout gradients -> one per ``LEAVES`` entry (models/init layout)."""
    out = dict(grads)
    out["wqkv"], out["bqkv"] = ungroup_qkv(grads["wqkv"], grads["bqkv"], num_heads)
    return [out[k] for k in PACKED]


class _WindowEncoder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tok_len, slopes, scale, num_heads, *leaves):
        packed = pack_encoder_layers(unflatten(LEAVES, leaves), num_heads, x.dtype)
        tok_len = tok_len.to(torch.int32).contiguous().clone()
        xsave: list = []
        out = _chain(kernels.ops_for(x), x, tok_len, packed, slopes, scale, num_heads, xsave)
        if x.is_cuda:
            kernels.LAUNCHES["fused_window_encoder"] += 1
        ctx.save_for_backward(tok_len, slopes)
        ctx.packed, ctx.xsave = packed, xsave
        ctx.scale, ctx.num_heads = scale, num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        tok_len, slopes = ctx.saved_tensors
        bwd = fused_window_encoder_bwd if dout.is_cuda else fused_window_encoder_bwd_plain
        dx, grads = bwd(dout, ctx.xsave, tok_len, ctx.packed, slopes, ctx.scale, ctx.num_heads)
        ctx.xsave = ctx.packed = None
        leaf_grads = unpack_grads(grads, ctx.num_heads)
        need = ctx.needs_input_grad
        return (
            dx if need[0] else None, None, None, None, None,
            *(g if need[5 + j] else None for j, g in enumerate(leaf_grads)),
        )


def fused_window_encoder_diff(
    x: torch.Tensor,              # [N, L, E] embedded tokens
    tok_len: torch.Tensor,        # [N] int
    layers: dict,                 # stacked plain-layer params (models/init layout)
    slopes: torch.Tensor | None,
    scale: float,
    num_heads: int,
) -> torch.Tensor:
    """Differentiable whole-stack encoder: pooled [N, E] in x's dtype, with
    d(x) and f32 d(layers) from the recompute backward. Call it only when a
    gradient is wanted: it keeps every layer's input until the backward."""
    leaves = [get_leaf(layers, p) for p in LEAVES]
    return _WindowEncoder.apply(x, tok_len, slopes, scale, num_heads, *leaves)

"""Whole-stack window encoder: the port of the Pallas ``fused_window_encoder``
and of its recompute backward.

Replaces ``variantformer_tpu/ops/fused_encoder.py`` ``_kernel`` (driven by
``_run_encoder``, entry points ``fused_window_encoder`` and
``fused_window_encoder_dual``). For each of the layers and each window:
LN1 -> fused QKV -> softmax(QK^T*scale - slope*|i-j| + key mask from
tok_len) V -> out-proj + x -> LN2 -> GeGLU -> + layer input; then a masked
mean pool over tok_len.

On Hopper the whole-stack call is a chain of the shared kernels
(``ops/kernels.py``), seven launches per layer plus the pool (the GeGLU in the
FFN-in GEMM's epilogue, ``kernels.gemm_geglu``). The TPU
kernel's reasons for one call (VMEM-resident activations, grid-step
overhead) do not carry over: its window block, 16-row padding and 64-lane
head padding are TPU artefacts and are gone. Activations round-trip device
memory between the launches; the GEMMs dominate the time at the main-path
shapes, so what bounds the chain is tensor-core throughput. The plain
version is the same chain on the kernels' plain versions
(``kernels.PLAIN``); the chains of the gene and CRE stacks share its layer
loop's helpers (``unstack``, ``layer_step``).

Weights are packed once (``pack_encoder_layers``): QKV columns are
regrouped from head-major (H, 3, D) to q | k | v blocks so the attention
kernel reads each of q, k, v as a strided column slice of one projection.
The attention kernels are built for head dims 48, 64 and 128; another head
is zero-padded to 64 lanes in the packs (to 128 above 64, the JAX package's
``_pad_heads``), the matching out-projection rows too, so the padding is
exact. The plain versions and the card's kernels run every such pack.

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

from typing import Optional

import torch
import torch.utils.checkpoint

from variantformer_tpu_torch.ops import graphs, kernels

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


def head_lanes(head_dim: int) -> int:
    """A head's width in the packed projections: the head dim itself where
    the attention kernels are built for it, else the head zero-padded to 64
    lanes (up to 64) or 128 (up to 128), as the JAX package's ``_pad_heads``
    does (exact: zero q/k lanes add nothing to QK^T, and zero v lanes meet
    zero out-projection rows). The softmax scale stays the true head dim's.
    The plain versions and the card's kernels run any of these packs."""
    if head_dim in kernels.ATTN_HEAD_DIMS:
        return head_dim
    if head_dim <= 64:
        return 64
    if head_dim <= 128:
        return 128
    raise NotImplementedError(f"head_dim {head_dim} > 128")


def require_kernel_lanes(lanes: int) -> None:
    """Refuse, before any launch, a pack whose heads no build of the
    attention kernels takes (``head_lanes`` gives only built widths; a pack
    made another way may not)."""
    if lanes not in kernels.ATTN_HEAD_DIMS:
        raise NotImplementedError(
            f"{lanes}-lane heads: the attention kernels are built for head dims "
            f"{kernels.ATTN_HEAD_DIMS} (others padded by head_lanes)")


def pack_heads(w: torch.Tensor, b: torch.Tensor, num_heads: int, num: int = 3,
               lanes: int | None = None):
    """Head-major packed projection [L, E, H*num*D] -> [L, E, num*H*lanes]
    with slot-major columns (all heads of q, then of k, ...), each head
    zero-padded from D to ``lanes`` (default D); the same for the bias."""
    nl, e, width = w.shape
    d = width // (num_heads * num)
    w = _pad_last(w.reshape(nl, e, num_heads, num, d).transpose(2, 3), (lanes or d) - d)
    b = _pad_last(b.reshape(nl, num_heads, num, d).transpose(1, 2), (lanes or d) - d)
    return w.reshape(nl, e, -1), b.reshape(nl, -1)


def _pad_last(t: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
    """``t`` with ``n`` zeros after the end of ``dim`` (-1 or -2); ``t``
    itself when ``n`` is 0, so that a pack with nothing to pad stays a view
    where its regrouping is one."""
    if not n:
        return t
    return torch.nn.functional.pad(t, (0, n) if dim == -1 else (0, 0, 0, n))


def unpack_heads(w: torch.Tensor, b: torch.Tensor, num_heads: int, head_dim: int,
                 num: int = 3):
    """Inverse of ``pack_heads``: slot-major columns back to head-major, the
    pad lanes dropped."""
    nl, e, width = w.shape
    lanes = width // (num_heads * num)
    w = w.reshape(nl, e, num, num_heads, lanes)[..., :head_dim].transpose(2, 3)
    b = b.reshape(nl, num, num_heads, lanes)[..., :head_dim].transpose(1, 2)
    return w.reshape(nl, e, -1), b.reshape(nl, -1)


def pad_head_rows(w: torch.Tensor, num_heads: int, lanes: int) -> torch.Tensor:
    """An out-projection [L, H*D, E] -> [L, H*lanes, E], zero rows after each
    head's D rows (the rows that meet the padded attention lanes)."""
    nl, hd, e = w.shape
    d = hd // num_heads
    return _pad_last(w.reshape(nl, num_heads, d, e), lanes - d, dim=-2).reshape(nl, -1, e)


def unpad_head_rows(w: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    """Inverse of ``pad_head_rows``."""
    nl, width, e = w.shape
    return w.reshape(nl, num_heads, width // num_heads, e)[:, :, :head_dim].reshape(nl, -1, e)


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
    norm parameters in f32, heads padded to ``head_lanes``."""
    e = layers["norm1"]["scale"].shape[-1]
    lanes = head_lanes(e // num_heads)
    wqkv, bqkv = pack_heads(
        layers["mixer"]["wqkv"]["w"], layers["mixer"]["wqkv"]["b"], num_heads, lanes=lanes
    )
    cast = lambda t: t.to(dtype).contiguous()
    f32 = lambda t: t.float().contiguous()
    return {
        "norm1_scale": f32(layers["norm1"]["scale"]),
        "norm1_bias": f32(layers["norm1"]["bias"]),
        "wqkv": cast(wqkv), "bqkv": cast(bqkv),
        "wout": cast(pad_head_rows(layers["mixer"]["out"]["w"], num_heads, lanes)),
        "bout": cast(layers["mixer"]["out"]["b"]),
        "norm2_scale": f32(layers["norm2"]["scale"]),
        "norm2_bias": f32(layers["norm2"]["bias"]),
        "wf1": cast(layers["ffn_in"]["w"]), "bf1": cast(layers["ffn_in"]["b"]),
        "wf2": cast(layers["ffn_out"]["w"]), "bf2": cast(layers["ffn_out"]["b"]),
    }


def unstack(packed: dict) -> list[dict]:
    """A packed stack's operands one layer at a time: a dict a layer, each
    leaf a view of its layer (one unbind a leaf rather than a select a leaf
    and layer: less host time)."""
    return [dict(zip(packed, layer)) for layer in zip(*(t.unbind() for t in packed.values()))]


def layer_step(ops, body, *args):
    """``body(ops, *args)``: one layer of a chain. On the plain versions
    under autograd the layer is checkpointed (its internals recomputed in
    the backward), so that the plain stacks' gradients fit at full width."""
    if ops is kernels.PLAIN and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(body, ops, *args, use_reentrant=False)
    return body(ops, *args)


def _layer(ops, rows, layer, n, length, tok_len, slopes, scale, num_heads):
    """One layer on ``ops``: its input rows [N*L, E] -> its output rows."""
    ea = layer["wqkv"].shape[-1] // 3  # attention width: heads x (padded) head dim
    h = ops.layernorm(rows, layer["norm1_scale"], layer["norm1_bias"])
    qkv = ops.gemm(h, layer["wqkv"], layer["bqkv"]).view(n, length, 3 * ea)
    a = ops.attention(qkv[..., :ea], qkv[..., ea:2 * ea], qkv[..., 2 * ea:],
                      tok_len, slopes, scale, num_heads)
    h = ops.gemm(a.view(n * length, ea), layer["wout"], layer["bout"], rows)
    g = ops.layernorm(h, layer["norm2_scale"], layer["norm2_bias"])
    f = ops.gemm_geglu(g, layer["wf1"], layer["bf1"])
    return ops.gemm(f, layer["wf2"], layer["bf2"], rows)


def _chain(ops, x, tok_len, packed, slopes, scale, num_heads, saved=None):
    """The forward chain on ``ops``; appends each layer's input rows
    [N*L, E] to ``saved`` when given."""
    n, length, e = x.shape
    if ops is kernels.KERNELS:
        require_kernel_lanes(packed["wqkv"].shape[-1] // 3 // num_heads)
    rows = x.reshape(n * length, e).contiguous()
    for layer in unstack(packed):
        if saved is not None:
            saved.append(rows)
        rows = layer_step(ops, _layer, rows, layer, n, length, tok_len, slopes, scale, num_heads)
    return ops.masked_mean_pool(rows.view(n, length, e), tok_len)


def fused_window_encoder_plain(
    x: torch.Tensor,              # [N, L, E] embedded tokens
    tok_len: torch.Tensor,        # [N] int32
    packed: dict,                 # pack_encoder_layers output
    slopes: torch.Tensor | None,  # [H] f32 or None
    scale: float,
    num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version: the chain on the kernels' plain versions
    (``kernels.PLAIN``), each layer checkpointed under autograd. Returns
    [N, E] in x's dtype."""
    return _chain(kernels.PLAIN, x, tok_len, packed, slopes, scale, num_heads)


# The inference stack as a torch.library op, so that torch.export can carry
# it (api/serving.py): the packed dict goes in as a list in PACKED order.
# Its CUDA kernel is the kernel chain, replayed as a CUDA graph
# (ops/graphs.py), its CPU kernel the plain version.
@torch.library.custom_op("vfx_torch::fused_window_encoder", mutates_args=(),
                         device_types="cpu")
def window_encoder_op(x: torch.Tensor, tok_len: torch.Tensor, packed: list[torch.Tensor],
                      slopes: Optional[torch.Tensor], scale: float,
                      num_heads: int) -> torch.Tensor:
    with torch.no_grad():
        return fused_window_encoder_plain(x, tok_len, dict(zip(PACKED, packed)), slopes, scale,
                                          num_heads)


@window_encoder_op.register_kernel("cuda")
def _window_encoder_cuda(x, tok_len, packed, slopes, scale, num_heads):
    layers = dict(zip(PACKED, packed))
    chain = lambda x, tok_len, slopes: _chain(  # noqa: E731
        kernels.KERNELS, x, tok_len, layers, slopes, scale, num_heads)
    out = graphs.CACHE.run("fused_window_encoder", chain, (x, tok_len, slopes), packed,
                           (scale, num_heads))
    kernels.LAUNCHES["fused_window_encoder"] += 1
    return out


@window_encoder_op.register_fake
def _window_encoder_fake(x, tok_len, packed, slopes, scale, num_heads):
    return x.new_empty((x.shape[0], x.shape[2]))


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
    kernel chain (bf16 only) or raise, through the op
    ``vfx_torch::fused_window_encoder`` (as does a ``torch.export`` trace on
    any device, whose artifact then holds the op)."""
    if not x.is_cuda and not torch.compiler.is_exporting():
        return fused_window_encoder_plain(x, tok_len, packed, slopes, scale, num_heads)
    return window_encoder_op(x, tok_len.to(torch.int32).contiguous(),
                             [packed[k] for k in PACKED], slopes, float(scale), int(num_heads))


def _layer_bwd(ops, i, x, dnext, tok_len, packed, grads, slopes, scale, num_heads, n, length):
    """Layer ``i``'s recompute backward (the work of one Pallas
    ``_run_layer_bwd`` call): x is the layer's saved input [N*L, E], dnext
    the cotangent of its output; fills layer i of the packed-layout f32
    ``grads`` and returns the cotangent of x."""
    ea = packed["wqkv"].shape[-1] // 3
    # recompute the forward internals from the layer input
    h1 = ops.layernorm(x, packed["norm1_scale"][i], packed["norm1_bias"][i])
    qkv = ops.gemm(h1, packed["wqkv"][i], packed["bqkv"][i]).view(n, length, 3 * ea)
    q, k, v = qkv[..., :ea], qkv[..., ea:2 * ea], qkv[..., 2 * ea:]
    a, lse, a32 = ops.attention(q, k, v, tok_len, slopes, scale, num_heads, for_backward=True)
    a2 = a.view(n * length, ea)
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
    da = ops.gemm_dgrad(dh, packed["wout"][i]).view(n, length, ea)
    dqkv = torch.empty_like(qkv)
    ops.attention_bwd(
        q, k, v, a32, lse, da, tok_len, slopes, scale, num_heads,
        dq=dqkv[..., :ea], dk=dqkv[..., ea:2 * ea], dv=dqkv[..., 2 * ea:],
    )
    dqkv = dqkv.view(n * length, 3 * ea)
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


def unpack_grads(grads: dict, num_heads: int, head_dim: int) -> list:
    """Packed-layout gradients -> one per ``LEAVES`` entry (models/init
    layout); the pad lanes' gradients are dropped."""
    out = dict(grads)
    out["wqkv"], out["bqkv"] = unpack_heads(grads["wqkv"], grads["bqkv"], num_heads, head_dim)
    out["wout"] = unpad_head_rows(grads["wout"], num_heads, head_dim)
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
        ctx.head_dim = x.shape[-1] // num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        tok_len, slopes = ctx.saved_tensors
        bwd = fused_window_encoder_bwd if dout.is_cuda else fused_window_encoder_bwd_plain
        dx, grads = bwd(dout, ctx.xsave, tok_len, ctx.packed, slopes, ctx.scale, ctx.num_heads)
        ctx.xsave = ctx.packed = None
        leaf_grads = unpack_grads(grads, ctx.num_heads, ctx.head_dim)
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

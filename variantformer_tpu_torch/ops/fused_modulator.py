"""Whole-stack gene modulator: the port of the Pallas ``fused_gene_modulator``
and of its checkpointing forward and recompute backward.

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
dominate, so what bounds the chain is tensor-core throughput. The plain
version is the same chain on the kernels' plain versions
(``kernels.PLAIN``).

Weights are packed once at load (``pack_gene_layers``, ~1.2 GB in bf16 at
v4_pcg), never per forward. A head dim below 64 other than 48 is zero-padded
to 64 lanes in the packs, as the window encoder's are
(``ops/fused_encoder.head_lanes``; the JAX package's whole gene stack, and
so the port's, takes head dims up to 64).

Training (``fused_gene_modulator_diff``, the counterpart of the JAX
``fused_gene_modulator_diff`` custom VJP):
  * the forward is the chain that also keeps each layer's input x_l and
    post-self-attention residual h_l (and its cross K/V): ``_run_fwd_save``;
  * per layer in reverse, ``_bwd1`` (the Pallas ``_run_bwd1``) recomputes
    LN2 -> cross-Q -> cross-attention -> cross-out -> LN3 -> GeGLU from h_l
    and runs the FFN, LN3, cross-out, cross-attention and LN2 backward; it
    gives dh, the phase-1 weight gradients and the per-donor cross K|V
    cotangent summed over the tissues that share it (inside the attention
    backward kernel);
  * ``_bwd0`` (the Pallas ``_run_bwd0``) recomputes LN1 -> QKV -> ALiBi
    self-attention from x_l and runs the out-proj, attention, QKV and LN1
    backward: dx = dnext + dh + dLN1 and the phase-0 weight gradients;
  * the cross K|V cotangent becomes d(cre_intermediates) and the ``wkv``
    gradients by f32 ``torch.matmul`` outside the kernels, as XLA does in
    the JAX package. Weight gradients are f32 and come back in the raw
    ``gene_layers`` layout (``pack_heads`` and the head padding undone).
"""

from __future__ import annotations

from typing import Optional

import torch

from variantformer_tpu_torch.ops import graphs, kernels
from variantformer_tpu_torch.ops.fused_encoder import (
    get_leaf,
    head_lanes,
    layer_step,
    pack_heads,
    pad_head_rows,
    require_kernel_lanes,
    unflatten,
    unpack_heads,
    unpad_head_rows,
    unstack,
)

# Leaves of a stacked gene-layer tree (models/init layout), in the order of
# the packed operands of pack_gene_layers.
LEAVES = (
    ("norm1", "scale"), ("norm1", "bias"),
    ("mixer", "wqkv", "w"), ("mixer", "wqkv", "b"),
    ("mixer", "out", "w"), ("mixer", "out", "b"),
    ("norm2", "scale"), ("norm2", "bias"),
    ("cross", "wq", "w"), ("cross", "wq", "b"),
    ("cross", "wkv", "w"), ("cross", "wkv", "b"),
    ("cross", "out", "w"), ("cross", "out", "b"),
    ("norm3", "scale"), ("norm3", "bias"),
    ("ffn_in", "w"), ("ffn_in", "b"),
    ("ffn_out", "w"), ("ffn_out", "b"),
)
PACKED = (
    "norm1_scale", "norm1_bias", "wqkv", "bqkv", "wo", "bo",
    "norm2_scale", "norm2_bias", "wcq", "bcq", "wckv", "bckv", "wco", "bco",
    "norm3_scale", "norm3_bias", "wf1", "bf1", "wf2", "bf2",
)


def pack_gene_layers(layers: dict, num_heads: int, dtype: torch.dtype) -> dict:
    """Stacked gene-layer params (models/init layout) -> the chain's operands,
    each [num_layers, ...] contiguous: QKV regrouped to q | k | v and cross
    K/V to k | v, heads padded to ``head_lanes``, matrices and biases in
    ``dtype``, norms in f32."""
    lanes = head_lanes(layers["norm1"]["scale"].shape[-1] // num_heads)
    cross = layers["cross"]
    wqkv, bqkv = pack_heads(
        layers["mixer"]["wqkv"]["w"], layers["mixer"]["wqkv"]["b"], num_heads, lanes=lanes
    )
    wkv, bkv = pack_heads(cross["wkv"]["w"], cross["wkv"]["b"], num_heads, num=2, lanes=lanes)
    wcq, bcq = pack_heads(cross["wq"]["w"], cross["wq"]["b"], num_heads, num=1, lanes=lanes)
    cast = lambda t: t.to(dtype).contiguous()
    packed = {
        "wqkv": cast(wqkv), "bqkv": cast(bqkv),
        "wo": cast(pad_head_rows(layers["mixer"]["out"]["w"], num_heads, lanes)),
        "bo": cast(layers["mixer"]["out"]["b"]),
        "wcq": cast(wcq), "bcq": cast(bcq),
        "wckv": cast(wkv), "bckv": cast(bkv),
        "wco": cast(pad_head_rows(cross["out"]["w"], num_heads, lanes)),
        "bco": cast(cross["out"]["b"]),
        "wf1": cast(layers["ffn_in"]["w"]), "bf1": cast(layers["ffn_in"]["b"]),
        "wf2": cast(layers["ffn_out"]["w"]), "bf2": cast(layers["ffn_out"]["b"]),
    }
    for n in ("norm1", "norm2", "norm3"):
        packed[f"{n}_scale"] = layers[n]["scale"].float().contiguous()
        packed[f"{n}_bias"] = layers[n]["bias"].float().contiguous()
    return packed


def cross_kv(cre: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A layer's cross K|V [D, C, 2E] from its CRE intermediate [D, C, E]
    and packed ``wckv``/``bckv``, projected once per donor and shared by
    every tissue."""
    return torch.matmul(cre.to(w.dtype), w) + b


def _layer(ops, rows, layer, cre, t, g1, gene_len, cre_len, slopes, scale, num_heads):
    """One gene layer on ``ops``: its input rows [D*T*G1, E] and its CRE
    intermediate [D, C, E] -> (its output rows, h, its cross K|V), the
    last two what the backward recomputes from."""
    ea = layer["wqkv"].shape[-1] // 3  # attention width: heads x (padded) head dim
    # phase 0: self-attention, then cross-attention queries and scores
    h1 = ops.layernorm(rows, layer["norm1_scale"], layer["norm1_bias"])
    qkv = ops.gemm(h1, layer["wqkv"], layer["bqkv"]).view(-1, g1, 3 * ea)
    sa = ops.attention(qkv[..., :ea], qkv[..., ea:2 * ea], qkv[..., 2 * ea:],
                       gene_len, slopes, scale, num_heads, len_div=t)
    h = ops.gemm(sa.view(-1, ea), layer["wo"], layer["bo"], rows)
    h2n = ops.layernorm(h, layer["norm2_scale"], layer["norm2_bias"])
    cq = ops.gemm(h2n, layer["wcq"], layer["bcq"]).view(-1, g1, ea)
    ckv = cross_kv(cre, layer["wckv"], layer["bckv"])
    ca = ops.attention(cq, ckv[..., :ea], ckv[..., ea:], cre_len, None, scale, num_heads,
                       kv_div=t, len_div=t)
    # phase 1: cross out-projection, GeGLU FFN, res_long
    h2 = ops.gemm(ca.view(-1, ea), layer["wco"], layer["bco"], h)
    g = ops.layernorm(h2, layer["norm3_scale"], layer["norm3_bias"])
    f = ops.geglu(ops.gemm(g, layer["wf1"], layer["bf1"]))
    return ops.gemm(f, layer["wf2"], layer["bf2"], rows), h, ckv


def _chain(ops, gene_stream, cre_intermediates, gene_len, cre_len, packed, slopes, scale,
           num_heads, saves=None):
    """The forward chain on ``ops``; appends (x_l, h_l, cross K|V) of each
    layer to ``saves`` when given (the Pallas ``_run_fwd_save``)."""
    d, t, g1, e = gene_stream.shape
    if ops is kernels.KERNELS:
        require_kernel_lanes(packed["wqkv"].shape[-1] // 3 // num_heads)
    rows = gene_stream.reshape(d * t * g1, e).contiguous()
    for layer, cre in zip(unstack(packed), cre_intermediates.unbind()):
        out, h, ckv = layer_step(ops, _layer, rows, layer, cre, t, g1, gene_len, cre_len,
                                 slopes, scale, num_heads)
        if saves is not None:
            saves.append((rows, h, ckv))
        rows = out
    return rows.view(d, t, g1, e)


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
    """Plain PyTorch version: the chain on the kernels' plain versions
    (``kernels.PLAIN``), each layer checkpointed under autograd. Returns
    [D, T, G1, E]."""
    return _chain(kernels.PLAIN, gene_stream, cre_intermediates, gene_len, cre_len, packed,
                  slopes, scale, num_heads)


# The inference stack as a torch.library op, so that torch.export can carry
# it (api/serving.py): the packed dict goes in as a list in PACKED order.
# Its CUDA kernel is the kernel chain, replayed as a CUDA graph
# (ops/graphs.py), its CPU kernel the plain version.
@torch.library.custom_op("vfx_torch::fused_gene_modulator", mutates_args=(),
                         device_types="cpu")
def gene_modulator_op(gene_stream: torch.Tensor, cre_intermediates: torch.Tensor,
                      gene_len: torch.Tensor, cre_len: torch.Tensor,
                      packed: list[torch.Tensor], slopes: Optional[torch.Tensor], scale: float,
                      num_heads: int) -> torch.Tensor:
    with torch.no_grad():
        return fused_gene_modulator_plain(gene_stream, cre_intermediates, gene_len, cre_len,
                                          dict(zip(PACKED, packed)), slopes, scale, num_heads)


@gene_modulator_op.register_kernel("cuda")
def _gene_modulator_cuda(gene_stream, cre_intermediates, gene_len, cre_len, packed, slopes,
                         scale, num_heads):
    layers = dict(zip(PACKED, packed))
    chain = lambda gs, cre, gene_len, cre_len, slopes: _chain(  # noqa: E731
        kernels.KERNELS, gs, cre, gene_len, cre_len, layers, slopes, scale, num_heads)
    out = graphs.CACHE.run("fused_gene_modulator", chain,
                           (gene_stream, cre_intermediates, gene_len, cre_len, slopes), packed,
                           (scale, num_heads))
    kernels.LAUNCHES["fused_gene_modulator"] += 1
    return out


@gene_modulator_op.register_fake
def _gene_modulator_fake(gene_stream, cre_intermediates, gene_len, cre_len, packed, slopes,
                         scale, num_heads):
    return gene_stream.new_empty(gene_stream.shape)


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
    kernel chain (bf16 only) or raise, through the op
    ``vfx_torch::fused_gene_modulator`` (as does a ``torch.export`` trace on
    any device, whose artifact then holds the op)."""
    if not gene_stream.is_cuda and not torch.compiler.is_exporting():
        return fused_gene_modulator_plain(
            gene_stream, cre_intermediates, gene_len, cre_len, packed, slopes,
            scale, num_heads,
        )
    return gene_modulator_op(
        gene_stream, cre_intermediates, gene_len.to(torch.int32).contiguous(),
        cre_len.to(torch.int32).contiguous(), [packed[k] for k in PACKED], slopes,
        float(scale), int(num_heads),
    )


def _bwd1(ops, i, h, ckv, dnext, cre_len, packed, grads, dckv, scale, num_heads, t, g1):
    """Layer ``i``'s phase-1 backward from h_l (the Pallas ``_run_bwd1``):
    fills the FFN, norm3, cross-out, cross-Q and norm2 gradients and the
    layer's cross K|V cotangent dckv [D, C, 2E] (f32, summed over tissues);
    returns dh, the cotangent of h_l."""
    ea = packed["wcq"].shape[-1]
    bt = h.shape[0] // g1
    h2n = ops.layernorm(h, packed["norm2_scale"][i], packed["norm2_bias"][i])
    cq = ops.gemm(h2n, packed["wcq"][i], packed["bcq"][i]).view(bt, g1, ea)
    ck, cv = ckv[..., :ea], ckv[..., ea:]
    ca, lse, ca32 = ops.attention(cq, ck, cv, cre_len, None, scale, num_heads, kv_div=t,
                                  len_div=t, for_backward=True)
    ca2 = ca.view(-1, ea)
    h2 = ops.gemm(ca2, packed["wco"][i], packed["bco"][i], h)
    g = ops.layernorm(h2, packed["norm3_scale"][i], packed["norm3_bias"][i])
    f = ops.gemm(g, packed["wf1"][i], packed["bf1"][i])
    m = ops.geglu(f)
    # FFN-out, GeGLU, FFN-in, LN3
    ops.gemm_wgrad(m, dnext, out=grads["wf2"][i])
    grads["bf2"][i] = ops.colsum(dnext)
    df = ops.geglu_bwd(f, ops.gemm_dgrad(dnext, packed["wf2"][i]))
    ops.gemm_wgrad(g, df, out=grads["wf1"][i])
    grads["bf1"][i] = ops.colsum(df)
    dh2, grads["norm3_scale"][i], grads["norm3_bias"][i] = ops.layernorm_bwd(
        h2, ops.gemm_dgrad(df, packed["wf1"][i]), packed["norm3_scale"][i]
    )
    # h2 = cross-out(cross-attention) + h
    ops.gemm_wgrad(ca2, dh2, out=grads["wco"][i])
    grads["bco"][i] = ops.colsum(dh2)
    dca = ops.gemm_dgrad(dh2, packed["wco"][i]).view(bt, g1, ea)
    dcq, _, _ = ops.attention_bwd(
        cq, ck, cv, ca32, lse, dca, cre_len, None, scale, num_heads, kv_div=t, len_div=t,
        dk=dckv[..., :ea], dv=dckv[..., ea:],
    )
    dcq = dcq.view(-1, ea)
    ops.gemm_wgrad(h2n, dcq, out=grads["wcq"][i])
    grads["bcq"][i] = ops.colsum(dcq)
    # dh = dh2 + LN2 backward
    dh, grads["norm2_scale"][i], grads["norm2_bias"][i] = ops.layernorm_bwd(
        h, ops.gemm_dgrad(dcq, packed["wcq"][i]), packed["norm2_scale"][i], (dh2,)
    )
    if ops is kernels.KERNELS:
        kernels.LAUNCHES["fused_gene_modulator_bwd1"] += 1
    return dh


def _bwd0(ops, i, x, dh, dnext, gene_len, packed, grads, slopes, scale, num_heads, t, g1):
    """Layer ``i``'s phase-0 backward from x_l and dh (the Pallas
    ``_run_bwd0``): fills the QKV, out-proj and norm1 gradients; returns
    dx = dnext + dh + dLN1, the cotangent of x_l."""
    ea = packed["wqkv"].shape[-1] // 3
    bt = x.shape[0] // g1
    h1 = ops.layernorm(x, packed["norm1_scale"][i], packed["norm1_bias"][i])
    qkv = ops.gemm(h1, packed["wqkv"][i], packed["bqkv"][i]).view(bt, g1, 3 * ea)
    q, k, v = qkv[..., :ea], qkv[..., ea:2 * ea], qkv[..., 2 * ea:]
    sa, lse, sa32 = ops.attention(q, k, v, gene_len, slopes, scale, num_heads, len_div=t,
                                  for_backward=True)
    # h = out-proj(self-attention) + x, so d(out-proj) = dh
    ops.gemm_wgrad(sa.view(-1, ea), dh, out=grads["wo"][i])
    grads["bo"][i] = ops.colsum(dh)
    dsa = ops.gemm_dgrad(dh, packed["wo"][i]).view(bt, g1, ea)
    dqkv = torch.empty_like(qkv)
    ops.attention_bwd(
        q, k, v, sa32, lse, dsa, gene_len, slopes, scale, num_heads, len_div=t,
        dq=dqkv[..., :ea], dk=dqkv[..., ea:2 * ea], dv=dqkv[..., 2 * ea:],
    )
    dqkv = dqkv.view(-1, 3 * ea)
    ops.gemm_wgrad(h1, dqkv, out=grads["wqkv"][i])
    grads["bqkv"][i] = ops.colsum(dqkv)
    dx, grads["norm1_scale"][i], grads["norm1_bias"][i] = ops.layernorm_bwd(
        x, ops.gemm_dgrad(dqkv, packed["wqkv"][i]), packed["norm1_scale"][i], (dnext, dh)
    )
    if ops is kernels.KERNELS:
        kernels.LAUNCHES["fused_gene_modulator_bwd0"] += 1
    return dx


def fused_gene_modulator_bwd(dout, saves, cre_intermediates, gene_len, cre_len, packed,
                             slopes, scale, num_heads, ops=kernels.KERNELS):
    """Backward of the whole gene stack from the output cotangent dout
    [D, T, G1, E] and the forward's saves: returns (d gene_stream, d
    cre_intermediates, packed-layout f32 weight gradients incl. the cross
    ``wckv``/``bckv``). Pad gene rows and masked CRE slots get exactly 0."""
    d, t, g1, e = dout.shape
    grads = {k: torch.zeros(packed[k].shape, dtype=torch.float32, device=dout.device)
             for k in PACKED}
    dckv = torch.zeros((len(saves), *saves[0][2].shape), dtype=torch.float32,
                       device=dout.device)
    dnext = dout.reshape(d * t * g1, e).contiguous()
    for i in reversed(range(len(saves))):
        x, h, ckv = saves[i]
        dh = _bwd1(ops, i, h, ckv, dnext, cre_len, packed, grads, dckv[i], scale, num_heads,
                   t, g1)
        dnext = _bwd0(ops, i, x, dh, dnext, gene_len, packed, grads, slopes, scale,
                      num_heads, t, g1)
    # Cross K|V = cre @ wckv + bckv per (layer, donor): its cotangent gives
    # d(cre_intermediates) and the wkv gradients (XLA's side in the JAX package).
    d_cre = torch.matmul(dckv, packed["wckv"].float().transpose(1, 2)[:, None])
    grads["wckv"] = torch.einsum("ldce,ldcf->lef", cre_intermediates.float(), dckv)
    grads["bckv"] = dckv.sum(dim=(1, 2))
    return dnext.view(d, t, g1, e), d_cre.to(cre_intermediates.dtype), grads


def fused_gene_modulator_bwd_plain(dout, saves, cre_intermediates, gene_len, cre_len, packed,
                                   slopes, scale, num_heads):
    """``fused_gene_modulator_bwd`` on the plain versions of the kernels (the
    CPU's path, and the card's yardstick)."""
    return fused_gene_modulator_bwd(dout, saves, cre_intermediates, gene_len, cre_len, packed,
                                    slopes, scale, num_heads, ops=kernels.PLAIN)


def unpack_grads(grads: dict, num_heads: int, head_dim: int) -> list:
    """Packed-layout gradients -> one per ``LEAVES`` entry (models/init
    layout); the pad lanes' gradients are dropped."""
    out = dict(grads)
    for name, num in (("qkv", 3), ("ckv", 2), ("cq", 1)):
        out[f"w{name}"], out[f"b{name}"] = unpack_heads(grads[f"w{name}"], grads[f"b{name}"],
                                                        num_heads, head_dim, num=num)
    for name in ("wo", "wco"):
        out[name] = unpad_head_rows(grads[name], num_heads, head_dim)
    return [out[k] for k in PACKED]


def fused_gene_modulator_fwd_save(gene_stream, cre_intermediates, gene_len, cre_len, packed,
                                  slopes, scale, num_heads):
    """The checkpointing forward: (out [D, T, G1, E], saves), with saves a
    list of (x_l, h_l, cross K|V) per layer; on the card the kernel chain,
    on the CPU the chain of plain versions."""
    saves: list = []
    out = _chain(kernels.ops_for(gene_stream), gene_stream, cre_intermediates, gene_len,
                 cre_len, packed, slopes, scale, num_heads, saves)
    if gene_stream.is_cuda:
        kernels.LAUNCHES["fused_gene_modulator_fwd_save"] += 1
    return out, saves


class _GeneModulator(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gene_stream, cre_intermediates, gene_len, cre_len, slopes, scale,
                num_heads, *leaves):
        packed = pack_gene_layers(unflatten(LEAVES, leaves), num_heads, gene_stream.dtype)
        gene_len = gene_len.to(torch.int32).contiguous().clone()
        cre_len = cre_len.to(torch.int32).contiguous().clone()
        out, saves = fused_gene_modulator_fwd_save(
            gene_stream, cre_intermediates, gene_len, cre_len, packed, slopes, scale, num_heads
        )
        ctx.save_for_backward(cre_intermediates, gene_len, cre_len, slopes)
        ctx.packed, ctx.saves = packed, saves
        ctx.scale, ctx.num_heads = scale, num_heads
        ctx.head_dim = gene_stream.shape[-1] // num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        cre, gene_len, cre_len, slopes = ctx.saved_tensors
        bwd = fused_gene_modulator_bwd if dout.is_cuda else fused_gene_modulator_bwd_plain
        dx, d_cre, grads = bwd(dout, ctx.saves, cre, gene_len, cre_len, ctx.packed, slopes,
                               ctx.scale, ctx.num_heads)
        ctx.saves = ctx.packed = None
        leaf_grads = unpack_grads(grads, ctx.num_heads, ctx.head_dim)
        need = ctx.needs_input_grad
        return (
            dx if need[0] else None, d_cre if need[1] else None, None, None, None, None, None,
            *(g if need[7 + j] else None for j, g in enumerate(leaf_grads)),
        )


def fused_gene_modulator_diff(
    gene_stream: torch.Tensor,        # [D, T, G1, E]
    cre_intermediates: torch.Tensor,  # [num_layers, D, C, E]
    gene_len: torch.Tensor,           # [D]
    cre_len: torch.Tensor,            # [D]
    layers: dict,                     # stacked gene-layer params (models/init layout)
    slopes: torch.Tensor | None,
    scale: float,
    num_heads: int,
) -> torch.Tensor:
    """Differentiable whole gene stack: the final stream [D, T, G1, E] in the
    stream's dtype, with d(gene_stream), d(cre_intermediates) and f32
    d(layers) from the recompute backward. Packs the layers inline (once
    per call); keeps x_l and h_l of every layer until the backward."""
    leaves = [get_leaf(layers, p) for p in LEAVES]
    return _GeneModulator.apply(gene_stream, cre_intermediates, gene_len, cre_len, slopes,
                                scale, num_heads, *leaves)

"""The CRE stack's inference forward as a chain of the shared kernels.

The CRE stack runs once per donor at [D, C, E]: 24 context layers, each
ALiBi self-attention over the donor's CRE windows, cross-attention to their
cCRE-class embeddings and a GeGLU FFN whose residual adds the layer input
(``models/core.context_encoder_layer``), keeping the 25 intermediates the
gene layers cross-attend to. The JAX package runs it on XLA through
``lax.scan`` (``variantformer_tpu/models/seq2gene.py:336``), with no Pallas
kernel; the port's forward runs it as the loop ``core.cre_loop`` wherever
this op is not taken.

On the card inference runs each layer as thirteen launches of the kernels
of ``ops/kernels.py``:

  LN1 -> QKV (+ bias) -> ALiBi self-attention masked by cre_len -> out-proj
  (+ bias, + x) -> LN2 -> cross-Q (+ bias) -> cross K|V (+ bias) of the
  context rows -> cross-attention masked by cre_len -> out-proj (+ bias,
  + h) -> LN3 -> FFN-in (+ bias) -> GeGLU -> FFN-out (+ bias, + x).

It replaces about a hundred launches a layer of the loop: three LayerNorms
of ten ops each, six matmuls with separate bias and residual adds, and two
attentions that each write f32 scores [D, H, C, C] to memory and read them
back through a mask, a softmax and two casts. A chain is fewer launches, so
the card idles less while the host launches them, and its attention keeps
scores and softmax in registers, so no score tensor goes through memory. At
the main path's shapes (D x C = 1536 rows of E = 1536) the GEMMs hold most
of the work, so what bounds the chain is tensor-core throughput. Rounding
is the loop's: the GEMM epilogue rounds bf16(acc), then + bias, then +
residual, as ``core.linear`` and the residual sums do; softmax statistics
are f32 and P is rounded to bf16 before P·V, as in ``ops/attention.attend``.
The attention walks keys in chunks past its one-chunk limit, with ALiBi at
the absolute key index and suffix padding masked by cre_len, so any C runs.

The CRE layers have the gene layers' tree, so ``pack_gene_layers`` packs
them, once at load: QKV and cross K|V regrouped to slot-major columns, heads
padded to ``head_lanes`` (with the matching out-projection rows, which is
exact), norms in f32, the other leaves views of the raw ones.

Only inference takes the op (``models/seq2gene.routes`` and the forward
decide); training differentiates the loop. As ``vfx_torch::cre_stack`` the
chain is an op that ``torch.export`` carries (``api/serving.py``): its CUDA
kernel is the chain on the kernels, replayed as a CUDA graph
(``ops/graphs.py``), its CPU kernel the plain version ``cre_stack_plain``,
the same chain on the kernels' plain versions (``kernels.PLAIN``).
"""

from __future__ import annotations

from typing import Optional

import torch

from variantformer_tpu_torch.ops import graphs, kernels
from variantformer_tpu_torch.ops.fused_encoder import layer_step, require_kernel_lanes, unstack
from variantformer_tpu_torch.ops.fused_modulator import PACKED


def _layer(ops, rows, layer, ctx_rows, d, c, cre_len, slopes, scale, num_heads):
    """One context layer on ``ops``: its input rows [D*C, E] -> its output
    rows."""
    ea = layer["wqkv"].shape[-1] // 3  # attention width: heads x (padded) head dim
    h1 = ops.layernorm(rows, layer["norm1_scale"], layer["norm1_bias"])
    qkv = ops.gemm(h1, layer["wqkv"], layer["bqkv"]).view(d, c, 3 * ea)
    sa = ops.attention(qkv[..., :ea], qkv[..., ea:2 * ea], qkv[..., 2 * ea:],
                       cre_len, slopes, scale, num_heads)
    h = ops.gemm(sa.view(-1, ea), layer["wo"], layer["bo"], rows)
    h2n = ops.layernorm(h, layer["norm2_scale"], layer["norm2_bias"])
    cq = ops.gemm(h2n, layer["wcq"], layer["bcq"]).view(d, c, ea)
    ckv = ops.gemm(ctx_rows, layer["wckv"], layer["bckv"]).view(d, c, 2 * ea)
    ca = ops.attention(cq, ckv[..., :ea], ckv[..., ea:], cre_len, None, scale, num_heads)
    h2 = ops.gemm(ca.view(-1, ea), layer["wco"], layer["bco"], h)
    g = ops.layernorm(h2, layer["norm3_scale"], layer["norm3_bias"])
    f = ops.geglu(ops.gemm(g, layer["wf1"], layer["bf1"]))
    return ops.gemm(f, layer["wf2"], layer["bf2"], rows)


def _chain(ops, x, ctx, cre_len, packed, slopes, scale, num_heads):
    """The forward chain on ``ops``: x [D, C, E] the CRE stream, ctx [D, C, E]
    the context rows; returns the intermediates [L + 1, D, C, E] (x first)."""
    d, c, e = x.shape
    if ops is kernels.KERNELS:
        require_kernel_lanes(packed["wqkv"].shape[-1] // 3 // num_heads)
    rows = x.reshape(d * c, e).contiguous()
    ctx_rows = ctx.reshape(d * c, e).contiguous()
    steps = [rows]
    for layer in unstack(packed):
        rows = layer_step(ops, _layer, rows, layer, ctx_rows, d, c, cre_len, slopes, scale,
                          num_heads)
        steps.append(rows)
    return torch.stack(steps).view(len(steps), d, c, e)


def cre_stack_plain(x, ctx, cre_len, packed: dict, slopes, num_heads: int,
                    head_dim: int) -> torch.Tensor:
    """Plain PyTorch version: the chain on the kernels' plain versions
    (``kernels.PLAIN``), each layer checkpointed under autograd; the
    intermediates [L + 1, D, C, E] in x's dtype."""
    return _chain(kernels.PLAIN, x, ctx, cre_len, packed, slopes, head_dim ** -0.5, num_heads)


# The inference stack as a torch.library op, so that torch.export can carry
# it (api/serving.py): the packed dict goes in as a list in PACKED order.
@torch.library.custom_op("vfx_torch::cre_stack", mutates_args=(), device_types="cpu")
def cre_stack_op(x: torch.Tensor, ctx: torch.Tensor, cre_len: torch.Tensor,
                 packed: list[torch.Tensor], slopes: Optional[torch.Tensor], num_heads: int,
                 head_dim: int) -> torch.Tensor:
    with torch.no_grad():
        return cre_stack_plain(x, ctx, cre_len, dict(zip(PACKED, packed)), slopes, num_heads,
                               head_dim)


@cre_stack_op.register_kernel("cuda")
def _cre_stack_cuda(x, ctx, cre_len, packed, slopes, num_heads, head_dim):
    layers = dict(zip(PACKED, packed))
    chain = lambda x, ctx, cre_len, slopes: _chain(  # noqa: E731
        kernels.KERNELS, x, ctx, cre_len, layers, slopes, head_dim ** -0.5, num_heads)
    out = graphs.CACHE.run("cre_stack", chain, (x, ctx, cre_len, slopes), packed,
                           (num_heads, head_dim))
    kernels.LAUNCHES["cre_stack"] += 1
    return out


@cre_stack_op.register_fake
def _cre_stack_fake(x, ctx, cre_len, packed, slopes, num_heads, head_dim):
    return x.new_empty((packed[PACKED.index("wqkv")].shape[0] + 1, *x.shape))


def cre_stack(
    x: torch.Tensor,              # [D, C, E] the CRE stream
    ctx: torch.Tensor,            # [D, C, E] context_embedding[cre_labels]
    cre_len: torch.Tensor,        # [D] valid CRE windows
    packed: dict,                 # pack_gene_layers of the CRE layers
    slopes: torch.Tensor | None,  # [H] f32 ALiBi slopes, or None
    num_heads: int,
    head_dim: int,
) -> torch.Tensor:
    """The CRE stack's intermediates [L + 1, D, C, E] (bf16 on the card),
    through the op ``vfx_torch::cre_stack``: the kernel chain on CUDA
    tensors, ``cre_stack_plain`` on CPU ones (a ``torch.export`` trace on
    any device records the op)."""
    return cre_stack_op(x, ctx, cre_len.to(torch.int32).contiguous(),
                        [packed[k] for k in PACKED], slopes, int(num_heads), int(head_dim))

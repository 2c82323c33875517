"""Hierarchical CRE<->gene model ("seq2gene", combined-modulator semantics).

The port of ``variantformer_tpu/models/seq2gene.py``:

  gene_0   = gene_layer[0](gene_in,  kv=cre_in)
  cre_i    = cre_layer[i](cre_{i-1}, ctx=class_embedding)          i = 1..24
  gene_i   = gene_layer[i](gene_{i-1}, kv=cre_i)                   i = 1..24
  pooled   = gene_24[:, :, 0]   (multi-registry token)
  pred     = tissue_head(pooled)

``impl`` picks the routes as the JAX package's does: ``"fused2"`` (the
default) both whole stacks where the config allows them, ``"fused"`` the
whole-stack encoder and the layered gene stack, ``"xla"`` the layered
route throughout (the one tensor parallelism splits). Within a route the
config decides, by the JAX package's rules for its Pallas kernels:
  * the window encoder runs through the whole-stack wrapper
    (``ops/fused_encoder.py``) for the plain layer flavour with mean
    pooling, else as the plain layer loop (``seq2reg.encode_windows``: the
    context flavour, max pooling);
  * the gene stack runs through the whole-stack wrapper
    (``ops/fused_modulator.py``) unless its layers are cross-only
    (``only_cross_attention``), add the stack's input to every layer's
    output (``use_res``) or have a head dim above 64; those run the plain
    gene-layer loop (``_gene_layer``).
The wrappers' CUDA kernels run on the card and their plain versions (each
op's chain on the kernels' plain versions) on the CPU; the loops are plain
PyTorch on either. The CRE stack runs once per donor at [D, C, E], keeping
the 25 intermediates the gene layers cross-attend to: in inference on a
kernel route, as the op of ``ops/cre_stack.py``, otherwise (training,
``impl="xla"``, the plain forward, tensor parallelism) as the loop
``core.cre_loop`` (``_cre_chain`` decides). The maps, registry fan-out and
tissue heads are plain PyTorch. With ``seq2gene.remat`` each plain CRE and
gene layer is checkpointed under autograd.

This module owns the routes (``routes``: the rules above) and the packed
weights of the ops (slot-major QKV, heads padded to the kernels' lanes, f32
norms): ``pack_for_inference`` stores them beside the raw layers,
``without_packed`` strips them, ``packed_stack`` reads them (or packs per
call), and the forward refuses them beside layers it differentiates.

Variant-effect batches may carry window-dedup pools (each unique window
encoded once, then gathered per donor) and the variant's token positions
(the gene and CRE token embeddings are gathered from the final streams);
``return_streams`` returns those streams for the ref-once cache of
``api/variantprocessor.py``.

Under a mesh's window split (``parallel/mesh.py``, the tissue partition)
the batch carries this rank's shard of the CRE and gene window axes; the
window embeddings (and the CRE labels) are all-gathered over the split's
group in rank order before the CRE stack attends across windows.

Under a profiler the forward is the span ``seq2gene.forward``, its stages
the spans ``seq2gene.window_encoder`` (1), ``seq2gene.maps`` (2-3),
``seq2gene.cre_stack`` (4), ``seq2gene.gene_stack`` (5) and
``seq2gene.heads`` (6-7) (``utils/profiling.span``).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from variantformer_tpu_torch.config import ModelConfig
from variantformer_tpu_torch.device import compute_dtype as policy_dtype
from variantformer_tpu_torch.models import core
from variantformer_tpu_torch.models.core import AttnSpec, Params
from variantformer_tpu_torch.models.params import wants_grad
from variantformer_tpu_torch.models.seq2reg import (
    encode_windows,
    encode_windows_dual,
    whole_stack,
)
from variantformer_tpu_torch.ops.alibi import alibi_slopes
from variantformer_tpu_torch.ops.attention import attend
from variantformer_tpu_torch.ops.cre_stack import cre_stack
from variantformer_tpu_torch.ops.fused_encoder import pack_encoder_layers
from variantformer_tpu_torch.ops.fused_modulator import (
    fused_gene_modulator,
    fused_gene_modulator_diff,
    fused_gene_modulator_plain,
    pack_gene_layers,
)
from variantformer_tpu_torch.parallel import comm
from variantformer_tpu_torch.utils.profiling import span

IMPLS = ("xla", "fused", "fused2")


class Seq2GeneBatch(NamedTuple):
    """Static-shape batch (numpy leaves on the host, tensors on a device).
    All padding is suffix padding.

    D = donors (or ref/het/hom samples for VEP), C = CRE-window slots,
    G = gene-window slots, L = tokens per window, T = requested tissues.
    """

    cre_tokens: Any       # [D, C, L] int32
    cre_tok_len: Any      # [D, C] int32 valid tokens per window
    cre_count: Any        # [D] int32 valid CRE windows
    cre_labels: Any       # [D, C] int32 cCRE-class ids
    gene_tokens: Any      # [D, G, L] int32
    gene_tok_len: Any     # [D, G] int32
    gene_count: Any       # [D] int32 valid gene windows
    tissue_ids: Any       # [T] int32, shared across donors
    cre_token_position: Any = None   # [D] int32 (VEP): CRE window of the variant
    gene_token_position: Any = None  # [D] int32 (VEP): gene window of the variant
    # Window-dedup pools (VEP): ref/het/hom donors, and k batched variants on
    # the same gene, share all but a handful of windows, and window encoding
    # is strictly per-window, so encoding each UNIQUE window once and
    # gathering per donor is exact. All six fields set together; the plain
    # window axes above still carry the full per-donor layout (the gene
    # stack and the counts read them).
    cre_pool_tokens: Any = None   # [Uc, L] int32
    cre_pool_len: Any = None      # [Uc] int32
    cre_gather: Any = None        # [D, C] int32 -> pool row
    gene_pool_tokens: Any = None  # [Ug, Lg] int32
    gene_pool_len: Any = None     # [Ug] int32
    gene_gather: Any = None       # [D, G] int32 -> pool row


class Seq2GeneOutput(NamedTuple):
    pred_expression: torch.Tensor        # [D, T] f32
    pooled_embedding: torch.Tensor       # [D, T, E] f32
    gene_token_embedding: torch.Tensor   # [D, T, E] f32 (zeros without VEP positions)
    cre_token_embedding: torch.Tensor    # [D, T, E] f32 (zeros without VEP positions)
    # Final streams (compute dtype), only with return_streams=True: the VEP
    # ref-once cache gathers the ref's token embeddings from them on the
    # host for every later variant on the same (gene, population).
    gene_stream: torch.Tensor | None = None  # [D, T, G+1, E]
    cre_stream: torch.Tensor | None = None   # [D, C, E]


class WindowSplit(NamedTuple):
    """The batch's CRE and/or gene window axes hold this rank's shard of
    the windows split over ``group``."""

    group: Any
    cre: bool = True
    gene: bool = True


def cre_chain_fits(cfg: ModelConfig) -> bool:
    """Whether the CRE stack's heads fit the attention kernels (head dims up
    to 128, padded to their lanes by ``head_lanes``)."""
    return cfg.seq2gene.emb_dim // cfg.seq2gene.num_heads <= 128


def whole_gene_stack(cfg: ModelConfig) -> bool:
    """Whether the gene stack takes the whole-stack modulator (the JAX
    package's rule for its Pallas modulator): full self + cross layers, no
    stack residual, a head dim of at most 64."""
    mcfg = cfg.seq2gene
    return (not mcfg.only_cross_attention and not mcfg.use_res
            and mcfg.emb_dim // mcfg.num_heads <= 64)


class Routes(NamedTuple):
    """Which stacks take their whole-stack op of ``ops/`` (else a loop)."""

    encoder: bool  # both window encoders: vfx_torch::fused_window_encoder
    cre: bool      # the CRE stack, in inference only: vfx_torch::cre_stack
    gene: bool     # the gene stack: vfx_torch::fused_gene_modulator


def routes(cfg: ModelConfig, impl: str = "fused2") -> Routes:
    """The routes of a config under ``impl`` (module docstring); the forward
    adds each call's conditions: tensor parallelism, ``plain``, a gradient
    wanted."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return Routes(encoder=impl != "xla" and whole_stack(cfg.window_encoder),
                  cre=impl != "xla" and cre_chain_fits(cfg),
                  gene=impl == "fused2" and whole_gene_stack(cfg))


# A packed stack's key, in the dict of the raw layers it is packed from.
PACKED_KEYS = {"layers": "layers_packed", "cre_layers": "cre_layers_packed",
               "gene_layers": "gene_layers_packed"}
TOKENIZERS = ("cre_tokenizer", "gene_tokenizer")


def packed_stack(tree: Params, layers: str, cfg: ModelConfig) -> dict:
    """The packed form of ``tree[layers]`` (a tokenizer's ``"layers"``, or
    ``"cre_layers"``/``"gene_layers"`` of the root) in the compute dtype:
    the stack ``pack_for_inference`` stored beside it, else packed now."""
    stored = tree.get(PACKED_KEYS[layers])
    if stored is not None:
        return stored
    dt = policy_dtype(cfg.precision)
    if layers == "layers":
        return pack_encoder_layers(tree[layers], cfg.window_encoder.num_heads, dt)
    return pack_gene_layers(tree[layers], cfg.seq2gene.num_heads, dt)


def pack_for_inference(params: Params, cfg: ModelConfig, impl: str = "fused2") -> dict:
    """A new tree: ``params`` with each stack that ``routes(cfg, impl)``
    sends to an op packed once, where absent (repacking ~1.8 GB a forward
    at v4_pcg is what this avoids); the only writer of ``PACKED_KEYS``."""
    route = routes(cfg, impl)
    out = dict(params)

    def add(tree: Params, layers: str) -> Params:
        if PACKED_KEYS[layers] in tree:
            return tree
        return {**tree, PACKED_KEYS[layers]: packed_stack(tree, layers, cfg)}

    if route.encoder:
        for name in TOKENIZERS:
            out[name] = add(out[name], "layers")
    if route.cre:
        out = add(out, "cre_layers")
    if route.gene:
        out = add(out, "gene_layers")
    return out


def without_packed(params: Params) -> dict:
    """A new tree: ``params`` without its packed stacks; the only remover
    of ``PACKED_KEYS``."""
    keys = set(PACKED_KEYS.values())
    strip = lambda tree: {k: v for k, v in tree.items() if k not in keys}  # noqa: E731
    out = strip(params)
    for name in TOKENIZERS:
        out[name] = strip(out[name])
    return out


def _refuse_packed(tree: Params, layers: str, *inputs) -> None:
    """The packed stacks' one guard: a stack the call differentiates (its
    input or layers want a gradient) may have no pack beside it, which the
    ops would read in place of the layers the gradient is for."""
    key = PACKED_KEYS[layers]
    if key in tree and wants_grad(*inputs, tree[layers]):
        raise ValueError(f"params with {key!r} are for inference only (pack_for_inference); "
                         f"train on the raw tree (without_packed)")


def _cre_chain(params: Params, cre: torch.Tensor, ctx: torch.Tensor, route: Routes,
               plain: bool) -> bool:
    """Whether the CRE stack runs as the op ``vfx_torch::cre_stack`` (the
    kernel chain on the card, its plain version on the CPU): on its route
    (``routes``), without tensor parallelism, outside the plain forward,
    with no gradient wanted. Otherwise the loop of
    ``context_encoder_layer`` runs (training, ``impl="xla"``)."""
    return (route.cre and comm.active_tp() is None and not plain
            and not wants_grad(cre, ctx, params["cre_layers"]))


def _gene_cross_attention(
    p: Params,
    x: torch.Tensor,          # [D, T, Sq, E] gene queries
    ctx: torch.Tensor,        # [D, Sk, E] donor-shared CRE keys/values
    ctx_len: torch.Tensor,    # [D]
    spec: AttnSpec,
    compute_dtype,
) -> torch.Tensor:
    """Cross-attention with K/V projected once per donor and shared by its
    tissues (which fold into the query axis: no ALiBi on the cross side)."""
    d, t, sq, _ = x.shape
    heads = comm.local_heads(spec.num_heads)
    q = core.column_linear(p["wq"], x, compute_dtype).reshape(d, t * sq, heads, spec.head_dim)
    kv = core.column_linear(p["wkv"], ctx, compute_dtype)
    k, v = core.split_packed_heads(kv, 2, heads, spec.head_dim)
    out = attend(q, k, v, ctx_len, None, spec.scale).reshape(d, t, sq, -1)
    return core.row_linear(p["out"], out, compute_dtype)


def _gene_layer(
    p: Params,
    gene: torch.Tensor,       # [D, T, G1, E]
    cre: torch.Tensor,        # [D, C, E]
    gene_len: torch.Tensor,   # [D]
    cre_len: torch.Tensor,    # [D]
    slopes: torch.Tensor | None,
    only_cross: bool,
    spec: AttnSpec,
    compute_dtype,
) -> torch.Tensor:
    """One gene layer in plain PyTorch: ALiBi self-attention per (donor,
    tissue) (skipped when ``only_cross``), cross-attention to the donor's
    CRE stream, GeGLU with the res_long residual. A cross-only layer uses
    norm1 before the cross-attention and norm2 before the GeGLU."""
    d, t, g1, e = gene.shape
    if only_cross:
        h = gene
    else:
        flat = core.layer_norm(p["norm1"], gene).reshape(d * t, g1, e)
        sa = core.self_attention_block(
            p["mixer"], flat, gene_len.repeat_interleave(t), slopes, spec, compute_dtype,
        ).reshape(d, t, g1, e)
        h = sa + gene
    pre_cross, post = ("norm1", "norm2") if only_cross else ("norm2", "norm3")
    h2 = _gene_cross_attention(
        p["cross"], core.layer_norm(p[pre_cross], h), cre, cre_len, spec, compute_dtype,
    )
    h2 = h2 + h
    return core.geglu_ffn(p, core.layer_norm(p[post], h2), compute_dtype) + gene


def _gene_loop(params: Params, gene_stream, cre_intermediates, gene_len, cre_len, slopes,
               cfg: ModelConfig, spec: AttnSpec, dt) -> torch.Tensor:
    """The gene layers one by one in plain PyTorch (the JAX ``impl="xla"``
    path): the route of cross-only layers, ``use_res`` and head dims above
    64. With ``use_res`` every layer's output also adds the stack's input."""
    mcfg = cfg.seq2gene
    gene_res = gene_stream if mcfg.use_res else None
    layers = params["gene_layers"]

    def body(gs, layer_p, cre_kv):
        out = _gene_layer(layer_p, gs, cre_kv, gene_len, cre_len, slopes,
                          mcfg.only_cross_attention, spec, dt)
        return out if gene_res is None else out + gene_res

    for i in range(layers["norm1"]["scale"].shape[0]):
        gene_stream = core.maybe_remat(body, mcfg.remat, gene_stream,
                                       core.layer_slice(layers, i), cre_intermediates[i])
    return gene_stream


def _gene_stack(params: Params, gene_stream, cre_intermediates, gene_len, cre_len, slopes,
                cfg: ModelConfig, plain: bool) -> torch.Tensor:
    """The 25 gene layers through the whole-stack modulator: its plain
    version when ``plain``, the differentiable kernel chain (packing
    ``params["gene_layers"]`` inline) when a gradient is wanted, else the
    inference chain on the packed layers."""
    mcfg = cfg.seq2gene
    args = (gene_stream, cre_intermediates, gene_len, cre_len)
    scale = (mcfg.emb_dim // mcfg.num_heads) ** -0.5
    if not plain and wants_grad(gene_stream, cre_intermediates, params["gene_layers"]):
        return fused_gene_modulator_diff(*args, params["gene_layers"], slopes, scale,
                                         mcfg.num_heads)
    op = fused_gene_modulator_plain if plain else fused_gene_modulator
    return op(*args, packed_stack(params, "gene_layers", cfg), slopes, scale, mcfg.num_heads)


def _forward(params: Params, batch: Seq2GeneBatch, cfg: ModelConfig,
             plain: bool, return_streams: bool, impl: str = "fused2",
             window_split: WindowSplit | None = None) -> Seq2GeneOutput:
    with span("seq2gene.forward"):
        return _stages(params, batch, cfg, plain, return_streams, impl, window_split)


def _stages(params: Params, batch: Seq2GeneBatch, cfg: ModelConfig, plain: bool,
            return_streams: bool, impl: str,
            window_split: WindowSplit | None) -> Seq2GeneOutput:
    route = routes(cfg, impl)
    mcfg = cfg.seq2gene
    wcfg = cfg.window_encoder
    dt = policy_dtype(cfg.precision)
    if comm.active_tp() is not None and (route.encoder or route.gene):
        raise ValueError("tensor parallelism splits the layered route only (impl='xla')")

    d, c, l = batch.cre_tokens.shape
    g, lg = batch.gene_tokens.shape[1:]
    t = batch.tissue_ids.shape[0]
    e = mcfg.emb_dim
    enc_spec = AttnSpec(wcfg.num_heads, wcfg.embedding_dim // wcfg.num_heads)
    mod_spec = AttnSpec(mcfg.num_heads, mcfg.emb_dim // mcfg.num_heads)

    # === 1. Window encoding, both sets ===
    def encode(cre_tokens, cre_len, cre_labels, gene_tokens, gene_len):
        """Both window sets: the whole stack when the config takes it, else
        two layer loops (CRE windows read their labels, gene windows zeros)."""
        if route.encoder:
            return encode_windows_dual(
                params["cre_tokenizer"], cre_tokens, cre_len,
                params["gene_tokenizer"], gene_tokens, gene_len, wcfg, enc_spec, dt, plain=plain,
                packs=lambda tree: packed_stack(tree, "layers", cfg),
            )
        zeros = torch.zeros(gene_tokens.shape[0], dtype=torch.int32, device=gene_tokens.device)
        return (
            encode_windows(params["cre_tokenizer"], cre_tokens, cre_len, cre_labels, wcfg,
                           enc_spec, dt),
            encode_windows(params["gene_tokenizer"], gene_tokens, gene_len, zeros, wcfg,
                           enc_spec, dt),
        )

    with span("seq2gene.window_encoder"):
        for name in TOKENIZERS:
            _refuse_packed(params[name], "layers", params[name]["token_embedding"])
        if batch.cre_pool_tokens is not None:
            # Window-dedup pools (VEP): encode each unique window once, gather
            # per donor; exact, because window encoding never crosses windows.
            if wcfg.use_context:
                raise ValueError("window-dedup pools require the context-free encoder "
                                 "(per-window labels are not pooled)")
            no_labels = torch.zeros(batch.cre_pool_tokens.shape[0], dtype=torch.int32,
                                    device=batch.cre_pool_tokens.device)
            cre_pool, gene_pool = encode(batch.cre_pool_tokens, batch.cre_pool_len, no_labels,
                                         batch.gene_pool_tokens, batch.gene_pool_len)
            cre_emb = cre_pool[batch.cre_gather.long()]     # [D, C, E1]
            gene_emb = gene_pool[batch.gene_gather.long()]  # [D, G, E1]
        else:
            labels = batch.cre_labels  # global under a window split: this shard's
            if window_split is not None and window_split.cre:
                r = dist.get_rank(window_split.group)
                labels = labels[:, r * c:(r + 1) * c]
            cre_emb, gene_emb = encode(
                batch.cre_tokens.reshape(d * c, l), batch.cre_tok_len.reshape(d * c),
                labels.reshape(d * c),
                batch.gene_tokens.reshape(d * g, lg), batch.gene_tok_len.reshape(d * g),
            )
            cre_emb = cre_emb.reshape(d, c, -1)
            gene_emb = gene_emb.reshape(d, g, -1)
        if window_split is not None and batch.cre_pool_tokens is None:
            # Each rank encoded its shard of the windows: rebuild the window
            # axes in rank order (the counts stay global and mask the padding;
            # the pools' gathers are global, so their embeddings are whole).
            group = window_split.group
            if window_split.cre:
                cre_emb = comm.all_gather_cat(cre_emb, group, 1)
            if window_split.gene:
                gene_emb = comm.all_gather_cat(gene_emb, group, 1)
    g = gene_emb.shape[1]

    with span("seq2gene.maps"):
        # === 2. Map to modulator width ===
        cre = core.linear(params["cre_map"], cre_emb, dt)      # [D, C, E]
        gene = core.linear(params["gene_map"], gene_emb, dt)   # [D, G, E]

        # === 3. Registry token fan-out over tissues ===
        tissue_ids = batch.tissue_ids.long()
        registry = params["registry"][tissue_ids].to(dt)       # [T, E]
        gene_stream = torch.cat(
            [
                registry[None, :, None, :].expand(d, t, 1, e),
                gene[:, None, :, :].expand(d, t, g, e),
            ],
            dim=2,
        )  # [D, T, G+1, E]
        gene_len = batch.gene_count + 1  # registry token is always valid

        slopes = None
        if mcfg.use_alibi:
            slopes = torch.from_numpy(alibi_slopes(mcfg.num_heads)).to(gene.device)

    with span("seq2gene.cre_stack"):
        # === 4. CRE stack once per donor, keeping all 25 gene-layer inputs ===
        ctx_embedding = params["context_embedding"][batch.cre_labels.long()].to(dt)
        _refuse_packed(params, "cre_layers", cre, ctx_embedding)
        if _cre_chain(params, cre, ctx_embedding, route, plain):
            cre_intermediates = cre_stack(cre, ctx_embedding, batch.cre_count,
                                          packed_stack(params, "cre_layers", cfg), slopes,
                                          mcfg.num_heads, mod_spec.head_dim)
        else:
            cre_intermediates = core.cre_loop(params["cre_layers"], cre, ctx_embedding,
                                              batch.cre_count, slopes, mod_spec, dt, mcfg.remat)
        cre_final = cre_intermediates[-1]  # [D, C, E]; the intermediates [25, D, C, E]

    with span("seq2gene.gene_stack"):
        # === 5. Gene stack (gene layer i cross-attends to CRE intermediate i) ===
        _refuse_packed(params, "gene_layers", gene_stream, cre_intermediates)
        if route.gene:
            gene_stream = _gene_stack(
                params, gene_stream, cre_intermediates, gene_len, batch.cre_count, slopes, cfg,
                plain,
            ).to(dt)
        else:
            gene_stream = _gene_loop(params, gene_stream, cre_intermediates, gene_len,
                                     batch.cre_count, slopes, cfg, mod_spec, dt)

    with span("seq2gene.heads"):
        # === 6. Pool + tissue heads ===
        pooled = gene_stream[:, :, 0, :]  # [D, T, E] multi-registry pooling
        pred = tissue_expression_heads(params["tissue_heads"], pooled, tissue_ids, cfg, dt)

        # === 7. VEP token-position gathers ===
        donors = torch.arange(d, device=pooled.device)
        if batch.gene_token_position is not None:
            # The registry token shifts gene positions by one.
            pos = batch.gene_token_position.long() + 1
            gene_tok = gene_stream[donors, :, pos, :].float()           # [D, T, E]
        else:
            gene_tok = torch.zeros((d, t, e), dtype=torch.float32, device=pooled.device)
        if batch.cre_token_position is not None:
            # The output of the last CRE layer, the same for every tissue.
            cpos = batch.cre_token_position.long()
            cre_tok = cre_final[donors, cpos, :].float()[:, None, :].expand(d, t, e)
        else:
            cre_tok = torch.zeros((d, t, e), dtype=torch.float32, device=pooled.device)
        return Seq2GeneOutput(
            pred_expression=pred.float(),
            pooled_embedding=pooled.float(),
            gene_token_embedding=gene_tok,
            cre_token_embedding=cre_tok,
            gene_stream=gene_stream if return_streams else None,
            cre_stream=cre_final.to(dt) if return_streams else None,
        )


def seq2gene_forward(params: Params, batch: Seq2GeneBatch, cfg: ModelConfig,
                     impl: str = "fused2", window_group=None,
                     return_streams: bool = False) -> Seq2GeneOutput:
    """End-to-end forward: tokens -> per-(donor, tissue) expression.

    The batch's leaves are tensors on the parameters' device; on the card
    the window encoder and gene stack launch the CUDA kernels where the
    config routes them to the whole-stack wrappers, on the CPU those take
    their plain versions. Under autograd, with parameters that
    require grad, the two whole stacks take their differentiable forms
    (checkpointing forward, recompute backward); the CRE stack, maps,
    registry and heads get their gradients from autograd.

    ``return_streams`` adds the final gene and CRE streams (compute dtype)
    to the output. ``impl`` picks the routes (module docstring).

    ``window_group``: a process group over which the batch's CRE and gene
    WINDOW axes hold this rank's shard (the tissue partition of
    ``parallel/mesh.tissue_dp_forward``); the window embeddings are
    all-gathered over it after the encoder. The counts, labels and token
    positions stay GLOBAL in that layout: the layered encoder (context
    flavour, max pooling) reads this rank's slice of the CRE labels. (The
    JAX package takes the dual whole-stack encoder only, with equal CRE and
    gene token lengths: its forward reads the labels whole, and its Pallas
    encoder takes both sets in one launch. The port's takes each set in
    its own call, so bucketed CRE tokens go too.) ``impl="xla"`` splits
    windows through ``parallel/mesh.sharded_forward`` instead."""
    split = None
    if window_group is not None:
        if impl == "xla":
            raise ValueError(
                "window_gather_axes requires a kernel route (impl='fused'/'fused2'); "
                "impl='xla' splits windows through parallel/mesh.sharded_forward"
            )
        split = WindowSplit(window_group, cre=True, gene=True)
    return _forward(params, batch, cfg, plain=False, return_streams=return_streams,
                    impl=impl, window_split=split)


def seq2gene_forward_plain(params: Params, batch: Seq2GeneBatch, cfg: ModelConfig,
                           return_streams: bool = False) -> Seq2GeneOutput:
    """The same forward through the plain versions of both whole-stack
    kernels on any device (differentiable by autograd): the yardstick the
    kernels are held against on the card. Stages the config routes to the
    plain loops run as in ``seq2gene_forward``. Neither serving nor
    training calls it."""
    return _forward(params, batch, cfg, plain=True, return_streams=return_streams)


def tissue_expression_heads(
    p: Params,
    pooled: torch.Tensor,       # [D, T, E]
    tissue_ids: torch.Tensor,   # [T]
    cfg: ModelConfig,
    compute_dtype,
) -> torch.Tensor:
    """Per-tissue expression MLP (bigger-head variant), batched over [D, T]:
    Linear(E,E) -> LayerNorm -> GELU -> Linear(E,E) -> GELU -> Linear(E,1)
    -> Softplus."""
    mcfg = cfg.seq2gene
    if not mcfg.use_bigger_head or mcfg.head_type != "mlp":
        raise NotImplementedError("only the released bigger-head MLP is wired up")
    x = pooled.to(compute_dtype)
    # multi_head=False (released config): one shared head — the stacked-head
    # tree has a single entry every tissue gathers.
    tissue_ids = tissue_ids if mcfg.multi_head else torch.zeros_like(tissue_ids)
    w1 = p["w1"][tissue_ids].to(compute_dtype)   # [T, E, E]
    b1 = p["b1"][tissue_ids].to(compute_dtype)   # [T, E]
    h = torch.einsum("dte,tei->dti", x, w1) + b1
    ln = {"scale": p["ln_scale"][tissue_ids], "bias": p["ln_bias"][tissue_ids]}
    h = F.gelu(core.layer_norm(ln, h))
    w2 = p["w2"][tissue_ids].to(compute_dtype)
    b2 = p["b2"][tissue_ids].to(compute_dtype)
    h = F.gelu(torch.einsum("dte,tei->dti", h, w2) + b2)
    w3 = p["w3"][tissue_ids].to(compute_dtype)   # [T, E, 1]
    b3 = p["b3"][tissue_ids]                     # [T, 1]
    out = torch.einsum("dte,teo->dto", h.float(), w3.float()) + b3.to(compute_dtype).float()
    return F.softplus(out[..., 0])

"""Hierarchical CRE<->gene model ("seq2gene", combined-modulator semantics).

The port of ``variantformer_tpu/models/seq2gene.py``:

  gene_0   = gene_layer[0](gene_in,  kv=cre_in)
  cre_i    = cre_layer[i](cre_{i-1}, ctx=class_embedding)          i = 1..24
  gene_i   = gene_layer[i](gene_{i-1}, kv=cre_i)                   i = 1..24
  pooled   = gene_24[:, :, 0]   (multi-registry token)
  pred     = tissue_head(pooled)

The window encoder and the gene stack run through the whole-stack wrappers
(``ops/fused_encoder.py``, ``ops/fused_modulator.py``), whose CUDA kernels
run on the card and whose plain versions run on the CPU. The CRE stack runs
once per donor at [D, C, E] in plain PyTorch, keeping the 25 intermediates
the gene layers cross-attend to. The maps, registry fan-out and tissue
heads are plain PyTorch too.

Not ported yet (raise ``NotImplementedError``): only_cross_attention and
use_res gene layers, the context-flavour and max-pool window encoders, the
variant-effect position gathers, the window-dedup pools and return_streams.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from variantformer_tpu_torch.config import ModelConfig
from variantformer_tpu_torch.device import compute_dtype as policy_dtype
from variantformer_tpu_torch.models import core
from variantformer_tpu_torch.models.core import AttnSpec, Params
from variantformer_tpu_torch.models.params import wants_grad
from variantformer_tpu_torch.models.seq2reg import encode_windows_dual
from variantformer_tpu_torch.ops.alibi import alibi_slopes
from variantformer_tpu_torch.ops.fused_modulator import (
    fused_gene_modulator,
    fused_gene_modulator_diff,
    fused_gene_modulator_plain,
    pack_gene_layers,
)


class Seq2GeneBatch(NamedTuple):
    """Static-shape batch (numpy leaves on the host, tensors on a device).
    All padding is suffix padding.

    D = donors, C = CRE-window slots, G = gene-window slots, L = tokens per
    window, T = requested tissues.
    """

    cre_tokens: Any       # [D, C, L] int32
    cre_tok_len: Any      # [D, C] int32 valid tokens per window
    cre_count: Any        # [D] int32 valid CRE windows
    cre_labels: Any       # [D, C] int32 cCRE-class ids
    gene_tokens: Any      # [D, G, L] int32
    gene_tok_len: Any     # [D, G] int32
    gene_count: Any       # [D] int32 valid gene windows
    tissue_ids: Any       # [T] int32, shared across donors
    # Variant-effect fields of the JAX package's batch; not ported yet.
    cre_token_position: Any = None
    gene_token_position: Any = None
    cre_pool_tokens: Any = None
    cre_pool_len: Any = None
    cre_gather: Any = None
    gene_pool_tokens: Any = None
    gene_pool_len: Any = None
    gene_gather: Any = None


class Seq2GeneOutput(NamedTuple):
    pred_expression: torch.Tensor        # [D, T] f32
    pooled_embedding: torch.Tensor       # [D, T, E] f32
    gene_token_embedding: torch.Tensor   # [D, T, E] f32 (zeros: no VEP positions)
    cre_token_embedding: torch.Tensor    # [D, T, E] f32 (zeros: no VEP positions)


_VEP_FIELDS = (
    "cre_token_position", "gene_token_position", "cre_pool_tokens",
    "cre_pool_len", "cre_gather", "gene_pool_tokens", "gene_pool_len",
    "gene_gather",
)


def gene_packed(params: Params, cfg: ModelConfig) -> dict:
    """The packed gene stack: ``params["gene_layers_packed"]`` when packed at
    load (VCFProcessor.set_params), else packed now."""
    packed = params.get("gene_layers_packed")
    if packed is None:
        packed = pack_gene_layers(
            params["gene_layers"], cfg.seq2gene.num_heads, policy_dtype(cfg.precision)
        )
    return packed


def _gene_stack(params: Params, gene_stream, cre_intermediates, gene_len, cre_len, slopes,
                cfg: ModelConfig, plain: bool) -> torch.Tensor:
    """The 25 gene layers through the whole-stack modulator: its plain
    version when ``plain``, the differentiable kernel chain (packing
    ``params["gene_layers"]`` inline) when a gradient is wanted, else the
    inference chain on the packed layers."""
    mcfg = cfg.seq2gene
    args = (gene_stream, cre_intermediates, gene_len, cre_len)
    scale = (mcfg.emb_dim // mcfg.num_heads) ** -0.5
    if plain:
        return fused_gene_modulator_plain(*args, gene_packed(params, cfg), slopes, scale,
                                          mcfg.num_heads)
    if wants_grad(gene_stream, cre_intermediates, params["gene_layers"]):
        if "gene_layers_packed" in params:
            # Packed weights would shadow gene_layers on the forward and take
            # the gradient instead; training params carry the raw tree only.
            raise ValueError("training params must not contain 'gene_layers_packed'")
        return fused_gene_modulator_diff(*args, params["gene_layers"], slopes, scale,
                                         mcfg.num_heads)
    return fused_gene_modulator(*args, gene_packed(params, cfg), slopes, scale, mcfg.num_heads)


def _forward(params: Params, batch: Seq2GeneBatch, cfg: ModelConfig,
             plain: bool) -> Seq2GeneOutput:
    mcfg = cfg.seq2gene
    wcfg = cfg.window_encoder
    dt = policy_dtype(cfg.precision)
    if mcfg.only_cross_attention or mcfg.use_res:
        raise NotImplementedError("only_cross_attention / use_res gene layers are not ported yet")
    if any(getattr(batch, f) is not None for f in _VEP_FIELDS):
        raise NotImplementedError("VEP position gathers and dedup pools are not ported yet")

    d, c, l = batch.cre_tokens.shape
    g, lg = batch.gene_tokens.shape[1:]
    t = batch.tissue_ids.shape[0]
    e = mcfg.emb_dim
    enc_spec = AttnSpec(wcfg.num_heads, wcfg.embedding_dim // wcfg.num_heads)
    mod_spec = AttnSpec(mcfg.num_heads, mcfg.emb_dim // mcfg.num_heads)

    # === 1. Window encoding, both sets, whole stack ===
    cre_emb, gene_emb = encode_windows_dual(
        params["cre_tokenizer"],
        batch.cre_tokens.reshape(d * c, l), batch.cre_tok_len.reshape(d * c),
        params["gene_tokenizer"],
        batch.gene_tokens.reshape(d * g, lg), batch.gene_tok_len.reshape(d * g),
        wcfg, enc_spec, dt, plain=plain,
    )
    cre_emb = cre_emb.reshape(d, c, -1)
    gene_emb = gene_emb.reshape(d, g, -1)

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

    # === 4. CRE stack once per donor, keeping all 25 gene-layer inputs ===
    ctx_embedding = params["context_embedding"][batch.cre_labels.long()].to(dt)
    steps = [cre]
    x = cre
    cre_layers = params["cre_layers"]
    for i in range(cre_layers["norm1"]["scale"].shape[0]):
        x = core.context_encoder_layer(
            core.layer_slice(cre_layers, i), x, ctx_embedding,
            batch.cre_count, batch.cre_count, slopes, mod_spec, dt,
        )
        steps.append(x)
    cre_intermediates = torch.stack(steps)  # [25, D, C, E]

    # === 5. Gene stack (gene layer i cross-attends to CRE intermediate i) ===
    gene_stream = _gene_stack(
        params, gene_stream, cre_intermediates, gene_len, batch.cre_count, slopes, cfg, plain,
    ).to(dt)

    # === 6. Pool + tissue heads ===
    pooled = gene_stream[:, :, 0, :]  # [D, T, E] multi-registry pooling
    pred = tissue_expression_heads(params["tissue_heads"], pooled, tissue_ids, cfg, dt)
    zeros = torch.zeros((d, t, e), dtype=torch.float32, device=pooled.device)
    return Seq2GeneOutput(
        pred_expression=pred.float(),
        pooled_embedding=pooled.float(),
        gene_token_embedding=zeros,
        cre_token_embedding=zeros.clone(),
    )


def seq2gene_forward(params: Params, batch: Seq2GeneBatch, cfg: ModelConfig) -> Seq2GeneOutput:
    """End-to-end forward: tokens -> per-(donor, tissue) expression.

    The batch's leaves are tensors on the parameters' device; on the card
    the window encoder and gene stack launch the CUDA kernels, on the CPU
    they take their plain versions. Under autograd, with parameters that
    require grad, the two whole stacks take their differentiable forms
    (checkpointing forward, recompute backward); the CRE stack, maps,
    registry and heads get their gradients from autograd."""
    return _forward(params, batch, cfg, plain=False)


def seq2gene_forward_plain(params: Params, batch: Seq2GeneBatch, cfg: ModelConfig) -> Seq2GeneOutput:
    """The same forward through the plain versions of both whole-stack
    kernels on any device (differentiable by autograd): the yardstick the
    kernels are held against on the card. Neither serving nor training
    calls it."""
    return _forward(params, batch, cfg, plain=True)


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

"""Window encoder ("seq2reg"): transformer over 200-token BPE windows.

The port of ``variantformer_tpu/models/seq2reg.py``: each CRE or gene window
of up to 200 BPE tokens is encoded and pooled into one 512-d embedding, and
``classify_windows`` puts the per-tissue cCRE-class heads on top (seq2reg
training).

Two routes, as in the JAX package:
  * ``encode_windows_dual``: the whole-stack encoder (``ops/fused_encoder``;
    on the card the CUDA kernel chain), for the plain layer flavour
    (``use_context=False``, the released tokenizers) with mean pooling;
  * ``encode_windows``: the layer loop in plain PyTorch (the JAX
    ``impl="xla"`` path), for every flavour. The context flavour
    cross-attends to a per-window cCRE-class embedding that is the same at
    every key, so its cross-attention is, in closed form,
    ``out_proj(v_proj(ctx_vec))``: softmax weights over identical keys sum
    to one. Pooling is the mean or the max over the valid tokens.
"""

from __future__ import annotations

import numpy as np
import torch

from variantformer_tpu_torch.config import WindowEncoderConfig
from variantformer_tpu_torch.models import core
from variantformer_tpu_torch.models.core import AttnSpec, Params
from variantformer_tpu_torch.models.params import wants_grad
from variantformer_tpu_torch.ops import kernels
from variantformer_tpu_torch.ops.alibi import alibi_slopes
from variantformer_tpu_torch.ops.fused_encoder import (
    fused_window_encoder,
    fused_window_encoder_diff,
    fused_window_encoder_plain,
    pack_encoder_layers,
)
from variantformer_tpu_torch.parallel import comm


def sinusoidal_position_encoding(d_model: int, length: int) -> np.ndarray:
    """Standard 1d sin/cos table."""
    position = np.arange(length, dtype=np.float32)[:, None]
    div_term = np.exp(
        np.arange(0, d_model, 2, dtype=np.float32) * -(np.log(10000.0) / d_model)
    )
    pe = np.zeros((length, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


def whole_stack(cfg: WindowEncoderConfig) -> bool:
    """Whether the windows take the whole-stack encoder (the JAX package's
    rule for its Pallas encoder): the plain layer flavour, mean pooling."""
    return not cfg.use_context and cfg.seq_pool == "mean"


def _embed(params: Params, tokens: torch.Tensor, cfg: WindowEncoderConfig,
           compute_dtype) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Token embeddings [N, L, E] (+ sinusoidal PE) and the ALiBi slopes."""
    x = params["token_embedding"][tokens.long()].to(compute_dtype)
    if cfg.positional_encoding == "alibi":
        return x, torch.from_numpy(alibi_slopes(cfg.num_heads)).to(x.device)
    pe = torch.from_numpy(sinusoidal_position_encoding(cfg.embedding_dim, tokens.shape[1]))
    return x + pe.to(x.device, compute_dtype), None


def _constant_context_bias(cross_p: Params, ctx_vec: torch.Tensor, spec: AttnSpec,
                           compute_dtype) -> torch.Tensor:
    """Cross-attention against keys and values that all equal ``ctx_vec``
    [N, E], in closed form: the output is ``out_proj(v_proj(ctx_vec))`` for
    every query. Returns [N, E]."""
    kv = core.column_linear(cross_p["wkv"], ctx_vec, compute_dtype)  # [N, H*2*D]
    _, v = core.split_packed_heads(kv, 2, comm.local_heads(spec.num_heads), spec.head_dim)
    v = v.reshape(*v.shape[:-2], -1)
    return core.row_linear(cross_p["out"], v, compute_dtype)


def _pool(x: torch.Tensor, tok_len: torch.Tensor, seq_pool: str) -> torch.Tensor:
    """Mean or max over each window's valid tokens, in f32; returned in x's
    dtype."""
    if seq_pool == "mean":
        return kernels.masked_mean_pool_plain(x, tok_len)
    if seq_pool == "max":
        valid = torch.arange(x.shape[1], device=x.device)[None, :] < tok_len[:, None]
        masked = torch.where(valid[:, :, None], x.float(), -torch.inf)
        return masked.amax(dim=1).to(x.dtype)
    raise NotImplementedError(f"seq_pool={seq_pool}")


def encode_windows(
    params: Params,
    tokens: torch.Tensor,       # [N, L] int BPE ids (suffix-padded)
    tok_len: torch.Tensor,      # [N] int valid token counts
    context: torch.Tensor,      # [N] int cCRE-class ids (zeros for gene windows)
    cfg: WindowEncoderConfig,
    spec: AttnSpec,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Embed + encode + pool each window, layer by layer in plain PyTorch
    (the JAX ``impl="xla"`` path). ``context`` is read by the context
    flavour only. Returns [N, E] (compute dtype)."""
    x, slopes = _embed(params, tokens, cfg, compute_dtype)
    layers = params["layers"]
    if cfg.use_context:
        # Ids past the table read its last row, as the JAX package's gather
        # clamps them: ``Seq2RegShardWriter`` writes each window's reference
        # class in the 11-class space, the table has 9 rows.
        table = params["context_embedding"]
        ctx_vec = table[context.long().clamp(max=table.shape[0] - 1)].to(compute_dtype)
    for i in range(layers["norm1"]["scale"].shape[0]):
        p = core.layer_slice(layers, i)
        if not cfg.use_context:
            x = core.self_only_encoder_layer(p, x, tok_len, slopes, spec, compute_dtype)
            continue
        # norm2 would normalise the cross-attention's queries, which the
        # closed form does not read: it is elided.
        h = core.self_attention_block(
            p["mixer"], core.layer_norm(p["norm1"], x), tok_len, slopes, spec, compute_dtype,
        )
        h = h + x
        h2 = _constant_context_bias(p["cross"], ctx_vec, spec, compute_dtype)[:, None, :] + h
        x = core.geglu_ffn(p, core.layer_norm(p["norm3"], h2), compute_dtype) + x
    return _pool(x, tok_len, cfg.seq_pool)


def classify_windows(
    params: Params,
    embeddings: torch.Tensor,   # [N, E] pooled window embeddings
    tissue_ids: torch.Tensor,   # [N] int
) -> torch.Tensor:
    """Per-tissue linear cCRE-class heads, one gather + batched product:
    [N, C] f32 logits."""
    tissue_ids = tissue_ids.long()
    w = params["tissue_classifiers"]["w"][tissue_ids]  # [N, E, C]
    b = params["tissue_classifiers"]["b"][tissue_ids]  # [N, C]
    return torch.einsum("ne,nec->nc", embeddings.float(), w.float()) + b


def encoder_packed(params: Params, cfg: WindowEncoderConfig, compute_dtype) -> dict:
    """The tokenizer's packed layer stack: ``params["layers_packed"]`` when
    packed at load (VCFProcessor.set_params), else packed now."""
    packed = params.get("layers_packed")
    if packed is None:
        packed = pack_encoder_layers(params["layers"], cfg.num_heads, compute_dtype)
    return packed


def encode_windows_dual(
    params_a: Params,
    tokens_a: torch.Tensor,     # [Na, La] int
    tok_len_a: torch.Tensor,    # [Na] int
    params_b: Params,
    tokens_b: torch.Tensor,     # [Nb, Lb] int
    tok_len_b: torch.Tensor,    # [Nb] int
    cfg: WindowEncoderConfig,
    spec: AttnSpec,
    compute_dtype=torch.bfloat16,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Encode two window sets with different weights (the CRE and gene
    tokenizers) through the whole-stack encoder, one call per set (their
    token lengths may differ). Returns ([Na, E], [Nb, E]). Only for the
    configs ``whole_stack`` takes; callers send the others to two
    ``encode_windows`` calls.

    Each set takes the differentiable kernel chain when a gradient is
    wanted from it (its token embedding or layers require grad), else the
    inference chain; ``plain`` takes the plain version instead (the
    yardstick, differentiable by autograd)."""
    if not whole_stack(cfg):
        raise ValueError("encode_windows_dual takes the plain layer flavour with mean "
                         "pooling; use two encode_windows calls")
    x_a, slopes = _embed(params_a, tokens_a, cfg, compute_dtype)
    x_b, _ = _embed(params_b, tokens_b, cfg, compute_dtype)
    return (
        _encode_stack(params_a, x_a, tok_len_a, cfg, slopes, spec.scale, compute_dtype, plain),
        _encode_stack(params_b, x_b, tok_len_b, cfg, slopes, spec.scale, compute_dtype, plain),
    )


def _encode_stack(params, x, tok_len, cfg, slopes, scale, compute_dtype, plain):
    tok_len = tok_len.to(torch.int32)
    if plain:
        packed = encoder_packed(params, cfg, compute_dtype)
        return fused_window_encoder_plain(x, tok_len, packed, slopes, scale, cfg.num_heads)
    if wants_grad(x, params["layers"]):
        if "layers_packed" in params:
            # Packed weights would shadow the layers the gradient is for.
            raise ValueError("training params must not contain 'layers_packed'")
        return fused_window_encoder_diff(x, tok_len, params["layers"], slopes, scale,
                                         cfg.num_heads)
    packed = encoder_packed(params, cfg, compute_dtype)
    return fused_window_encoder(x, tok_len, packed, slopes, scale, cfg.num_heads)

"""Window encoder ("seq2reg"): transformer over 200-token BPE windows.

The port of ``variantformer_tpu/models/seq2reg.py``: each CRE or gene window
of up to 200 BPE tokens is encoded and mean-pooled into one 512-d embedding.
Only the plain layer flavour (``use_context=False``, the released tokenizer
checkpoints) with mean pooling is ported; the context flavour and max
pooling raise ``NotImplementedError``.
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


def _check_ported(cfg: WindowEncoderConfig) -> None:
    if cfg.use_context:
        raise NotImplementedError("context-flavour window encoder is not ported yet")
    if cfg.seq_pool != "mean":
        raise NotImplementedError(f"seq_pool={cfg.seq_pool!r} is not ported yet")


def _embed(params: Params, tokens: torch.Tensor, cfg: WindowEncoderConfig,
           compute_dtype) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Token embeddings [N, L, E] (+ sinusoidal PE) and the ALiBi slopes."""
    x = params["token_embedding"][tokens.long()].to(compute_dtype)
    if cfg.positional_encoding == "alibi":
        return x, torch.from_numpy(alibi_slopes(cfg.num_heads)).to(x.device)
    pe = torch.from_numpy(sinusoidal_position_encoding(cfg.embedding_dim, tokens.shape[1]))
    return x + pe.to(x.device, compute_dtype), None


def encode_windows(
    params: Params,
    tokens: torch.Tensor,       # [N, L] int BPE ids (suffix-padded)
    tok_len: torch.Tensor,      # [N] int valid token counts
    cfg: WindowEncoderConfig,
    spec: AttnSpec,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Embed + encode + mean-pool each window, layer by layer in plain
    PyTorch (the JAX ``impl="xla"`` path). Returns [N, E] (compute dtype)."""
    _check_ported(cfg)
    x, slopes = _embed(params, tokens, cfg, compute_dtype)
    layers = params["layers"]
    for i in range(layers["norm1"]["scale"].shape[0]):
        p = core.layer_slice(layers, i)
        h = core.self_attention_block(
            p["mixer"], core.layer_norm(p["norm1"], x), tok_len, slopes, spec,
            compute_dtype,
        )
        h = h + x
        x = core.geglu_ffn(p, core.layer_norm(p["norm2"], h), compute_dtype) + x
    return kernels.masked_mean_pool_plain(x, tok_len)


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
    token lengths may differ). Returns ([Na, E], [Nb, E]).

    Each set takes the differentiable kernel chain when a gradient is
    wanted from it (its token embedding or layers require grad), else the
    inference chain; ``plain`` takes the plain version instead (the
    yardstick, differentiable by autograd)."""
    _check_ported(cfg)
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

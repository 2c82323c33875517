"""Batched masked attention with optional symmetric ALiBi bias (plain PyTorch).

The port of ``variantformer_tpu/ops/attention.py`` and the plain version of
the CUDA attention kernel (``ops/kernels.attention``):

  * softmax scale = 1/sqrt(head_dim) over the *true* head dim,
  * ALiBi bias = -slope_h * |i - j| over within-sequence positions,
  * padding is suffix-only, so a per-sample valid-key count fully describes
    the mask; masked scores take the FINITE ``MASK_VALUE``, so a row with no
    valid key averages V uniformly instead of turning into NaN.

Rows beyond a sample's query length compute garbage; callers never read them.
"""

from __future__ import annotations

import torch

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def attend(
    q: torch.Tensor,                # [B, Sq, H, D]
    k: torch.Tensor,                # [B, Sk, H, D]
    v: torch.Tensor,                # [B, Sk, H, D]
    kv_len: torch.Tensor | None,    # [B] int, number of valid (prefix) keys
    slopes: torch.Tensor | None,    # [H] f32 ALiBi slopes, or None
    scale: float,
    for_backward: bool = False,
):
    """Softmax statistics in f32; P is rounded to V's dtype before P @ V,
    which accumulates in f32. Returns [B, Sq, H, D] in q's dtype; with
    ``for_backward`` also what the backward reads: each row's f32
    log-sum-exp of its masked scores [B, H, Sq], and the f32 output with
    the rounded weights renormalised to sum to 1 [B, Sq, H, D] (an exact
    average of V, whose rowsum(dO * O) the backward subtracts from dP)."""
    scores = masked_scores(q, k, kv_len, slopes, scale)
    weights = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v.float())
    if for_backward:
        total = weights.sum(-1).transpose(1, 2)[..., None]   # [B, Sq, H, 1]
        return out.to(q.dtype), torch.logsumexp(scores, dim=-1), out / total
    return out.to(q.dtype)


def masked_scores(q, k, kv_len, slopes, scale) -> torch.Tensor:
    """f32 scores [B, H, Sq, Sk]: q.k * scale - slope * |i - j|, MASK_VALUE
    at keys at or past kv_len."""
    sq, sk = q.shape[1], k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if slopes is not None:
        pos_q = torch.arange(sq, device=q.device, dtype=torch.float32)[:, None]
        pos_k = torch.arange(sk, device=q.device, dtype=torch.float32)[None, :]
        dist = (pos_q - pos_k).abs()
        scores = scores - slopes.float()[None, :, None, None] * dist
    if kv_len is not None:
        key_valid = torch.arange(sk, device=q.device)[None, :] < kv_len[:, None]
        scores = torch.where(key_valid[:, None, None, :], scores, MASK_VALUE)
    return scores

"""Training losses on tensors: a copy of ``variantformer_tpu/train/losses.py``.

  * poisson_nll: torch.nn.PoissonNLLLoss(log_input=False, full=True)
    semantics — input - target*log(input) plus the Stirling approximation
    term for target > 1,
  * focal loss, weighted cross-entropy with per-class weights,
  * dual contrastive loss over normalized embeddings with a learnable
    temperature.
"""

from __future__ import annotations

import math

import torch


def poisson_nll(pred: torch.Tensor, target: torch.Tensor, full: bool = True,
                eps: float = 1e-8) -> torch.Tensor:
    """Elementwise Poisson NLL with log_input=False."""
    loss = pred - target * torch.log(pred + eps)
    if full:
        stirling = target * torch.log(target) - target + 0.5 * torch.log(2 * math.pi * target)
        loss = loss + torch.where(target > 1, stirling, 0.0)
    return loss


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.square(pred - target)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, class_weight=None) -> torch.Tensor:
    """Elementwise CE over [N, C] logits; optional per-class weights."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[:, None])[:, 0]
    if class_weight is not None:
        nll = nll * torch.as_tensor(class_weight, dtype=nll.dtype, device=nll.device)[labels.long()]
    return nll


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 0.0) -> torch.Tensor:
    logpt = torch.log_softmax(logits, dim=-1).gather(-1, labels.long()[:, None])[:, 0]
    return -((1.0 - logpt.exp()) ** gamma) * logpt


def dual_contrastive_loss(embeddings: torch.Tensor,
                          logit_scale: torch.Tensor | None = None) -> torch.Tensor:
    """Symmetric InfoNCE over in-batch normalized embeddings: the mean of
    the row and column cross-entropy sums."""
    emb = embeddings.reshape(embeddings.shape[0], -1)
    emb = emb / torch.linalg.norm(emb, dim=1, keepdim=True).clamp(min=1e-12)
    adj = emb @ emb.T
    if logit_scale is not None:
        adj = adj * torch.exp(logit_scale)
    labels = torch.arange(adj.shape[0], device=adj.device)
    return (cross_entropy(adj, labels).sum() + cross_entropy(adj.T, labels).sum()) / 2.0


def get_classification_loss(loss_type: str, gamma: float = 0.0, class_weight=None):
    if loss_type == "cross_entropy":
        return lambda logits, labels: cross_entropy(logits, labels)
    if loss_type == "weighted_cross_entropy":
        cw = torch.as_tensor(class_weight, dtype=torch.float32)
        return lambda logits, labels: cross_entropy(logits, labels, cw)
    if loss_type == "focal":
        return lambda logits, labels: focal_loss(logits, labels, gamma)
    raise ValueError(f"unknown loss {loss_type}")

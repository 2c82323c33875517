"""The mesh's collectives, and the Megatron pair of autograd Functions that
carries head/FFN tensor parallelism through the layered route.

Every collective of the port goes through this module and is one of
``COLLECTIVES``. Two ranks on one card can only talk over gloo (NCCL refuses
two ranks on one device), and gloo takes each of these on CUDA tensors in
the PyTorch the card runs (2.11), so no collective is staged through host
copies: ``chip_smoke.py`` probes each on CUDA tensors over gloo and fails
if one is refused.

Tensor parallelism (``tensor_parallel``): a column-split projection's input
passes ``copy_to_tp`` (identity forward, all-reduce of the gradient over the
model group backward) and a row-split projection's partial product passes
``reduce_from_tp`` (all-reduce forward, identity backward), as Megatron-LM
does; ``models/core.py`` calls both, and they are the identity when no
tensor-parallel group is active.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

# The torch.distributed collectives the port calls.
COLLECTIVES = ("all_reduce", "all_gather", "broadcast", "barrier")


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along ``dim`` in the
    group's rank order."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def reduce_gradients(tensors: list, loss_sum: torch.Tensor, count: torch.Tensor | None,
                     group) -> torch.Tensor:
    """Data-parallel gradient reduction in a fixed order: the gradients of
    the ``tensors`` that require one (zeros where none reached them, as
    under ``jax.grad``), the loss sum and the count go into ONE flat f32
    bucket in that order, which is all-reduced over ``group``; each
    gradient becomes its sum divided by ``max(count, 1)`` (by 1 without a
    count). Returns the reduced loss: the sum over the count. One bucket,
    never per-leaf hooks, so the reduction order and the bits stay the same
    run after run."""
    ts = [t for t in tensors if t.requires_grad]
    grads = [torch.zeros_like(t) if t.grad is None else t.grad for t in ts]
    tail = [loss_sum.detach().reshape(1).float()]
    if count is not None:
        tail.append(count.detach().reshape(1).float())
    flat = torch.cat([g.reshape(-1).float() for g in grads] + tail)
    all_reduce(flat, group)
    denom = flat[-1].clamp(min=1.0) if count is not None else None
    off = 0
    for t, g in zip(ts, grads):
        n = g.numel()
        part = flat[off:off + n]
        t.grad = (part if denom is None else part / denom).view_as(g).to(g.dtype)
        off += n
    total = flat[off]
    return total if denom is None else total / denom


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """``t`` from global rank ``src`` to every rank of ``group``, in place."""
    dist.broadcast(t, src, group=group)
    return t


# -- tensor parallelism ------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """The active model group: this rank's index in it and its size."""

    group: object
    rank: int
    size: int


_TP: TPGroup | None = None


@contextlib.contextmanager
def tensor_parallel(group):
    """Run the layered route with its heads and FFN columns split over
    ``group`` (the mesh's model group); ``None`` or a group of one leaves
    the route unsplit."""
    global _TP
    prev = _TP
    size = 1 if group is None else dist.get_world_size(group)
    _TP = None if size == 1 else TPGroup(group, dist.get_rank(group), size)
    try:
        yield
    finally:
        _TP = prev


def active_tp() -> TPGroup | None:
    return _TP


def local_heads(num_heads: int) -> int:
    """The heads of this rank under tensor parallelism (all of them
    without it). Raises when the model group does not divide them."""
    tp = _TP
    if tp is None:
        return num_heads
    if num_heads % tp.size:
        raise ValueError(f"{num_heads} heads do not split over a model axis of {tp.size}")
    return num_heads // tp.size


def local_slopes(slopes: torch.Tensor | None) -> torch.Tensor | None:
    """The ALiBi slopes of this rank's heads (a contiguous run of heads)."""
    tp = _TP
    if tp is None or slopes is None:
        return slopes
    n = local_heads(slopes.shape[0])
    return slopes[tp.rank * n:(tp.rank + 1) * n]


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor) -> torch.Tensor:
    """The input of a column-split projection: identity forward, its
    gradient summed over the model group backward."""
    tp = _TP
    if tp is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor) -> torch.Tensor:
    """A row-split projection's partial product summed over the model
    group (identity backward)."""
    tp = _TP
    if tp is None:
        return x
    return _ReduceFromTP.apply(x, tp.group)

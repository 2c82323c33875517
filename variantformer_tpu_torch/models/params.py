"""The weight bridge: a parameter tree of numpy arrays <-> the port's tensors.

The JAX package's trees (``jax.tree.map(np.asarray, init_seq2gene(...))``)
and the port's (``models/init.init_seq2gene``) have the same nesting, names
and shapes: linear weights are ``[in, out]`` and packed QKV is head-major
``(H, 3, D)`` (``variantformer_tpu/models/core.py``). ``to_tensors`` moves
the leaves, unchanged, onto a device; ``to_numpy`` brings a tree of tensors
(parameters, or their gradients) back as float32 numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch


def to_tensors(tree, device: str | torch.device, dtype: torch.dtype | None = None):
    """Copy every leaf (numpy array or tensor) of a nested dict to ``device``.

    Floating leaves are cast to ``dtype`` when it is given; integer leaves
    keep their type."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, device, dtype) for k, v in tree.items()}
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(np.array(tree))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_numpy(tree):
    """The inverse of ``to_tensors``: every tensor leaf as a host numpy array
    (floating leaves as float32; ``None`` leaves, e.g. missing gradients,
    stay ``None``)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if tree is None:
        return None
    t = tree.detach().cpu()
    return (t.float() if t.is_floating_point() else t).numpy()


def map_tree(fn, tree):
    """``fn`` applied to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves(tree) -> list:
    """The leaves of a nested dict, depth first in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    return [tree]


def wants_grad(*trees) -> bool:
    """True when autograd is on and some tensor leaf of ``trees`` requires a
    gradient: the condition for a whole-stack wrapper to take its
    differentiable form."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for tree in trees for t in leaves(tree)
    )

"""The weight bridge: a parameter tree of numpy arrays -> the port's tensors.

The JAX package's trees (``jax.tree.map(np.asarray, init_seq2gene(...))``)
and the port's (``models/init.init_seq2gene``) have the same nesting, names
and shapes: linear weights are ``[in, out]`` and packed QKV is head-major
``(H, 3, D)`` (``variantformer_tpu/models/core.py``). This module moves the
leaves, unchanged, onto a device.
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


"""Shared helpers of the tests that hold the PyTorch port against the JAX package.

Inputs are made once with numpy and handed to both packages; parameters are
made by the JAX package's ``init_*`` and brought across with the port's
weight bridge (``variantformer_tpu_torch.models.params.to_tensors``).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from variantformer_tpu_torch import config as tconfig
from variantformer_tpu_torch.models.params import to_tensors

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def port_config(cfg):
    """The port's ModelConfig (or sub-config) with the same field values as a
    JAX-package config."""
    cls = getattr(tconfig, type(cfg).__name__)
    return tconfig._update(cls(), dataclasses.asdict(cfg))


def port_params(jax_tree, dtype=None):
    """A JAX parameter tree as the port's CPU tensors (through numpy)."""
    return to_tensors(jax.tree.map(np.asarray, jax_tree), "cpu", dtype)


def port_batch(batch):
    """A JAX-package Seq2GeneBatch (jnp or numpy leaves) as the port's batch
    of CPU tensors."""
    from variantformer_tpu_torch.models.seq2gene import Seq2GeneBatch

    return Seq2GeneBatch(**{
        name: None if leaf is None else torch.from_numpy(np.array(leaf))
        for name, leaf in batch._asdict().items()
        if name in Seq2GeneBatch._fields
    })


def as_f32(x) -> np.ndarray:
    """A jax array or torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def load_jax_native(attempts: int = 100, wait_s: float = 0.1) -> None:
    """Load the JAX package's native libraries in this process before a test
    uses them. Its build (``make``, run by whichever test process gets there
    first) writes the ``.so`` in place, so another process can find the file
    before it is whole and fail to load it; retrying until it loads keeps
    that race out of the port's tests. The loaded libraries stay cached."""
    import time

    from variantformer_tpu.utils import native as jax_native

    for attempt in range(attempts):
        try:
            jax_native.get_library()
            jax_native.get_seq_library()
            return
        except OSError:
            if attempt == attempts - 1:
                raise
            time.sleep(wait_s)

"""Random parameter initialization from a seed.

Builds the same tree (names, nesting, shapes) as
``variantformer_tpu/models/init.py``, from a ``torch.Generator`` on the
target device, so full-width weights can be made on the card without JAX.
The numbers differ from the JAX package's for the same seed: tests that
compare the two packages make the weights once and hand them across with
``models/params.to_tensors``.
"""

from __future__ import annotations

import torch

from variantformer_tpu_torch.config import ModelConfig, WindowEncoderConfig
from variantformer_tpu_torch.device import resolve_device


class ParamInit:
    """Draws every leaf from one generator, in a fixed order."""

    def __init__(self, seed: int, device: torch.device, dtype: torch.dtype):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)
        self.device = device
        self.dtype = dtype

    def uniform(self, shape, bound: float) -> torch.Tensor:
        u = torch.rand(shape, generator=self.gen, device=self.device, dtype=self.dtype)
        return u.mul_(2 * bound).sub_(bound)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device, dtype=self.dtype)

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(shape, value, device=self.device, dtype=self.dtype)

    def linear(self, fan_in: int, fan_out: int, stacked: int | None = None) -> dict:
        """Torch-style uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)); weights [in, out]."""
        bound = fan_in ** -0.5
        lead = () if stacked is None else (stacked,)
        return {
            "w": self.uniform((*lead, fan_in, fan_out), bound),
            "b": self.uniform((*lead, fan_out), bound),
        }

    def norm(self, dim: int, stacked: int) -> dict:
        return {"scale": self.full((stacked, dim), 1.0), "bias": self.full((stacked, dim), 0.0)}

    def context_layer_stack(self, num_layers: int, dim: int, hidden: int) -> dict:
        """Stacked params for self+cross+GeGLU layers."""
        return {
            "norm1": self.norm(dim, num_layers),
            "norm2": self.norm(dim, num_layers),
            "norm3": self.norm(dim, num_layers),
            "mixer": {
                "wqkv": self.linear(dim, 3 * dim, num_layers),
                "out": self.linear(dim, dim, num_layers),
            },
            "cross": {
                "wq": self.linear(dim, dim, num_layers),
                "wkv": self.linear(dim, 2 * dim, num_layers),
                "out": self.linear(dim, dim, num_layers),
            },
            "ffn_in": self.linear(dim, hidden, num_layers),
            "ffn_out": self.linear(hidden // 2, dim, num_layers),
        }

    def plain_layer_stack(self, num_layers: int, dim: int, hidden: int) -> dict:
        return {
            "norm1": self.norm(dim, num_layers),
            "norm2": self.norm(dim, num_layers),
            "mixer": {
                "wqkv": self.linear(dim, 3 * dim, num_layers),
                "out": self.linear(dim, dim, num_layers),
            },
            "ffn_in": self.linear(dim, hidden, num_layers),
            "ffn_out": self.linear(hidden // 2, dim, num_layers),
        }

    def window_encoder(self, cfg: WindowEncoderConfig) -> dict:
        e = cfg.embedding_dim
        stack = self.context_layer_stack if cfg.use_context else self.plain_layer_stack
        return {
            "token_embedding": self.normal((cfg.vocab_size, e)),
            "context_embedding": self.normal((9, e)),
            "layers": stack(cfg.num_layers, e, cfg.ffn_hidden_dim),
            "tissue_classifiers": {
                "w": self.normal((cfg.num_tissues, e, cfg.num_classes)) * (e ** -0.5),
                "b": self.full((cfg.num_tissues, cfg.num_classes), 0.0),
            },
        }


def init_window_encoder(
    cfg: WindowEncoderConfig, seed: int, device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """One window encoder's (seq2reg tokenizer's) parameter tree, made on
    ``device`` (the card unless the caller asks for the CPU)."""
    return ParamInit(seed, resolve_device(device), dtype).window_encoder(cfg)


def init_seq2gene(
    cfg: ModelConfig, seed: int, device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """The seq2gene parameter tree, made on ``device`` (the card unless the
    caller asks for the CPU; raises where there is no card)."""
    mcfg = cfg.seq2gene
    wcfg = cfg.window_encoder
    e = mcfg.emb_dim
    ini = ParamInit(seed, resolve_device(device), dtype)
    # multi_head=False (the released configuration) shares one head across
    # tissues; the stacked-head tree then has a single entry.
    t = mcfg.num_tissues if mcfg.multi_head else 1
    bound = e ** -0.5
    return {
        "cre_tokenizer": ini.window_encoder(wcfg),
        "gene_tokenizer": ini.window_encoder(wcfg),
        "cre_map": ini.linear(mcfg.token_dim, e),
        "gene_map": ini.linear(mcfg.gene_emb_dim, e),
        "registry": ini.normal((mcfg.num_tissues, e)),
        "context_embedding": ini.normal((9, e)),
        "cre_layers": ini.context_layer_stack(
            mcfg.num_layers - 1, e, mcfg.ffn_hidden_dim
        ),
        "gene_layers": ini.context_layer_stack(
            mcfg.num_layers, e, mcfg.ffn_hidden_dim
        ),
        "tissue_heads": {
            "w1": ini.uniform((t, e, e), bound),
            "b1": ini.full((t, e), 0.0),
            "ln_scale": ini.full((t, e), 1.0),
            "ln_bias": ini.full((t, e), 0.0),
            "w2": ini.uniform((t, e, e), bound),
            "b2": ini.full((t, e), 0.0),
            "w3": ini.uniform((t, e, 1), bound),
            "b3": ini.full((t, 1), 0.0),
        },
    }


def count_params(params) -> int:
    """Number of values in a parameter tree (tensors or numpy arrays)."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(params.numel() if isinstance(params, torch.Tensor) else params.size)

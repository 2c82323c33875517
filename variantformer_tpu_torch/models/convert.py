"""Reference checkpoint -> parameter tree converter.

The port's copy of ``variantformer_tpu/models/convert.py``. Maps the
reference's Lightning state_dicts (the seq2reg tokenizers and the 1.2B
Seq2GenePredictorCombinedModulator) onto the parameter tree that
``models/init.py`` builds:

  * torch Linear weights [out, in] are transposed to [in, out],
  * packed QKV/KV rows are reordered to head-major (H, num, D),
  * per-layer modules are stacked along a leading layer axis,
  * the per-tissue heads are stacked along a leading tissue axis.

Works on numpy arrays; ``load_torch_checkpoint`` reads a ``.pth`` into one.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

Array = np.ndarray
StateDict = Mapping[str, Array]


def _lin(sd: StateDict, prefix: str) -> dict:
    return {
        "w": np.ascontiguousarray(sd[f"{prefix}.weight"].T),
        "b": np.asarray(sd[f"{prefix}.bias"]),
    }


def _packed_lin(sd: StateDict, prefix: str, num: int, num_heads: int) -> dict:
    """Packed QKV/KV projection, re-ordered from flash-attn's (num, H, D) output
    layout to head-major (H, num, D) — so sharding the flat output dim into
    contiguous chunks is exactly head-parallel tensor parallelism."""
    w = np.asarray(sd[f"{prefix}.weight"])  # [num*H*D, E] torch layout
    b = np.asarray(sd[f"{prefix}.bias"])    # [num*H*D]
    out_dim, e = w.shape
    head_dim = out_dim // (num * num_heads)
    w = w.reshape(num, num_heads, head_dim, e).transpose(1, 0, 2, 3)
    b = b.reshape(num, num_heads, head_dim).transpose(1, 0, 2)
    return {
        "w": np.ascontiguousarray(w.reshape(out_dim, e).T),
        "b": np.ascontiguousarray(b.reshape(out_dim)),
    }


def _norm(sd: StateDict, prefix: str) -> dict:
    return {
        "scale": np.asarray(sd[f"{prefix}.weight"]),
        "bias": np.asarray(sd[f"{prefix}.bias"]),
    }


def _stack(trees: list) -> dict:
    """Stack a list of identically-structured nested dicts along axis 0."""
    out: dict = {}
    for key in trees[0]:
        vals = [t[key] for t in trees]
        if isinstance(vals[0], dict):
            out[key] = _stack(vals)
        else:
            out[key] = np.stack(vals, axis=0)
    return out


def _context_layer(sd: StateDict, prefix: str, num_heads: int) -> dict:
    """One self+cross+GeGLU encoder layer (mixer/crossMHA naming from the
    reference's ContextFlashAttentionEncoderLayer)."""
    return {
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "norm2": _norm(sd, f"{prefix}.norm2"),
        "norm3": _norm(sd, f"{prefix}.norm3"),
        "mixer": {
            "wqkv": _packed_lin(sd, f"{prefix}.mixer.MHA.Wqkv", 3, num_heads),
            "out": _lin(sd, f"{prefix}.mixer.MHA.out_proj"),
        },
        "cross": {
            "wq": _lin(sd, f"{prefix}.crossMHA.MHA.Wq"),
            "wkv": _packed_lin(sd, f"{prefix}.crossMHA.MHA.Wkv", 2, num_heads),
            "out": _lin(sd, f"{prefix}.crossMHA.MHA.out_proj"),
        },
        "ffn_in": _lin(sd, f"{prefix}.linear_geglu_1"),
        "ffn_out": _lin(sd, f"{prefix}.linear_geglu_2"),
    }


def _plain_layer(sd: StateDict, prefix: str, num_heads: int) -> dict:
    """Self-attention-only encoder layer (reference FlashTransformerLayer,
    seq2reg/modules.py:129-191; MHA is a direct attribute, not under mixer)."""
    return {
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "norm2": _norm(sd, f"{prefix}.norm2"),
        "mixer": {
            "wqkv": _packed_lin(sd, f"{prefix}.MHA.Wqkv", 3, num_heads),
            "out": _lin(sd, f"{prefix}.MHA.out_proj"),
        },
        "ffn_in": _lin(sd, f"{prefix}.linear_geglu_1"),
        "ffn_out": _lin(sd, f"{prefix}.linear_geglu_2"),
    }


def _count_layers(sd: StateDict, template: str) -> int:
    n = 0
    while template.format(n) + ".norm1.weight" in sd:
        n += 1
    return n


def window_encoder_uses_context(sd: StateDict, prefix: str = "") -> bool:
    p = prefix + "." if prefix and not prefix.endswith(".") else prefix
    return f"{p}transformer_encoder.0.mixer.MHA.Wqkv.weight" in sd


def convert_window_encoder(sd: StateDict, prefix: str = "", num_heads: int = 8) -> dict:
    """Convert a Seq2RegPredictor state_dict (optionally under ``prefix.``).

    Detects the layer flavor from parameter names: context layers
    (mixer/crossMHA) vs plain self-attention layers (direct MHA attribute)."""
    p = prefix + "." if prefix and not prefix.endswith(".") else prefix
    num_layers = _count_layers(sd, p + "transformer_encoder.{}")
    if window_encoder_uses_context(sd, prefix):
        layers = [
            _context_layer(sd, f"{p}transformer_encoder.{i}", num_heads)
            for i in range(num_layers)
        ]
    else:
        layers = [
            _plain_layer(sd, f"{p}transformer_encoder.{i}", num_heads)
            for i in range(num_layers)
        ]
    num_tissues = 0
    while f"{p}tissue_classifiers.{num_tissues}.weight" in sd:
        num_tissues += 1
    params = {
        "token_embedding": np.asarray(sd[f"{p}token_embedding.weight"]),
        "layers": _stack(layers),
    }
    if f"{p}context_embedding.weight" in sd:
        params["context_embedding"] = np.asarray(sd[f"{p}context_embedding.weight"])
    if num_tissues:
        params["tissue_classifiers"] = {
            "w": np.stack(
                [sd[f"{p}tissue_classifiers.{t}.weight"].T for t in range(num_tissues)]
            ),
            "b": np.stack(
                [sd[f"{p}tissue_classifiers.{t}.bias"] for t in range(num_tissues)]
            ),
        }
    return params


def _tissue_heads(sd: StateDict, prefix: str) -> dict:
    """Bigger-head MLP Sequential indices: 0 Linear, 1 LayerNorm, 4 Linear, 6 Linear.

    Handles both head layouts (reference seq2gene/modules/layers.py:1057-1086):
    multi_head=True stores one Sequential per tissue
    (``tissue_expressions.{t}.0.weight``); the released checkpoints use
    multi_head=False — ONE shared Sequential (``tissue_expressions.0.weight``)
    — which converts to a stacked tree with a single entry.
    """
    if f"{prefix}.0.0.weight" in sd:  # multi_head: ModuleDict of Sequentials
        num = 0
        while f"{prefix}.{num}.0.weight" in sd:
            num += 1
        keys = [f"{prefix}.{t}" for t in range(num)]
    elif f"{prefix}.0.weight" in sd:  # single shared Sequential
        keys = [prefix]
    else:
        raise KeyError(f"no tissue-head weights under {prefix!r}")
    return {
        "w1": np.stack([sd[f"{k}.0.weight"].T for k in keys]),
        "b1": np.stack([sd[f"{k}.0.bias"] for k in keys]),
        "ln_scale": np.stack([sd[f"{k}.1.weight"] for k in keys]),
        "ln_bias": np.stack([sd[f"{k}.1.bias"] for k in keys]),
        "w2": np.stack([sd[f"{k}.4.weight"].T for k in keys]),
        "b2": np.stack([sd[f"{k}.4.bias"] for k in keys]),
        "w3": np.stack([sd[f"{k}.6.weight"].T for k in keys]),
        "b3": np.stack([sd[f"{k}.6.bias"] for k in keys]),
    }


def convert_seq2gene(
    sd: StateDict, num_heads: int = 32, encoder_num_heads: int = 8
) -> dict:
    """Convert a hierarchical seq2gene state_dict (the 1.2B model).

    Handles both released model classes — Seq2GenePredictorCombinedModulator
    (combined_modulator.{cre,gene}_layers.*) and the two-module
    Seq2GenePredictor (epigenetics_modulator.*/gene_modulator.*, reference
    seq2gene/model.py) — which share identical computation when configured
    alike; gene layer i consumes CRE intermediate i in both.

    The tokenizer weights embedded in this state_dict are the final
    (potentially fine-tuned) ones, matching the reference's load order where
    the combined checkpoint overwrites the standalone tokenizer checkpoints.
    """
    if "combined_modulator.cre_layers.0.norm1.weight" in sd:
        cre_prefix = "combined_modulator.cre_layers"
        gene_prefix = "combined_modulator.gene_layers"
        ctx_key = "combined_modulator.second_level_context_embedding.weight"
    else:
        cre_prefix = "epigenetics_modulator.epigenetics_modulator"
        gene_prefix = "gene_modulator.gene_modulator"
        ctx_key = "epigenetics_modulator.second_level_context_embedding.weight"
    n_cre = _count_layers(sd, cre_prefix + ".{}")
    n_gene = _count_layers(sd, gene_prefix + ".{}")

    def _gene_layer(i):
        prefix = f"{gene_prefix}.{i}"
        if f"{prefix}.mixer.MHA.Wqkv.weight" in sd:
            return _context_layer(sd, prefix, num_heads)
        # cross-attention-only gene layer (only_cross_attention=True)
        return {
            "norm1": _norm(sd, f"{prefix}.norm1"),
            "norm2": _norm(sd, f"{prefix}.norm2"),
            "cross": {
                "wq": _lin(sd, f"{prefix}.crossMHA.MHA.Wq"),
                "wkv": _packed_lin(sd, f"{prefix}.crossMHA.MHA.Wkv", 2, num_heads),
                "out": _lin(sd, f"{prefix}.crossMHA.MHA.out_proj"),
            },
            "ffn_in": _lin(sd, f"{prefix}.linear_geglu_1"),
            "ffn_out": _lin(sd, f"{prefix}.linear_geglu_2"),
        }

    params = {
        "cre_tokenizer": convert_window_encoder(sd, "cre_tokenizer", encoder_num_heads),
        "gene_tokenizer": convert_window_encoder(sd, "gene_tokenizer", encoder_num_heads),
        "cre_map": _lin(sd, "cre_map"),
        "gene_map": _lin(sd, "gene_map"),
        "registry": np.asarray(sd["start_tkn.registry_tokens.weight"]),
        "context_embedding": np.asarray(sd[ctx_key]),
        "cre_layers": _stack(
            [_context_layer(sd, f"{cre_prefix}.{i}", num_heads) for i in range(n_cre)]
        ),
        "gene_layers": _stack([_gene_layer(i) for i in range(n_gene)]),
        "tissue_heads": _tissue_heads(sd, "tissue_heads.tissue_expressions"),
    }
    return params


def load_torch_checkpoint(path: str) -> tuple[dict, dict]:
    """Read a torch ``.pth`` on the CPU: (numpy float32 state_dict,
    hyper_parameters). The state_dict is the file's ``state_dict`` entry, or
    the whole file when it has none."""
    chk = torch.load(path, map_location="cpu", weights_only=False)
    sd = chk["state_dict"] if "state_dict" in chk else chk
    np_sd = {k: v.float().numpy() for k, v in sd.items()}
    return np_sd, dict(chk.get("hyper_parameters", {}))

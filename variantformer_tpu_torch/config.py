"""Configuration dataclasses of the PyTorch port.

A copy of ``variantformer_tpu/config.py``: the same fields and defaults
(the released ``v4_pcg`` model), so a parameter tree built for one package
has the shapes the other expects.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import yaml


@dataclasses.dataclass(frozen=True)
class WindowEncoderConfig:
    """Config of the frozen CRE/gene window encoder ("seq2reg tokenizer").

    Field values are normally calibrated from the converted checkpoint's
    hyper-parameters; the defaults describe the released encoder family.
    """

    vocab_size: int = 500
    embedding_dim: int = 512
    num_heads: int = 8
    num_layers: int = 8
    ffn_hidden_dim: int = 2048          # GeGLU input width (split into 2x1024)
    num_tissues: int = 63
    num_classes: int = 11
    # Whether encoder layers cross-attend to a per-window cCRE-class
    # embedding. The released pipeline passes float dummy context for gene
    # windows, which only type-checks when the tokenizer checkpoints were
    # built with use_context=False (plain self-attention layers) — hence the
    # default. Calibrated from checkpoint hyper-parameters at load.
    use_context: bool = False
    positional_encoding: str = "alibi"  # "alibi" | "sinusoidal"
    seq_pool: str = "mean"              # "mean" | "max" | "linear"
    strand_agg: str = "mean"
    token_length: int = 200


@dataclasses.dataclass(frozen=True)
class Seq2GeneConfig:
    """Config of the hierarchical CRE<->gene stack (combined-modulator form)."""

    emb_dim: int = 1536
    gene_emb_dim: int = 512             # width of window-encoder embeddings
    token_dim: int = 512                # ditto, for the CRE side
    num_heads: int = 32
    num_layers: int = 25                # gene layers; CRE layers = num_layers-1
    ffn_hidden_dim: int = 2048
    num_tissues: int = 63
    use_alibi: bool = True
    cross_alibi: bool = False
    use_context: bool = True            # CRE layers cross-attend to cCRE class
    # Released checkpoints run full self+cross gene layers and ONE shared
    # tissue head (reference configs/vf_model.yaml:17,25 sets
    # only_cross_attention/multi_head false; tissue specificity comes from the
    # registry token). Both are also re-detected from checkpoint weights at
    # load (api/model_manager.py).
    only_cross_attention: bool = False  # gene layers also self-attend
    use_res: bool = False
    gene_pooling: str = "multi_registry"
    remat: bool = False                 # checkpoint each layer in training
    use_bigger_head: bool = True
    multi_head: bool = False            # one shared expression head
    head_type: str = "mlp"
    loss_fn: str = "poisson"
    mlp_dout: float = 0.1
    # Reference checkpoint-config compatibility only. The reference's
    # MAX_WINDOW_SIZE guard (model_combined_modulator.py:32-33,746-758) drops
    # a training batch to its single largest donor when the summed dynamic
    # token count exceeds this, bounding CUDA memory. Deliberately NOT
    # enforced here: device shapes are static buckets (gene axis capped at
    # dataset.max_chunks, CRE axis bucketed in pack_samples), so the
    # pathological dynamic-memory case cannot arise — memory is bounded by
    # construction, per batch, independent of window bp length.
    max_window_size: int = 30_000_000
    max_chunk_size: int = 1024          # window-encoder micro-batch bound


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    max_length: int = 200               # BPE tokens per window
    max_chunks: int = 200               # gene windows per gene
    cre_neighbour_hood: int = 50        # +-bp around each CRE
    gene_upstream_neighbour_hood: int = 1_000
    gene_downstream_neighbour_hood: int = 300_000
    gencode: str = ""


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Mixed-precision policy: fp32 params, bf16 matmul streams, fp32 norms."""

    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    softmax_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model_class: str = "v4_pcg"
    checkpoint_path: str = ""
    window_encoder: WindowEncoderConfig = dataclasses.field(
        default_factory=WindowEncoderConfig
    )
    seq2gene: Seq2GeneConfig = dataclasses.field(default_factory=Seq2GeneConfig)
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    precision: PrecisionPolicy = dataclasses.field(default_factory=PrecisionPolicy)


def _update(dc, data: dict[str, Any]):
    """Recursively rebuild a (frozen) dataclass with overrides from a dict."""
    kwargs = {}
    for field in dataclasses.fields(dc):
        if field.name not in data:
            continue
        value = data[field.name]
        current = getattr(dc, field.name)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            value = _update(current, value)
        kwargs[field.name] = value
    return dataclasses.replace(dc, **kwargs)


def load_model_config(path: str | Path | None = None, model_class: str = "v4_pcg") -> ModelConfig:
    """Load a ModelConfig, optionally overlaying a YAML file keyed by model class."""
    cfg = ModelConfig(model_class=model_class)
    if path is None:
        return cfg
    with open(path) as fh:
        raw = yaml.safe_load(fh) or {}
    if model_class in raw:
        raw = raw[model_class]
    return _update(cfg, raw)

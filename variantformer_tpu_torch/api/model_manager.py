"""Checkpoint loading and config calibration.

The port's copy of ``variantformer_tpu/api/model_manager.py``: reads the
reference's torch Lightning checkpoints (``models/convert.py``), converts
them to the port's parameter tree, and calibrates the model config from the
checkpoints' hyper-parameters. The combined checkpoint's tokenizer weights
overwrite the standalone tokenizer checkpoint's, as in the reference's load
order. The head layout (shared or per tissue) and the window encoders'
layer flavour are read from the weights.
"""

from __future__ import annotations

import dataclasses
import logging

import torch

from variantformer_tpu_torch.config import ModelConfig, WindowEncoderConfig
from variantformer_tpu_torch.device import resolve_device
from variantformer_tpu_torch.models import convert
from variantformer_tpu_torch.models.init import count_params
from variantformer_tpu_torch.models.params import to_tensors

log = logging.getLogger(__name__)

_ENCODER_KEYS = (
    "vocab_size", "embedding_dim", "num_heads", "num_layers", "num_tissues",
    "num_classes", "use_context", "positional_encoding", "seq_pool", "strand_agg",
)
_SEQ2GENE_KEYS = (
    "emb_dim", "gene_emb_dim", "num_heads", "num_layers", "use_alibi", "use_context",
    "gene_pooling", "num_tissues", "token_dim",
)
_SEQ2GENE_FLAGS = ("only_cross_attention", "use_bigger_head", "multi_head")


@dataclasses.dataclass
class LoadedModel:
    params: dict
    config: ModelConfig


class ModelManager:
    def __init__(self, cfg: ModelConfig, tokenizer_checkpoint_path: str | None = None):
        self.cfg = cfg
        self.tokenizer_checkpoint_path = tokenizer_checkpoint_path

    def _calibrate_encoder_cfg(self, hyper: dict) -> WindowEncoderConfig:
        updates = {k: hyper[k] for k in _ENCODER_KEYS if hyper.get(k) is not None}
        return dataclasses.replace(self.cfg.window_encoder, **updates)

    def load_model(
        self, param_dtype: torch.dtype = torch.bfloat16, device: str | torch.device = "cuda"
    ) -> LoadedModel:
        """The checkpoint's parameters as tensors on ``device`` (the card
        unless the caller asks for the CPU) in ``param_dtype``, and the
        calibrated config."""
        dev = resolve_device(device)
        cfg = self.cfg
        if self.tokenizer_checkpoint_path:
            log.info("Loading tokenizer checkpoint %s", self.tokenizer_checkpoint_path)
            _, tok_hyper = convert.load_torch_checkpoint(self.tokenizer_checkpoint_path)
            cfg = dataclasses.replace(cfg, window_encoder=self._calibrate_encoder_cfg(tok_hyper))

        log.info("Loading model checkpoint %s", cfg.checkpoint_path)
        sd, hyper = convert.load_torch_checkpoint(cfg.checkpoint_path)
        if hyper:
            updates = {k: hyper[k] for k in _SEQ2GENE_KEYS if hyper.get(k) is not None}
            updates.update({k: hyper[k] for k in _SEQ2GENE_FLAGS if k in hyper})
            cfg = dataclasses.replace(cfg, seq2gene=dataclasses.replace(cfg.seq2gene, **updates))
        # Head layout is authoritative from the weights: multi_head stores one
        # Sequential per tissue (tissue_expressions.{t}.0.weight); the released
        # checkpoints share one head (tissue_expressions.0.weight).
        if "tissue_heads.tissue_expressions.0.weight" in sd:
            multi_head = False
        elif "tissue_heads.tissue_expressions.0.0.weight" in sd:
            multi_head = True
        else:
            multi_head = cfg.seq2gene.multi_head
        # Window-encoder layer flavour is authoritative from the weights.
        uses_ctx = convert.window_encoder_uses_context(sd, "cre_tokenizer")
        cfg = dataclasses.replace(
            cfg,
            seq2gene=dataclasses.replace(cfg.seq2gene, multi_head=multi_head),
            window_encoder=dataclasses.replace(cfg.window_encoder, use_context=uses_ctx),
        )

        tree = convert.convert_seq2gene(
            sd, num_heads=cfg.seq2gene.num_heads,
            encoder_num_heads=cfg.window_encoder.num_heads,
        )
        del sd
        params = to_tensors(tree, dev, param_dtype)
        log.info("Loaded %.2fB parameters", count_params(params) / 1e9)
        return LoadedModel(params=params, config=cfg)

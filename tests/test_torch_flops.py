"""The port's analytic FLOP counter (``variantformer_tpu_torch/utils/flops.py``)
against the JAX package's (``variantformer_tpu/utils/flops.py``), on the CPU.

Pure arithmetic on the same config fields: every per-stage count and the
total must be the same float, exactly, at the full released config, the
bench shape, the tiny test config, a cross-only gene stack and a narrow
config with an odd FFN width.
"""

import dataclasses

import pytest

from tests.test_model_smoke import tiny_config
from tests.torch_port_helpers import port_config
from variantformer_tpu.config import ModelConfig, Seq2GeneConfig, WindowEncoderConfig
from variantformer_tpu.utils import flops as jax_flops
from variantformer_tpu_torch.utils import flops as port_flops

_FULL = ModelConfig()
CONFIGS = {
    "full v4_pcg": _FULL,
    "tiny": tiny_config(),
    "full, only_cross_attention": dataclasses.replace(
        _FULL, seq2gene=dataclasses.replace(_FULL.seq2gene, only_cross_attention=True)),
    "narrow, odd FFN, cross-only": ModelConfig(
        window_encoder=WindowEncoderConfig(
            vocab_size=64, embedding_dim=96, num_heads=1, num_layers=3, ffn_hidden_dim=250,
            token_length=37),
        seq2gene=Seq2GeneConfig(emb_dim=120, gene_emb_dim=96, token_dim=96, num_heads=4,
                                num_layers=5, ffn_hidden_dim=330, only_cross_attention=True),
    ),
}
# (D, C, G, T): the bench's batch, one gene at one tissue, ragged counts
SHAPES = [(4, 384, 200, 54), (1, 1, 1, 1), (3, 17, 5, 63)]


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_seq2gene_flops_equal_the_jax_package(name, shape):
    cfg = CONFIGS[name]
    d, c, g, t = shape
    want = jax_flops.seq2gene_flops(cfg, d, c, g, t)
    got = port_flops.seq2gene_flops(port_config(cfg), d, c, g, t)
    assert got == want
    assert got["total"] == sum(v for k, v in got.items() if k != "total")


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stage_flops_equal_the_jax_package(name):
    cfg, pcfg = CONFIGS[name], port_config(CONFIGS[name])
    assert port_flops.window_encoder_flops(pcfg, 1536) == jax_flops.window_encoder_flops(cfg, 1536)
    assert port_flops.cre_stack_flops(pcfg, 2, 384) == jax_flops.cre_stack_flops(cfg, 2, 384)
    assert (port_flops.gene_stack_flops(pcfg, 2, 384, 201, 54)
            == jax_flops.gene_stack_flops(cfg, 2, 384, 201, 54))
    assert port_flops.tissue_head_flops(pcfg, 2, 54) == jax_flops.tissue_head_flops(cfg, 2, 54)


def test_cross_only_drops_the_gene_self_attention():
    """The only_cross_attention branch takes away the gene layers' self
    QKV, scores and out-projection, and nothing else."""
    full = port_config(_FULL)
    cross = port_config(CONFIGS["full, only_cross_attention"])
    m = full.seq2gene
    e, dt, g1 = m.emb_dim, 4 * 54, 201
    self_part = (2.0 * dt * g1 * e * 3 * e + 4.0 * dt * g1 * g1 * e
                 + 2.0 * dt * g1 * e * e) * m.num_layers
    assert (port_flops.gene_stack_flops(full, 4, 384, g1, 54)
            - port_flops.gene_stack_flops(cross, 4, 384, g1, 54)) == self_part

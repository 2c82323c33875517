"""The port's whole seq2gene forward against the JAX package's, on the CPU.

Weights come from the JAX package's ``init_seq2gene`` through the port's
weight bridge; batches from ``tests/test_model_smoke.tiny_batch``.
Tolerances: 1e-4 against the layered XLA path in float32 (the same
algorithm, only the summation order differs); 5e-2 (pred) / 6e-2
(embeddings) against ``impl="fused2"`` in bf16, the bound the JAX package
holds its own Pallas path to (the kernels use tanh GELU and round bf16 at
other points).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_model_smoke import tiny_batch, tiny_config
from tests.torch_port_helpers import as_f32, port_batch, port_config, port_params
from variantformer_tpu.config import PrecisionPolicy
from variantformer_tpu.models.init import init_seq2gene
from variantformer_tpu.models.seq2gene import seq2gene_forward as jax_forward
from variantformer_tpu_torch.models.seq2gene import (
    Seq2GeneBatch,
    seq2gene_forward,
    seq2gene_forward_plain,
)


def _f32(cfg):
    return dataclasses.replace(cfg, precision=PrecisionPolicy(compute_dtype="float32"))


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax_xla_f32(seed):
    cfg = _f32(tiny_config())
    params = init_seq2gene(jax.random.key(seed), cfg)
    batch = tiny_batch(np.random.default_rng(seed))
    ref = jax_forward(params, batch, cfg, impl="xla")
    out = seq2gene_forward(port_params(params), port_batch(batch), port_config(cfg))
    for name in ("pred_expression", "pooled_embedding"):
        np.testing.assert_allclose(
            as_f32(getattr(out, name)), as_f32(getattr(ref, name)),
            rtol=1e-4, atol=1e-4, err_msg=name,
        )
    assert out.pred_expression.dtype == torch.float32


def test_forward_matches_jax_fused2_bf16():
    cfg = tiny_config()
    params = init_seq2gene(jax.random.key(0), cfg)
    batch = tiny_batch(np.random.default_rng(0))
    ref = jax_forward(params, batch, cfg, impl="fused2")
    out = seq2gene_forward(port_params(params), port_batch(batch), port_config(cfg))
    np.testing.assert_allclose(
        as_f32(out.pred_expression), as_f32(ref.pred_expression), rtol=5e-2, atol=5e-2
    )
    np.testing.assert_allclose(
        as_f32(out.pooled_embedding), as_f32(ref.pooled_embedding), rtol=6e-2, atol=6e-2
    )


def test_forward_shapes_and_finiteness():
    cfg = port_config(tiny_config())
    params = port_params(init_seq2gene(jax.random.key(0), tiny_config()))
    out = seq2gene_forward(params, port_batch(tiny_batch(np.random.default_rng(0))), cfg)
    d, t, e = 2, 3, cfg.seq2gene.emb_dim
    assert tuple(out.pred_expression.shape) == (d, t)
    assert tuple(out.pooled_embedding.shape) == (d, t, e)
    assert torch.isfinite(out.pred_expression).all()
    assert torch.isfinite(out.pooled_embedding).all()
    assert (out.pred_expression >= 0).all()


def test_suffix_padding_invariance():
    """Growing the padded C/G slot counts must not change valid outputs."""
    cfg = port_config(tiny_config())
    params = port_params(init_seq2gene(jax.random.key(0), tiny_config()))
    batch = port_batch(tiny_batch(np.random.default_rng(1), d=1, c=4, g=3, t=2))

    def pad_axis(x, extra):
        pad = torch.zeros((x.shape[0], extra, *x.shape[2:]), dtype=x.dtype)
        return torch.cat([x, pad], dim=1)

    wider = batch._replace(
        cre_tokens=pad_axis(batch.cre_tokens, 3),
        cre_tok_len=pad_axis(batch.cre_tok_len, 3),
        cre_labels=pad_axis(batch.cre_labels, 3),
        gene_tokens=pad_axis(batch.gene_tokens, 2),
        gene_tok_len=pad_axis(batch.gene_tok_len, 2),
    )
    out_a = seq2gene_forward(params, batch, cfg)
    out_b = seq2gene_forward(params, wider, cfg)
    np.testing.assert_allclose(
        as_f32(out_a.pred_expression), as_f32(out_b.pred_expression), rtol=2e-2, atol=2e-2
    )


def test_plain_forward_is_the_cpu_path():
    """On CPU tensors the kernel wrappers take their plain versions, so the
    serving forward and the plain forward are the same computation."""
    cfg = port_config(tiny_config())
    params = port_params(init_seq2gene(jax.random.key(3), tiny_config()))
    batch = port_batch(tiny_batch(np.random.default_rng(3)))
    a = seq2gene_forward(params, batch, cfg)
    b = seq2gene_forward_plain(params, batch, cfg)
    torch.testing.assert_close(a.pred_expression, b.pred_expression, rtol=0, atol=0)
    torch.testing.assert_close(a.pooled_embedding, b.pooled_embedding, rtol=0, atol=0)


def test_unported_branches_raise():
    """The branches that once raised run: cross-only gene layers match the
    JAX package's ``impl="xla"`` at f32 1e-4; the VEP fields' gathers are
    the final streams' rows."""
    cfg = tiny_config()
    params = port_params(init_seq2gene(jax.random.key(0), cfg))
    batch = port_batch(tiny_batch(np.random.default_rng(0)))
    only_cross = _f32(dataclasses.replace(
        cfg, seq2gene=dataclasses.replace(cfg.seq2gene, only_cross_attention=True)
    ))
    jbatch = tiny_batch(np.random.default_rng(0))
    ref = jax_forward(init_seq2gene(jax.random.key(0), only_cross), jbatch, only_cross,
                      impl="xla")
    out = seq2gene_forward(params, batch, port_config(only_cross))
    for name in ("pred_expression", "pooled_embedding"):
        np.testing.assert_allclose(as_f32(getattr(out, name)), as_f32(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # The VEP fields no longer raise: the token embeddings are the gathers of
    # the final streams at the variant's positions (gene +1 for the registry
    # token; the CRE row broadcast over the tissues).
    gene_pos, cre_pos = [0, 2], [1, 4]
    vep = batch._replace(gene_token_position=torch.tensor(gene_pos, dtype=torch.int32),
                         cre_token_position=torch.tensor(cre_pos, dtype=torch.int32))
    out = seq2gene_forward(params, vep, port_config(cfg), return_streams=True)
    for i, (gp, cp) in enumerate(zip(gene_pos, cre_pos)):
        torch.testing.assert_close(out.gene_token_embedding[i],
                                   out.gene_stream[i, :, gp + 1].float(), rtol=0, atol=0)
        for t in range(out.cre_token_embedding.shape[1]):
            torch.testing.assert_close(out.cre_token_embedding[i, t],
                                       out.cre_stream[i, cp].float(), rtol=0, atol=0)
    assert isinstance(batch, Seq2GeneBatch)

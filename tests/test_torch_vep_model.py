"""The port's VEP forward against the JAX package's, on the CPU at float32,
and the ref-once cache of its VariantProcessor after an exception.

Weights come from the JAX package's ``init_seq2gene`` through the port's
weight bridge; the genome is that of ``tests/test_api_end_to_end.py``.

* ``seq2gene_forward`` on VEP batches (window-dedup pools, both token
  positions, ``return_streams``) against JAX ``impl="xla"`` within 1e-4; the
  pooled batch against the plain window layout within 1e-5.
* An exception in the middle of ``predict`` leaves no unfilled ref-cache
  placeholder and no pin behind: the next ``predict`` on the same processor
  gives the right answers.
"""

import dataclasses

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from tests.test_api_end_to_end import _tiny_cfg, fixture_env  # noqa: F401  (the genome fixture)
from tests.test_torch_vep_host import _port_sources
from tests.torch_port_helpers import (
    as_f32,
    load_jax_native,
    port_batch,
    port_config,
    port_params,
)
from variantformer_tpu.api.variantprocessor import VariantProcessor as JaxVariantProcessor
from variantformer_tpu.config import PrecisionPolicy
from variantformer_tpu.models.init import init_seq2gene
from variantformer_tpu.models.seq2gene import seq2gene_forward as jax_forward
from variantformer_tpu.utils import assets as jax_assets
from variantformer_tpu_torch.api.variantprocessor import VariantProcessor
from variantformer_tpu_torch.data import vep
from variantformer_tpu_torch.models.seq2gene import seq2gene_forward
from variantformer_tpu_torch.utils import assets

FLOATS = ("gene_exp", "gene_emb", "gene_token_embedding", "cre_token_embedding")


@pytest.fixture(scope="module", autouse=True)
def _jax_native_loaded():
    load_jax_native()


@pytest.fixture(autouse=True)
def _no_remote_fetch(monkeypatch):
    """No test reaches a network: a remote fetch fails at once (REF_HG38
    then takes the local consensus, as with no artifacts)."""
    def refuse(self, rel, dst):
        raise AssertionError(f"remote fetch of {rel} attempted")

    monkeypatch.setattr(assets.CachedFetcher, "_default_transport", refuse)
    monkeypatch.setattr(jax_assets.CachedFetcher, "_default_transport", refuse)
    monkeypatch.setenv("VFX_FETCH_RETRY_TIMEOUT", "0")


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(_tiny_cfg(500), precision=PrecisionPolicy(compute_dtype="float32"))
    return cfg, jax.tree.map(np.asarray, init_seq2gene(jax.random.key(1), cfg))


def _variant_df(seq, positions, tissues="tissue0,tissue2"):
    rows = []
    for pos in positions:
        ref = seq[pos - 1]
        rows.append({"chrom": "chr1", "pos": pos, "ref": ref,
                     "alt": {"A": "G", "C": "T", "G": "A", "T": "C"}[ref],
                     "tissue": tissues(pos) if callable(tissues) else tissues})
    return pd.DataFrame(rows)


def _port_processor(env, model):
    cfg, params = model
    proc = VariantProcessor(sources=_port_sources(env), config=port_config(cfg), device="cpu")
    proc.set_params(params)
    return proc


def _jax_processor(env, model):
    cfg, params = model
    proc = JaxVariantProcessor(sources=env["sources"], config=cfg, impl="xla")
    proc.set_params(params)
    return proc


def _assert_frames_match(got, want):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) and len(got) > 0
    for col in want.columns:
        if col in FLOATS:
            np.testing.assert_allclose(
                np.stack(got[col].to_list()).astype(np.float64),
                np.stack(want[col].to_list()).astype(np.float64),
                rtol=1e-4, atol=1e-4, err_msg=col,
            )
        else:
            assert got[col].to_list() == want[col].to_list(), col


# -- the forward on VEP batches ----------------------------------------------------------

def _vep_batch(env, model, positions, zygs, tissues):
    """A JAX-package VEP batch (pools, positions) of the given variants on
    GENEPLUS, packed as JaxVariantProcessor._forward_triples does."""
    from variantformer_tpu.data import vep as jax_vep
    from variantformer_tpu.data.pipeline import pack_samples

    jp = _jax_processor(env, model)
    builder = jp._vep_builder(None)
    info = builder.b.gene_info("GENEPLUS.1")
    seq = env["seq"]
    samples = []
    for pos in positions:
        ref = seq[pos - 1]
        alt = {"A": "G", "C": "T", "G": "A", "T": "C"}[ref]
        samples.append(builder.build(jax_vep.Variant("chr1", pos, ref, alt, tissues), info))
    flat = [s.samples[z] for s in samples for z in zygs]
    batch = pack_samples(flat, tissues)
    batch = batch._replace(
        cre_token_position=np.asarray(
            [int(s.cre_token_position) for s in samples for _ in zygs], np.int32),
        gene_token_position=np.asarray(
            [int(s.gene_token_positions[z]) for s in samples for z in zygs], np.int32),
    )
    return JaxVariantProcessor._dedup_windows(batch)


@pytest.mark.parametrize("zygs,positions,tissues", [
    ((0, 1, 2), (721,), [0, 2]),
    ((0, 1, 2), (721, 755), [3]),
    ((1, 2), (755, 721), [0, 2, 5]),
], ids=["triple", "two_triples", "pairs"])
def test_vep_forward_matches_jax_xla_f32(fixture_env, model, zygs, positions, tissues):
    cfg, params = model
    batch = _vep_batch(fixture_env, model, positions, zygs, tissues)
    assert batch.cre_pool_tokens is not None
    ref = jax_forward(params, batch, cfg, impl="xla", return_streams=True)
    tparams, tcfg = port_params(params), port_config(cfg)
    out = seq2gene_forward(tparams, port_batch(batch), tcfg, return_streams=True)
    for name in ref._fields:
        np.testing.assert_allclose(as_f32(getattr(out, name)), as_f32(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    # the variant's tokens are gathered, not zeros
    assert float(out.gene_token_embedding.abs().max()) > 0
    assert float(out.cre_token_embedding.abs().max()) > 0
    # the pools against the plain window layout
    plain_batch = port_batch(batch)._replace(
        cre_pool_tokens=None, cre_pool_len=None, cre_gather=None,
        gene_pool_tokens=None, gene_pool_len=None, gene_gather=None)
    plain = seq2gene_forward(tparams, plain_batch, tcfg, return_streams=True)
    for name in out._fields:
        torch.testing.assert_close(getattr(out, name), getattr(plain, name),
                                   rtol=1e-5, atol=1e-5, msg=name)
    without = seq2gene_forward(tparams, plain_batch._replace(
        gene_token_position=None, cre_token_position=None), tcfg)
    assert without.gene_stream is None and without.cre_stream is None
    assert float(without.gene_token_embedding.abs().max()) == 0
    torch.testing.assert_close(without.pred_expression, plain.pred_expression, rtol=0, atol=0)


# -- the ref-once cache after an exception ---------------------------------------------------

def _failing_build(build):
    """VepSampleBuilder.build that raises on the consensus build of the
    second GENEPLUS variant: the first one's ref triple is then in flight
    (launched, its placeholder not yet filled)."""
    def wrapped(self, variant, gene_info, validate_ref=True, precomputed=None):
        if gene_info["gene_id"] == "GENEPLUS.1" and variant.pos == 321 and precomputed is None:
            raise RuntimeError("injected build failure")
        return build(self, variant, gene_info, validate_ref, precomputed)

    return wrapped


def test_exception_mid_predict_leaves_no_placeholder(fixture_env, model, tmp_path, monkeypatch):
    """A build that raises in the middle of predict: the in-flight ref
    triple's placeholder is dropped and every pin released, so a second
    predict on the same processor gives the answers of a fresh one. The JAX
    package keeps the placeholder (and its next predict would merge against
    it)."""
    from variantformer_tpu.data import vep as jax_vep

    var_df = _variant_df(fixture_env["seq"], (130, 321, 721, 755))
    args = dict(vcf_path=fixture_env["vcf"], sample_name="S1")
    monkeypatch.setenv("VFX_VEP_BUILD_WORKERS", "1")
    monkeypatch.setattr(jax_vep.VepSampleBuilder, "build",
                        _failing_build(jax_vep.VepSampleBuilder.build))
    jp = _jax_processor(fixture_env, model)
    with pytest.raises(RuntimeError, match="injected"):
        jp.predict(var_df, str(tmp_path / "jax"), **args)
    assert None in jp._ref_cache.values(), "the failure did not hit an in-flight ref"

    build = vep.VepSampleBuilder.build
    monkeypatch.setattr(vep.VepSampleBuilder, "build", _failing_build(build))
    proc = _port_processor(fixture_env, model)
    with pytest.raises(RuntimeError, match="injected"):
        proc.predict(var_df, str(tmp_path / "first"), **args)
    assert proc.vep_stats["ref_misses"] == 1
    assert None not in proc._ref_cache.values()
    assert not proc._ref_pins
    monkeypatch.setattr(vep.VepSampleBuilder, "build", build)
    again = proc.predict(var_df, str(tmp_path / "again"), **args)
    fresh = _port_processor(fixture_env, model).predict(var_df, str(tmp_path / "fresh"), **args)
    _assert_frames_match(again, fresh)
    assert not proc._ref_pins


def test_variant_processor_device_rules(fixture_env, model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        VariantProcessor(sources=_port_sources(fixture_env), config=port_config(model[0]))
    proc = _port_processor(fixture_env, model)
    assert proc.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        proc.use_mesh()  # a mesh needs a process group
    with pytest.raises(RuntimeError, match="set_params"):
        VariantProcessor(sources=_port_sources(fixture_env), config=port_config(model[0]),
                         device="cpu").predict(_variant_df(fixture_env["seq"], (721,)), "x")

"""The port's sweeps against the JAX package's, on the CPU at float32.

``genome_wide_expression`` and ``saturation_scan`` of
``variantformer_tpu_torch.api.sweeps`` (processors made with
``device="cpu"``) and of the JAX package (``impl="xla"``) run on the genome
of ``tests/test_api_end_to_end.py`` with the same ``init_seq2gene`` weights,
brought across by the weight bridge. The frames must match (names and
zygosities exactly, the float columns within 1e-4) and every dispatch must
have the JAX package's donor count: the trailing group padded to
``batch_size``, the scan's reference call and partial batch padded to
2 x ``variants_per_batch``.
"""

import numpy as np
import pandas as pd
import pytest

from tests.test_api_end_to_end import fixture_env  # noqa: F401  (the genome fixture)
from tests.test_torch_vep_host import _port_sources
from tests.test_torch_vep_model import (  # noqa: F401  (fixtures)
    _jax_native_loaded,
    _jax_processor,
    _no_remote_fetch,
    _port_processor,
    model,
)
from tests.torch_port_helpers import port_config
from variantformer_tpu.api import sweeps as jax_sweeps
from variantformer_tpu.api.vcfprocessor import VCFProcessor as JaxVCFProcessor
from variantformer_tpu_torch.api import sweeps
from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor

TOL = dict(rtol=1e-4, atol=1e-4)


def _vcf_processors(env, model):
    cfg, params = model
    port = VCFProcessor(sources=_port_sources(env), config=port_config(cfg), device="cpu")
    port.set_params(params)
    jax_proc = JaxVCFProcessor(sources=env["sources"], config=cfg, impl="xla")
    jax_proc.set_params(params)
    return port, jax_proc


def _spy_forward(proc):
    """Wrap a VCFProcessor's _forward, recording each dispatch's donor count."""
    seen = []
    orig = proc._forward

    def spy(batch, **kw):
        seen.append(int(batch.gene_tokens.shape[0]))
        return orig(batch, **kw)

    proc._forward = spy
    return seen


def _assert_frames_match(got: pd.DataFrame, want: pd.DataFrame, floats):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want) and len(got) > 0
    for col in want.columns:
        if col in floats:
            np.testing.assert_allclose(got[col].to_numpy(np.float64),
                                       want[col].to_numpy(np.float64), err_msg=col, **TOL)
        else:
            assert got[col].to_list() == want[col].to_list(), col


GW_FLOATS = ("predicted_expression",)
SCAN_FLOATS = ("expression", "ref_expression", "log2fc")


def test_genome_wide_streaming_matches_jax(fixture_env, model, tmp_path):
    port, jax_proc = _vcf_processors(fixture_env, model)
    frames = []
    for name, mod, proc in (("port", sweeps, port), ("jax", jax_sweeps, jax_proc)):
        out_dir = tmp_path / name
        result = mod.genome_wide_expression(
            proc, fixture_env["vcf"], tissues=["tissue0", "tissue5"],
            batch_size=1, out_dir=str(out_dir), shard_rows=2,
        )
        assert result is None
        shards = sorted(out_dir.glob("shard_*.parquet"))
        frames.append((len(shards), pd.concat([pd.read_parquet(s) for s in shards],
                                              ignore_index=True)))
    (n_port, got), (n_jax, want) = frames
    assert n_port == n_jax == 2  # one shard a dispatch of one gene
    _assert_frames_match(got, want, GW_FLOATS)
    assert set(got["gene_id"]) == {"GENEPLUS.1", "GENEMINUS.1"}
    assert set(got["tissue"]) == {"tissue0", "tissue5"}


@pytest.mark.parametrize("genes,batch_size", [
    (None, 4),
    (["GENEMINUS.1", "NOPE.1", "GENEPLUS.1", "GENEMINUS.1"], 3),
], ids=["all-genes", "skipped-gene-padded"])
def test_genome_wide_in_memory_matches_jax(fixture_env, model, genes, batch_size):
    """In memory, with a gene that fails to build skipped by both."""
    port, jax_proc = _vcf_processors(fixture_env, model)
    stats = {}
    got = sweeps.genome_wide_expression(port, None, tissues=["tissue1"], genes=genes,
                                        batch_size=batch_size, stats=stats)
    want = jax_sweeps.genome_wide_expression(jax_proc, None, tissues=["tissue1"],
                                             genes=genes, batch_size=batch_size)
    _assert_frames_match(got, want, GW_FLOATS)
    assert len(got) == (2 if genes is None else 3)
    assert set(stats) == {"stages", "wall_s"}
    assert set(stats["stages"]) == {"host_build", "wait_build", "pack", "dispatch",
                                    "device_sync"}
    assert stats["wall_s"] > 0


def test_genome_wide_pads_trailing_group_to_canonical_shape(fixture_env, model):
    """2 genes at batch_size=4: the single partial group dispatches at the
    canonical donor count in both packages, and the pad rows are dropped."""
    port, jax_proc = _vcf_processors(fixture_env, model)
    seen_port, seen_jax = _spy_forward(port), _spy_forward(jax_proc)
    got = sweeps.genome_wide_expression(port, None, tissues=["tissue1"], batch_size=4)
    want = jax_sweeps.genome_wide_expression(jax_proc, None, tissues=["tissue1"],
                                             batch_size=4)
    assert seen_port == seen_jax == [4]
    _assert_frames_match(got, want, GW_FLOATS)
    assert got["gene_id"].nunique() == 2


def test_saturation_scan_matches_jax(fixture_env, model):
    # a 6 bp slice inside GENEPLUS's second CRE [300, 380)
    args = dict(chrom="chr1", start=318, end=323, gene_id="GENEPLUS.1",
                tissues=["tissue0", "tissue2"], variants_per_batch=4)
    got = sweeps.saturation_scan(_port_processor(fixture_env, model), **args)
    want = jax_sweeps.saturation_scan(_jax_processor(fixture_env, model), **args)
    _assert_frames_match(got, want, SCAN_FLOATS)
    # 6 positions x 3 alts x 2 zygosities x 2 tissues
    assert len(got) == 6 * 3 * 2 * 2
    assert set(got["zygosity"]) == {"1", "2"}
    assert np.all(np.isfinite(got["log2fc"]))
    hom = got[got["zygosity"] == "2"]
    assert (np.abs(hom["expression"] - hom["ref_expression"]) > 1e-9).any()
    assert hom.groupby("tissue")["ref_expression"].nunique().eq(1).all()


def test_saturation_scan_single_device_shape(fixture_env, model):
    """5 positions x 3 alts = 15 variants: the reference call, 3 full and 1
    partial batch, all at D = 2 x 4, in both packages; a slice that overlaps
    nothing of the gene is skipped."""
    args = dict(chrom="chr1", start=318, end=322, gene_id="GENEPLUS.1",
                tissues=["tissue0"], variants_per_batch=4)
    port, jax_proc = _port_processor(fixture_env, model), _jax_processor(fixture_env, model)
    seen_port, seen_jax = _spy_forward(port._vp), _spy_forward(jax_proc._vp)
    got = sweeps.saturation_scan(port, **args)
    want = jax_sweeps.saturation_scan(jax_proc, **args)
    assert seen_port == seen_jax == [8] * 5
    _assert_frames_match(got, want, SCAN_FLOATS)
    assert len(got) == 5 * 3 * 2
    # 40..42 overlaps no CRE and lies outside GENEPLUS's window: only the ref call
    seen_port.clear()
    empty = sweeps.saturation_scan(port, **dict(args, start=40, end=42))
    assert empty.empty and seen_port == [8]


def test_tokenize_matches_jax(fixture_env, model):
    """VepSampleBuilder._tokenize, which builds the scan's reference sample,
    against the JAX package's, on both strands."""
    port, jax_proc = _port_processor(fixture_env, model), _jax_processor(fixture_env, model)
    pb, jb = port._vep_builder(None), jax_proc._vep_builder(None)
    for gene_id in ("GENEPLUS.1", "GENEMINUS.1"):
        info = pb.b.gene_info(gene_id)
        cre_df, gene = pb._cre_sequences(gene_id, info), pb._gene_sequence(info)
        got, want = pb._tokenize(cre_df, gene, gene_id), jb._tokenize(cre_df, gene, gene_id)
        for field in ("gene_id", "strand"):
            assert getattr(got, field) == getattr(want, field)
        for field in ("cre_tokens", "cre_tok_len", "cre_labels", "gene_tokens", "gene_tok_len"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), field)

"""The port's VariantProcessor.predict against the JAX package's, on the CPU
at float32.

``VariantProcessor.predict(device="cpu")`` and the JAX package's
``VariantProcessor`` (``impl="xla"``) score the same variants on the genome
of ``tests/test_api_end_to_end.py`` with the same ``init_seq2gene`` weights
(brought across by the weight bridge): with ref-once on and off, k 1 and 2,
dedup on and off, ``canonical_cres`` and ``chunks``, and in the
six-population mode on synthesised artifacts. Every non-float column of the
long frame must be equal and the floats within 1e-4; ``format_scores`` and
``eqtl_scores`` (log2fc and Poisson) too.
"""

import pandas as pd
import pytest

from tests.test_api_end_to_end import fixture_env  # noqa: F401  (the genome fixture)
from tests.test_torch_vep_host import _cre_maps, _write_artifacts
from tests.test_torch_vep_model import (  # noqa: F401  (fixtures)
    _assert_frames_match,
    _jax_native_loaded,
    _jax_processor,
    _no_remote_fetch,
    _port_processor,
    _variant_df,
    model,
)

# 130/321 CRE only, 600 gene only, 721/755 gene + CRE on GENEPLUS; 1750 CRE
# only and 2300 gene only on GENEMINUS; 50 no overlap. 600 lists one tissue.
POSITIONS = (130, 321, 600, 721, 755, 1750, 2300, 50)


def _tissues(pos):
    return "tissue1" if pos == 600 else "tissue0,tissue2"


# -- predict against the JAX package ------------------------------------------------------

@pytest.mark.parametrize("ref_once,k,dedup,extra", [
    ("1", 1, "1", {}),
    ("0", 1, "0", {"canonical_cres": 96}),
    ("1", 2, "0", {}),
    ("0", 2, "1", {"chunks": 2, "chunk_id": 1}),
], ids=["ref_once-k1-dedup", "triples-k1-plain-canonical", "ref_once-k2-plain",
        "triples-k2-dedup-chunk"])
def test_predict_matches_jax(fixture_env, model, tmp_path, monkeypatch, ref_once, k, dedup,
                             extra):
    monkeypatch.setenv("VFX_VEP_REF_ONCE", ref_once)
    monkeypatch.setenv("VFX_VEP_DEDUP", dedup)
    var_df = _variant_df(fixture_env["seq"], POSITIONS, _tissues)
    args = dict(vcf_path=fixture_env["vcf"], sample_name="S1", variants_per_dispatch=k, **extra)
    jp = _jax_processor(fixture_env, model)
    want = jp.predict(var_df, str(tmp_path / "jax"), **args)
    proc = _port_processor(fixture_env, model)
    got = proc.predict(var_df, str(tmp_path / "port"), **args)
    _assert_frames_match(got, want)
    assert set(got["variant_type"]) == (
        {"CRE overlap only", "Gene and CRE overlap", "Gene overlap only", "No overlap"}
        if "chunks" not in extra else set(want["variant_type"]))
    stats = proc.vep_stats
    assert stats["dispatches"] > 0 and stats["precomputed_fallbacks"] > 0
    assert (stats.get("ref_hits", 0) > 0) == (ref_once == "1")
    assert not proc._ref_pins
    scores = proc.format_scores(got)
    want_scores = jp.format_scores(want)
    pd.testing.assert_frame_equal(scores, want_scores, rtol=1e-4, atol=1e-4)
    for score in ("log2fc", "poisson"):
        pd.testing.assert_frame_equal(proc.eqtl_scores(scores, score),
                                      jp.eqtl_scores(want_scores, score), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="already processed"):
        proc.predict(var_df, str(tmp_path / "port"), **args)


def test_predict_six_populations_matches_jax(fixture_env, model, tmp_path, monkeypatch):
    monkeypatch.setenv("VFX_ARTIFACTS_DIR", str(tmp_path / "arts"))
    maps = _cre_maps(fixture_env)
    maps["GENEMINUS.1"] = maps["GENEMINUS.1"].iloc[:2]  # the fixture's own CRE map
    _write_artifacts(tmp_path / "arts", fixture_env["seq"], maps,
                     ("REF_HG38", "EAS", "EUR", "AFR", "SAS", "AMR"))
    var_df = _variant_df(fixture_env["seq"], (721, 2300))
    jp = _jax_processor(fixture_env, model)
    want = jp.predict(var_df, str(tmp_path / "jax"))
    proc = _port_processor(fixture_env, model)
    got = proc.predict(var_df, str(tmp_path / "port"))
    _assert_frames_match(got, want)
    assert len(set(got["population"])) == 6 and "precomputed_fallbacks" not in proc.vep_stats
    pd.testing.assert_frame_equal(proc.format_scores(got), jp.format_scores(want),
                                  rtol=1e-4, atol=1e-4)

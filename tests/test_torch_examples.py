"""The port's example flows (``variantformer_tpu_torch/examples``) in
synthetic mode on the CPU, with the assertions of ``tests/test_examples.py``,
and against the JAX package's flows (``examples/``):

* ``synthetic_env`` writes the JAX one's files byte for byte, with an equal
  config;
* ``vcf2exp`` and ``variant2exp`` given the JAX flows' weights match them at
  the JAX package's end-to-end bounds (5e-2 of max |ref| on predictions, 6e-2
  on embeddings: both run the bf16 synthetic config);
* the real mode names the files that the artifact downloader writes.

No test fetches: the artifacts' remote transport of both packages fails at
once, so REF_HG38 takes the local consensus.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from tests.torch_port_helpers import port_config
from variantformer_tpu.models.init import init_seq2gene as jax_init
from variantformer_tpu_torch.examples import (
    _common,
    eqtl_analysis,
    finetune_seq2gene,
    live_app,
    snp_indel_predictions,
    variant2exp,
    variant2risk,
    vcf2embed,
    vcf2exp,
    vcf2risk,
)

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
JAX_FLOWS = ("vcf2exp", "variant2exp", "_common")
PRED_TOL, EMB_TOL = 5e-2, 6e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tiny models' many small operations run no
    faster on more, and the suite's other workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _no_artifacts_no_fetch(monkeypatch, tmp_path):
    from variantformer_tpu.utils import assets as jax_assets
    from variantformer_tpu_torch.utils import assets

    def refuse(self, rel, dst):
        raise RuntimeError(f"no remote fetch in the tests ({rel})")

    monkeypatch.setattr(assets.CachedFetcher, "_default_transport", refuse)
    monkeypatch.setattr(jax_assets.CachedFetcher, "_default_transport", refuse)
    monkeypatch.setenv("VFX_FETCH_RETRY_TIMEOUT", "0")
    monkeypatch.setenv("VFX_ARTIFACTS_DIR", str(tmp_path / "artifacts"))


# -- every flow, as tests/test_examples.py runs the JAX package's -------------

def test_vcf2exp_example(tmp_path):
    out = vcf2exp.main(tmp_path, device="cpu")
    assert len(out) == 2
    assert (tmp_path / "vcf2exp_app.html").stat().st_size > 0


def test_variant2exp_example(tmp_path):
    eqtl = variant2exp.main(tmp_path, device="cpu")
    assert any("log2fc" in c for c in eqtl.columns)


def test_vcf2risk_example(tmp_path):
    out = vcf2risk.main(tmp_path, device="cpu")
    assert "ad_risk" in out.columns
    assert ((out["ad_risk"] >= 0) & (out["ad_risk"] <= 1)).all()


def test_vcf2embed_example(tmp_path):
    df = vcf2embed.main(tmp_path, device="cpu")
    assert {"x", "y"}.issubset(df.columns)
    assert len(df) == 8 and np.isfinite(df[["x", "y"]].to_numpy()).all()


def test_eqtl_analysis_example(tmp_path):
    scored = eqtl_analysis.main(tmp_path, device="cpu")
    # >= 3 associations per tissue, so the per-tissue Spearman statistic
    # is computed, not only the scoring plumbing.
    result = eqtl_analysis.spearman_by_tissue(scored, "slope", "VF-SAMPLE-2-exp-log2fc")
    assert len(result) >= 1
    assert result["n"].min() >= 3
    assert np.isfinite(result["spearman_r"]).all()


def test_snp_indel_predictions_example(tmp_path):
    out = snp_indel_predictions.main(tmp_path, device="cpu")
    assert {"with_variants", "reference", "delta"} <= set(out.columns)
    assert len(out) >= 2


def test_variant2risk_example(tmp_path):
    out = variant2risk.main(tmp_path, device="cpu")
    assert {"risk_no_edit", "risk_hom_edit", "delta"} <= set(out.columns)
    assert len(out) >= 1


def test_finetune_example(tmp_path):
    res, out = finetune_seq2gene.main(tmp_path / "ft", device="cpu")
    assert res.history[-1]["val_loss"] < res.history[0]["val_loss"]
    assert len(out) == 2
    assert (tmp_path / "ft" / "finetuned" / "params.pt").exists()


def test_live_app_example(tmp_path):
    """``--once``: a base prediction and an in-silico edit over HTTP."""
    got = live_app.main(tmp_path, device="cpu")
    base, edited = got["base"], got["edited"]
    assert list(base["values"]) == ["tissue0", "tissue1", "tissue2"]
    assert np.isfinite(list(base["values"].values())).all()
    assert edited is not None and list(edited["values"]) == list(base["values"])


def test_flow_runs_as_a_module(tmp_path):
    """``python -m variantformer_tpu_torch.examples.vcf2exp --device cpu``."""
    proc = subprocess.run(
        [sys.executable, "-m", "variantformer_tpu_torch.examples.vcf2exp", "--device", "cpu",
         "--root", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "GENE2.1" in proc.stdout and (tmp_path / "vcf2exp_app.html").exists()


# -- against the JAX package's flows -------------------------------------------

@pytest.fixture
def jax_common(monkeypatch, tmp_path):
    """The JAX package's ``examples/_common`` (a top-level ``_common``, no
    clash with the port's), its environment under ``tmp_path`` and its
    explorer page there too."""
    from variantformer_tpu.api import webapp

    for mod in JAX_FLOWS:
        sys.modules.pop(mod, None)
    monkeypatch.syspath_prepend(str(EXAMPLES))
    import _common as jc

    build = jc.build_processor
    monkeypatch.setattr(jc, "build_processor",
                        lambda synthetic_root=None: build(str(tmp_path / "jax_env")))
    app = webapp.vcf2exp_app
    monkeypatch.setattr(webapp, "vcf2exp_app",
                        lambda df, out_path, **kw: app(df, tmp_path / "jax_app.html", **kw))
    yield jc
    for mod in JAX_FLOWS:
        sys.modules.pop(mod, None)


def _jax_weights(monkeypatch, jc, tmp_path):
    """Hand the JAX flows' synthetic weights to the port's flows."""
    _, cfg, _ = jc.synthetic_env(tmp_path / "jax_env")
    tree = jax.tree.map(np.asarray, jax_init(jax.random.key(0), cfg))
    monkeypatch.setattr(_common, "synthetic_params", lambda cfg, device: tree)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), f"{what}: {err}"


def test_synthetic_env_matches_jax(jax_common, tmp_path):
    jax_sources, jax_cfg, jax_extras = jax_common.synthetic_env(tmp_path / "jax")
    sources, cfg, extras = _common.synthetic_env(tmp_path / "port")
    for name in ("genome.fa", "gencode.csv", "donor.vcf.gz", "tissues.yaml"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())
    assert dataclasses.asdict(cfg) == dataclasses.asdict(port_config(jax_cfg))
    assert extras["variant"] == jax_extras["variant"]
    assert Path(extras["vcf"]).name == Path(jax_extras["vcf"]).name
    for gene in ("GENE1.1", "GENE2.1"):
        pd.testing.assert_frame_equal(sources.cre_map_provider(gene),
                                      jax_sources.cre_map_provider(gene))
    assert sources.bpe_vocab_path == jax_sources.bpe_vocab_path


def test_vcf2exp_matches_the_jax_flow(jax_common, monkeypatch, tmp_path):
    import vcf2exp as jax_vcf2exp

    _jax_weights(monkeypatch, jax_common, tmp_path)
    want = jax_vcf2exp.main()
    got = vcf2exp.main(tmp_path / "port", device="cpu")
    assert list(got["gene_id"]) == list(want["gene_id"])
    assert [list(t) for t in got["tissue_names"]] == [list(t) for t in want["tissue_names"]]
    _close(np.stack(got["predicted_expression"]), np.stack(want["predicted_expression"]),
           PRED_TOL, "predicted_expression")
    _close(np.stack(got["embeddings"]), np.stack(want["embeddings"]), EMB_TOL, "embeddings")


def test_variant2exp_matches_the_jax_flow(jax_common, monkeypatch, tmp_path):
    """The pivoted ref/het/hom expression columns at the end-to-end bound;
    the eQTL frame's rows and columns the same."""
    import variant2exp as jax_variant2exp
    from variantformer_tpu.api.variantprocessor import VariantProcessor as JaxVP
    from variantformer_tpu_torch.api.variantprocessor import VariantProcessor

    _jax_weights(monkeypatch, jax_common, tmp_path)
    monkeypatch.setattr(jax_variant2exp, "synthetic_env",
                        lambda root: jax_common.synthetic_env(tmp_path / "jax_env"))
    pivoted = {}
    for name, cls in (("jax", JaxVP), ("port", VariantProcessor)):
        fmt = cls.format_scores

        def spy(self, df, _fmt=fmt, _name=name):
            pivoted[_name] = _fmt(self, df)
            return pivoted[_name]

        monkeypatch.setattr(cls, "format_scores", spy)
    want = jax_variant2exp.main()
    got = variant2exp.main(tmp_path / "port", device="cpu")
    keys = ["variant_id", "genes", "tissues"]
    assert list(got.columns) == list(want.columns)
    pd.testing.assert_frame_equal(got[keys], want[keys])
    p, j = (pivoted[k].sort_values(keys).reset_index(drop=True) for k in ("port", "jax"))
    exp_cols = [c for c in j.columns if str(c).endswith("-exp")]
    assert len(exp_cols) == 6 and list(p.columns) == list(j.columns)
    _close(p[exp_cols].to_numpy(), j[exp_cols].to_numpy(), PRED_TOL, "ref/het/hom expression")


def test_real_sources_name_the_downloaders_files(jax_common):
    """The real mode names what ``data/download_artifacts.py`` writes; the
    JAX examples' checkpoint name is not among them."""
    from variantformer_tpu.data.download_artifacts import ARTIFACTS

    written = {a.local_path for a in ARTIFACTS}
    for model_class in ("v4_pcg", "v4_ag"):
        sources, cfg = _common.real_sources(model_class)
        assert cfg.model_class == model_class
        for path in (sources.fasta_path, sources.gencode_path, sources.checkpoint_path,
                     sources.tokenizer_checkpoint_path):
            assert Path(path).name in written, path
        assert Path(sources.af_path).name == "1KG_af_hg38_tables"
        jax_sources, _ = jax_common.real_sources(model_class)
        assert Path(jax_sources.checkpoint_path).name not in written
    assert not _common.artifacts_present()


def test_build_processor_runs_where_asked(tmp_path):
    proc, extras = _common.build_processor(tmp_path / "env", device="cpu")
    assert proc.device.type == "cpu" and Path(extras["vcf"]).exists()
    assert proc.config.seq2gene.emb_dim == 32

"""The port's AD-risk head against the JAX package's, on the CPU.

* ``TreeEnsemble.raw_margin`` (and ``predict_proba``, ``__call__``) the same
  bits as the JAX package's on the same arrays: ``chip_smoke.py``'s seeded
  ensembles and an sklearn model's conversion;
* ``from_sklearn_gbm`` gives the JAX package's arrays (sklearn is optional);
* ``.npz`` files saved by either package load in the other;
* ``torch_predict_margin`` on the CPU against ``jax_predict_margin`` at
  rtol 1e-4 / atol 1e-5;
* ``ADriskFromVCF`` and ``ADrisk`` over the port's ``VCFProcessor``
  (``device="cpu"``) against the JAX package's (``impl="xla"``, f32) within
  1e-4 on the embeddings and ``ad_risk``, on the genome of
  ``tests/test_api_end_to_end.py``;
* ``load_predictor`` raises the JAX package's error on a non-``.npz`` path
  without treelite.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_api_end_to_end import fixture_env  # noqa: F401  (the genome fixture)
from tests.test_torch_sweeps import _vcf_processors
from tests.test_torch_vep_model import _jax_native_loaded, model  # noqa: F401  (fixtures)
from variantformer_tpu.api import ad_risk as jax_ad
from variantformer_tpu_torch.api import ad_risk

FIELDS = ("feature", "threshold", "left", "right", "value", "tree_offsets")


def _seeded(seed, n_trees, n_features, max_depth=6):
    lo, hi = -np.ones(n_features), np.ones(n_features)
    return chip_smoke.seeded_ensemble(seed, n_trees, lo, hi, max_depth=max_depth)


def _as_jax(ens):
    return jax_ad.TreeEnsemble(**{f: getattr(ens, f) for f in FIELDS},
                               base_score=ens.base_score, objective=ens.objective)


@pytest.fixture(scope="module")
def fitted_gbm():
    pytest.importorskip("sklearn")
    from sklearn.ensemble import GradientBoostingClassifier

    rng = np.random.default_rng(0)
    x = rng.standard_normal((400, 24)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 3] - x[:, 7] > 0).astype(int)
    gbm = GradientBoostingClassifier(n_estimators=20, max_depth=3, random_state=0).fit(x, y)
    return gbm, x


def test_seeded_ensemble_shape():
    """The smoke run's ensemble: depth <= 6, absolute child ids, leaves with
    feature -1 and rows in the features' range reaching many leaves."""
    ens = _seeded(0, 50, 32)
    assert len(ens.tree_offsets) == 50 and ens.tree_offsets[0] == 0
    internal = ens.feature >= 0
    assert (ens.left[internal] > np.flatnonzero(internal)).all()
    assert (ens.value[internal] == 0).all() and (ens.feature < 32).all()
    x = np.random.default_rng(1).uniform(-1, 1, (2000, 32)).astype(np.float32)
    margins = ens.raw_margin(x)
    assert np.unique(margins).size > 1000
    depth = ad_risk.torch_predict_margin(ens, x, max_depth=6, device="cpu")
    np.testing.assert_allclose(depth.numpy(), margins, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed,n_trees,n_features", [(0, 40, 16), (3, 200, 1536)])
def test_raw_margin_bit_equal_jax(seed, n_trees, n_features):
    ens = _seeded(seed, n_trees, n_features)
    x = np.random.default_rng(seed).uniform(-1.2, 1.2, (300, n_features)).astype(np.float32)
    ref = _as_jax(ens)
    assert np.array_equal(ens.raw_margin(x), ref.raw_margin(x))
    assert np.array_equal(ens.predict_proba(x), ref.predict_proba(x))
    assert np.array_equal(ens(x), ref(x))
    assert np.array_equal(ens.raw_margin(x[0]), ref.raw_margin(x[0]))


def test_from_sklearn_gbm_equal_jax(fitted_gbm):
    gbm, x = fitted_gbm
    got = ad_risk.TreeEnsemble.from_sklearn_gbm(gbm)
    want = jax_ad.TreeEnsemble.from_sklearn_gbm(gbm)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert got.base_score == want.base_score and got.objective == want.objective
    assert np.array_equal(got(x), want(x))
    np.testing.assert_allclose(got(x), gbm.predict_proba(x)[:, 1], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_loads_across_packages(tmp_path, writer):
    ens = _seeded(5, 30, 24)
    path = str(tmp_path / "predictor.npz")
    (ens if writer == "port" else _as_jax(ens)).save(path)
    reader = jax_ad.TreeEnsemble if writer == "port" else ad_risk.TreeEnsemble
    loaded = reader.load(path)
    for f in FIELDS:
        assert np.array_equal(getattr(loaded, f), getattr(ens, f)), f
    assert loaded.base_score == ens.base_score and loaded.objective == ens.objective
    x = np.random.default_rng(0).uniform(-1, 1, (64, 24)).astype(np.float32)
    assert np.array_equal(loaded.raw_margin(x), ens.raw_margin(x))
    assert isinstance(ad_risk.load_predictor(path), ad_risk.TreeEnsemble)


@pytest.mark.parametrize("which", ["seeded", "sklearn"])
def test_torch_predict_margin_matches_jax(which, request):
    if which == "sklearn":
        gbm, x = request.getfixturevalue("fitted_gbm")
        ens, x = ad_risk.TreeEnsemble.from_sklearn_gbm(gbm), x[:50]
    else:
        ens = _seeded(2, 120, 64)
        x = np.random.default_rng(2).uniform(-1.1, 1.1, (257, 64)).astype(np.float32)
    got = ad_risk.torch_predict_margin(ens, torch.from_numpy(x), device="cpu")
    assert got.dtype == torch.float32 and got.shape == (len(x),)
    want = np.asarray(jax_ad.jax_predict_margin(_as_jax(ens), jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ens.raw_margin(x), rtol=1e-4, atol=1e-5)
    # a single row as a 1-D vector, as numpy
    one = ad_risk.torch_predict_margin(ens, x[3], device="cpu")
    np.testing.assert_allclose(one.numpy(), got.numpy()[3:4], rtol=1e-6, atol=1e-7)


class _Manifest:
    def __init__(self, paths):
        self.paths = paths

    def get_file_path(self, gene_id, tissue_id):
        return self.paths.get((gene_id, tissue_id))


def test_ad_risk_from_vcf_matches_jax(fixture_env, model, tmp_path):
    """Three (gene, tissue) rows, one without a predictor (NaN risk)."""
    cfg, _ = model
    port, jax_proc = _vcf_processors(fixture_env, model)
    e = cfg.seq2gene.emb_dim
    ens = _seeded(7, 60, e)
    path = str(tmp_path / "g_t.npz")
    ens.save(path)
    manifest = _Manifest({("GENEPLUS.1", 0): path, ("GENEMINUS.1", 2): path})
    args = (fixture_env["vcf"], ["GENEPLUS.1", "GENEMINUS.1", "GENEPLUS.1"], [0, 2, 5])
    got = ad_risk.ADriskFromVCF(port, manifest=manifest)(*args)
    want = jax_ad.ADriskFromVCF(jax_proc, manifest=manifest)(*args)
    assert list(got.columns) == list(want.columns)
    for col in ("gene_id", "tissue_id", "tissue_names", "tissue_name"):
        assert got[col].to_list() == want[col].to_list(), col
    for col in ("predicted_expression", "embedding"):
        np.testing.assert_allclose(np.stack(got[col].to_list()), np.stack(want[col].to_list()),
                                   rtol=1e-4, atol=1e-4, err_msg=col)
    np.testing.assert_allclose(got["ad_risk"], want["ad_risk"], rtol=1e-4, atol=1e-4)
    risks = got["ad_risk"].to_numpy()
    assert np.isnan(risks[2]) and ((risks[:2] >= 0) & (risks[:2] <= 1)).all()
    for i in (0, 1):
        assert risks[i] == ens(np.atleast_2d(got["embedding"][i][0]))[0]

    # ADrisk on the returned embeddings, and its missing-predictor error
    for mod in (ad_risk, jax_ad):
        head = mod.ADrisk("GENEPLUS.1", 0, manifest=manifest)
        np.testing.assert_allclose(head(got["embedding"][0][0]), risks[:1], rtol=1e-6)
        with pytest.raises(FileNotFoundError, match="GENEPLUS.1 / tissue 5"):
            mod.ADrisk("GENEPLUS.1", 5, manifest=manifest)


def test_load_predictor_error_without_treelite(tmp_path, monkeypatch):
    """A non-.npz path without treelite: both packages raise the same
    RuntimeError."""
    monkeypatch.setitem(sys.modules, "treelite", None)
    path = str(tmp_path / "predictor.bin")
    errors = []
    for mod in (ad_risk, jax_ad):
        with pytest.raises(RuntimeError) as info:
            mod.load_predictor(path)
        assert isinstance(info.value.__cause__, ImportError)
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "treelite" in errors[0]


def test_smoke_manifest_is_a_manifest():
    m = chip_smoke.DictManifest({("G", 1): "p.npz"})
    assert m.get_file_path("G", 1) == "p.npz" and m.get_file_path("G", 2) is None

"""The port's reports, web apps and profiling helpers against the JAX
package's, on the CPU.

Every HTML writer of the port (``api/anatomagram.py``,
``api/visualization.py``, ``api/webapp.py``) must write the same bytes as
the JAX package's for the same frames, including names that would break an
inline script; ``StageTimer`` keeps the JAX package's semantics (and adds up
across threads); ``device_trace`` writes a ``torch.profiler`` trace file.
"""

import json
import os
import re
import sys
import threading
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from variantformer_tpu.api import anatomagram as jax_anat
from variantformer_tpu.api import visualization as jax_vis
from variantformer_tpu.api import webapp as jax_web
from variantformer_tpu_torch.api import anatomagram, visualization, webapp
from variantformer_tpu_torch.utils.profiling import StageTimer, device_trace

EVIL = "G1</script><script>alert(1)//"
VALUES = {
    "liver": 2.0, "brain - cortex": 0.5, "lung": 1.0,
    "kidney - cortex": 0.8, "K562": 0.3, "whole blood": 1.4,
    "skin - sun exposed (lower leg)": 0.9,
    "skin - not sun exposed (suprapubic)": 0.2,
    "testis": 0.4, "uterus": 0.6, "brain - cerebellum": 1.1,
}


def _same_bytes(port_fn, jax_fn, tmp_path, name, *args, **kwargs):
    """Call both writers with the same arguments; their files must be equal."""
    got = port_fn(*args, tmp_path / f"port_{name}", **kwargs)
    want = jax_fn(*args, tmp_path / f"jax_{name}", **kwargs)
    a, b = Path(got).read_bytes(), Path(want).read_bytes()
    assert a == b, name
    assert got.endswith(f"port_{name}")
    return a.decode()


def _pred_df(gene_ids=("GENE1.1", "GENE2.1")):
    tissues = ["liver", "lung", "heart - left ventricle", "K562"]
    rng = np.random.default_rng(0)
    return pd.DataFrame({
        "gene_id": list(gene_ids),
        "tissue_names": [tissues] * len(gene_ids),
        "predicted_expression": [[float(v) for v in rng.uniform(0, 9, 4)] for _ in gene_ids],
    })


# -- StageTimer and device_trace -------------------------------------------------------------

def test_stage_timer():
    t = StageTimer()
    with t.stage("tokenize"):
        pass
    with t.stage("tokenize"):
        pass
    with t.stage("device"):
        pass
    s = t.summary()
    assert s["tokenize"]["count"] == 2
    assert s["device"]["count"] == 1
    assert list(s) == ["device", "tokenize"]
    assert set(s["device"]) == {"total_s", "count", "mean_ms"}
    t.log_summary("test")
    with pytest.raises(ValueError):
        with t.stage("failing"):
            raise ValueError("x")
    assert t.counts["failing"] == 1  # a stage that raises is still counted


def test_stage_timer_adds_up_across_threads():
    """More threads than cores, switching every microsecond: no update of
    the shared totals is lost (the sweeps time their host builds from a
    pool)."""
    t = StageTimer()
    n_threads, n_stages = 2 * (os.cpu_count() or 4), 300

    def work():
        for _ in range(n_stages):
            with t.stage("build"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert t.counts["build"] == n_threads * n_stages
    assert t.summary()["build"]["count"] == n_threads * n_stages


def test_device_trace_writes_a_trace(tmp_path):
    a = torch.randn(64, 64)
    with device_trace(str(tmp_path / "trace")) as prof:
        (a @ a).sum()
    path = Path(prof.trace_file)
    assert path.parent == tmp_path / "trace" and path.exists()
    names = {ev.get("name") for ev in json.loads(path.read_text())["traceEvents"]}
    assert "aten::mm" in names


# -- anatomagram -----------------------------------------------------------------------------

def test_uberon_map_and_regions_equal_jax():
    assert anatomagram.load_tissue_uberon_map() == jax_anat.load_tissue_uberon_map()
    for agg in ("max", "mean"):
        assert anatomagram.region_values(VALUES, agg) == jax_anat.region_values(VALUES, agg)
    regions, cell_lines = anatomagram.region_values(VALUES)
    assert regions["UBERON_0000014"][0] == 0.9 and len(regions["UBERON_0000014"][1]) == 2
    assert cell_lines == ["K562"]


@pytest.mark.parametrize("view", ["male", "female", "brain"])
def test_anatomagram_svg_equal_jax(view):
    got = anatomagram.anatomagram_svg(VALUES, view=view)
    assert got == jax_anat.anatomagram_svg(VALUES, view=view)
    assert got.startswith("<svg") and got.endswith("</svg>")


@pytest.mark.parametrize("aggregation", ["max", "mean"])
def test_anatomagram_html_equal_jax(tmp_path, aggregation):
    page = _same_bytes(anatomagram.anatomagram_html, jax_anat.anatomagram_html, tmp_path,
                       "a.html", {"APOE": VALUES, EVIL: {"liver": 1.0}},
                       aggregation=aggregation)
    assert "APOE" in page and "<svg" in page and "K562" in page


def test_anatomagram_adapters_equal_jax(tmp_path):
    risk = pd.DataFrame({"tissue_name": ["liver", "brain - cortex", "whole blood"],
                         "ad_risk": [0.7, 0.9, 0.2]})
    page = _same_bytes(anatomagram.anatomagram_from_risk_df, jax_anat.anatomagram_from_risk_df,
                       tmp_path, "risk.html", risk)
    assert "AD_RISK" in page and "UBERON_0000956" in page
    _same_bytes(anatomagram.anatomagram_from_prediction_df,
                jax_anat.anatomagram_from_prediction_df, tmp_path, "pred.html", _pred_df())


# -- visualization ---------------------------------------------------------------------------

def test_expression_report_equal_jax(tmp_path):
    preds = {"GENE1": {"liver": 1.5, "brain - cortex": 0.2, "K562": 0.9},
             EVIL: {"lung": 0.0, "liver": 0.0}}
    page = _same_bytes(visualization.expression_report, jax_vis.expression_report, tmp_path,
                       "report.html", preds)
    assert "GENE1" in page and "nervous system" in page and "</script><script>" not in page
    assert visualization.tissue_group("K562") == "cell lines"
    assert visualization.tissue_group("liver") == "digestive"
    _same_bytes(visualization.report_from_prediction_df, jax_vis.report_from_prediction_df,
                tmp_path, "report_df.html", _pred_df())


@pytest.mark.parametrize("color", [None, "cluster"])
def test_scatter_html_equal_jax(tmp_path, color):
    rng = np.random.default_rng(1)
    df = pd.DataFrame({"x": rng.normal(size=12), "y": rng.normal(size=12),
                       "gene_id": [EVIL, "G2", "G3"] * 4,
                       "cluster": [f"cluster {i % 3}" for i in range(12)]})
    page = _same_bytes(visualization.scatter_html, jax_vis.scatter_html, tmp_path,
                       "scatter.html", df, color=color, hover=["gene_id"])
    assert page.count("<circle") == 12


# -- web apps --------------------------------------------------------------------------------

def _embedded_data(page: str) -> dict:
    m = re.search(r"const DATA = (.*?);\n", page)
    assert m, "embedded DATA payload missing"
    for ref in set(re.findall(r"getElementById\('([^']+)'\)", page)):
        assert f"id='{ref}'" in page, f"JS references missing element #{ref}"
    return json.loads(m.group(1))


def test_vcf2exp_app_equal_jax(tmp_path):
    df = _pred_df()
    page = _same_bytes(webapp.vcf2exp_app, jax_web.vcf2exp_app, tmp_path, "exp.html", df)
    assert _embedded_data(page)["GENE1.1"]["liver"] == df["predicted_expression"][0][0]
    assert "<script src" not in page and "fetch(" not in page


def test_script_breaking_names_equal_jax(tmp_path):
    """A name holding '</script>' is embedded as '<\\/' by both packages."""
    df = pd.DataFrame({"gene_id": [EVIL], "tissue_names": [["liver"]],
                       "predicted_expression": [[1.5]]})
    page = _same_bytes(webapp.vcf2exp_app, jax_web.vcf2exp_app, tmp_path, "evil.html", df)
    data_line = re.search(r"const DATA = (.*?);\n", page).group(1)
    assert "</script" not in data_line and json.loads(data_line)[EVIL]["liver"] == 1.5
    assert page.count("</script>") == 1
    assert webapp._json_embed({"a": EVIL}) == jax_web._json_embed({"a": EVIL})


def test_vcf2risk_app_equal_jax(tmp_path):
    df = pd.DataFrame({"tissue_name": ["liver", "brain - cortex", "lung"],
                       "ad_risk": [0.7, 0.4, 0.55]})
    page = _same_bytes(webapp.vcf2risk_app, jax_web.vcf2risk_app, tmp_path, "risk.html", df,
                       threshold=0.5)
    assert _embedded_data(page) == {"liver": 0.7, "brain - cortex": 0.4, "lung": 0.55}
    assert "value='0.5'" in page


def test_vcf2embed_app_equal_jax(tmp_path):
    df = pd.DataFrame({
        "gene_id": ["G1", "G1", "G2", EVIL],
        "tissue": ["liver", "lung", "liver", "lung"],
        "predicted_expression": [1.0, 2.0, 3.0, 4.0],
        "cluster": ["cluster 0", "cluster 1", "cluster 0", "cluster 1"],
        "x": np.asarray([0.0, 1.0, 2.0, 3.0], np.float32),
        "y": np.asarray([3.0, 2.0, 1.0, 0.0], np.float32),
    })
    page = _same_bytes(webapp.vcf2embed_app, jax_web.vcf2embed_app, tmp_path, "embed.html", df)
    data = _embedded_data(page)
    assert len(data["rows"]) == 4 and data["rows"][0]["x"] == 0.0
    assert set(data["catCols"]) == {"gene_id", "tissue", "cluster"}


def test_shell_and_blank_views_equal_jax():
    views = ("male", "female", "brain")
    assert webapp._blank_views(views) == jax_web._blank_views(views)
    args = ("title <x>", "<div id='a'></div>", {"k": EVIL}, "const X = 1;")
    assert webapp._shell(*args) == jax_web._shell(*args)

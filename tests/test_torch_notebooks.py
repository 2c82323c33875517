"""The port's notebooks (``variantformer_tpu_torch/notebooks``), generated by
``variantformer_tpu_torch/scripts/make_notebooks.py``, on the CPU:

* the committed notebooks are what the generator writes, without outputs,
  and valid ``nbformat`` documents;
* the flagships are narratives (>= 6 code and >= 5 markdown cells, as
  ``tests/test_examples.py`` asks of the JAX package's), their prose states
  nothing of a TPU, and each notebook opens with one ``parameters`` cell;
* each notebook runs in this process in synthetic mode with
  ``DEVICE = "cpu"`` (``scripts/run_notebook.py``), rendering what the JAX
  package's notebooks render (HTML, an inline chart, the anatomagram);
* the vcf2exp notebook's frame matches the JAX package's vcf2exp flow on
  shared weights at the end-to-end bounds (5e-2 / 6e-2 of max |ref|);
* the vcf2exp notebook runs under ``nbclient`` with a real ``python3``
  kernel, as the JAX package's notebooks are run.

``tests/test_torch_package.py`` holds the code cells free of JAX imports.
No test fetches: the artifacts' remote transport fails at once.
"""

import ast
import sys

import nbformat
import numpy as np
import pytest
import torch

from tests.test_torch_examples import EMB_TOL, PRED_TOL, _close, _jax_weights, jax_common  # noqa: F401
from variantformer_tpu_torch.scripts import make_notebooks, run_notebook

NAMES = list(make_notebooks.NOTEBOOKS)
FLAGSHIPS = ["vcf2exp", "variant2exp", "vcf2risk", "eqtl_analysis"]
NB_DIR = make_notebooks.NOTEBOOKS_DIR


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


def _read(name):
    return nbformat.read(NB_DIR / f"{name}.ipynb", as_version=4)


# -- the documents ------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_committed_notebook_is_the_generated_one(name):
    got, want = _read(name), make_notebooks.build()[name]
    assert got.metadata == want.metadata
    assert [(c.id, c.cell_type, c.source, c.metadata) for c in got.cells] == [
        (c.id, c.cell_type, c.source, c.metadata) for c in want.cells]
    assert all(not c.get("outputs") and c.get("execution_count") is None
               for c in got.cells if c.cell_type == "code")


def test_generator_writes_the_committed_bytes(tmp_path):
    assert make_notebooks.main(["--out", str(tmp_path)]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        p.name for p in NB_DIR.glob("*.ipynb"))
    for path in tmp_path.iterdir():
        assert path.read_bytes() == (NB_DIR / path.name).read_bytes(), path.name


def test_notebooks_ship_as_package_data():
    import tomllib

    conf = tomllib.loads((NB_DIR.parent.parent / "pyproject.toml").read_text())
    assert conf["tool"]["setuptools"]["package-data"]["variantformer_tpu_torch"] == [
        "notebooks/*.ipynb"]
    assert sorted(p.stem for p in NB_DIR.glob("*.ipynb")) == sorted(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_notebook_is_valid(name):
    notebook = _read(name)
    nbformat.validate(notebook)
    assert {"markdown", "code"} <= {c.cell_type for c in notebook.cells}


@pytest.mark.parametrize("name", FLAGSHIPS)
def test_flagship_is_a_narrative(name):
    cells = _read(name).cells
    code = [c for c in cells if c.cell_type == "code"]
    md = [c for c in cells if c.cell_type == "markdown"]
    assert len(code) >= 6 and len(md) >= 5, (len(code), len(md))


@pytest.mark.parametrize("name", NAMES)
def test_prose_states_nothing_of_a_tpu(name):
    for cell in _read(name).cells:
        if cell.cell_type == "markdown":
            assert "TPU" not in cell.source and "v5e" not in cell.source, cell.id


@pytest.mark.parametrize("name", NAMES)
def test_parameters_cell(name):
    """One code cell tagged ``parameters``, right after the title: the card
    (``DEVICE = "cuda"``) and no work directory yet; vcf2exp's also holds
    its query. No other cell assigns those names."""
    cells = _read(name).cells
    tagged = [i for i, c in enumerate(cells) if "parameters" in c.metadata.get("tags", [])]
    assert tagged == [1] and cells[0].cell_type == "markdown"
    values = {t.id: ast.literal_eval(node.value)
              for node in ast.parse(cells[1].source).body for t in node.targets}
    want = {"DEVICE": "cuda", "ROOT": None}
    if name == "vcf2exp":
        want.update(GENES=None, TISSUES=None, VCF_PATH=None)
    assert values == want
    for cell in cells[2:]:
        if cell.cell_type == "code":
            assigned = {t.id for node in ast.walk(ast.parse(cell.source))
                        if isinstance(node, ast.Assign) for t in node.targets
                        if isinstance(t, ast.Name)}
            assert "DEVICE" not in assigned, cell.id


# -- running them -------------------------------------------------------------

def _rich(outputs):
    return [o for o in outputs if o["output_type"] in ("display_data", "execute_result")]


@pytest.mark.parametrize("name", NAMES)
def test_notebook_runs_on_the_cpu(name, tmp_path):
    """Every code cell in order, synthetic mode, ``DEVICE = "cpu"``; the
    flagships render dataframes as HTML and an inline chart, and vcf2exp
    and vcf2risk the anatomagram (as ``tests/test_examples.py`` asks)."""
    done = run_notebook.run(run_notebook.load(name),
                            {"DEVICE": "cpu", "ROOT": str(tmp_path / "nb")})
    assert not done.skipped and not done.stub_ipython
    assert done.namespace["SYNTHETIC"] and done.namespace["ROOT"] == tmp_path / "nb"
    rich = _rich(done.outputs)
    assert rich, "no cell output"
    assert any("text/html" in o["data"] for o in rich), name
    if name in FLAGSHIPS:
        assert any("image/png" in o["data"] for o in rich), f"{name}: no inline chart"
    if name in ("vcf2exp", "vcf2risk"):
        html = [o["data"]["text/html"] for o in rich if "text/html" in o["data"]]
        assert any("anatomagram" in h or "<svg" in h for h in html)
    ns = done.namespace
    if name == "vcf2exp":
        assert len(ns["out"]) == 2 and np.isfinite(ns["cmp"]["log2fc"]).all()
        assert ns["proc"].device.type == "cpu"
    elif name == "variant2exp":
        assert ns["fc_cols"]
    elif name == "vcf2risk":
        assert ((ns["risk"]["ad_risk"] >= 0) & (ns["risk"]["ad_risk"] <= 1)).all()
    elif name == "eqtl_analysis":
        assert len(ns["result"]) >= 1 and ns["result"]["n"].min() >= 3
    elif name == "finetune_seq2gene":
        assert ns["res"].history[-1]["val_loss"] < ns["res"].history[0]["val_loss"]
    # writes under ROOT only (the fetcher makes the empty artifacts directory)
    assert {p.name for p in tmp_path.iterdir()} <= {"nb", "artifacts"}


def test_runner_refuses_unknown_parameters(tmp_path):
    with pytest.raises(run_notebook.NotebookError, match="DEVICES"):
        run_notebook.run(run_notebook.load("vcf2exp"), {"DEVICES": "cpu"})


def test_runner_skips_cells_and_stands_in_for_ipython(monkeypatch, tmp_path):
    """Where IPython is missing the minimal ``IPython.display`` stands in;
    a cell the caller skips (here the plots) is named and not run."""
    monkeypatch.setitem(sys.modules, "IPython", None)
    real = run_notebook.importlib.util.find_spec
    monkeypatch.setattr(run_notebook.importlib.util, "find_spec",
                        lambda n, *a: None if n == "IPython" else real(n, *a))

    def skip(i, src):
        missing = {"matplotlib"} & run_notebook.imported_modules(src)
        return f"needs {missing.pop()}" if missing else None

    done = run_notebook.run(run_notebook.load("vcf2exp"),
                            {"DEVICE": "cpu", "ROOT": str(tmp_path)}, skip=skip)
    assert done.stub_ipython and [r for _, r in done.skipped] == ["needs matplotlib"] * 2
    assert "IPython" not in sys.modules or sys.modules["IPython"] is None
    assert not any("image/png" in o["data"] for o in done.outputs)
    assert any("anatomagram" in o["data"].get("text/html", "") for o in done.outputs)


def test_vcf2exp_notebook_matches_the_jax_flow(jax_common, monkeypatch, tmp_path):  # noqa: F811
    import vcf2exp as jax_vcf2exp

    _jax_weights(monkeypatch, jax_common, tmp_path)
    want = jax_vcf2exp.main()
    got = run_notebook.run(run_notebook.load("vcf2exp"),
                           {"DEVICE": "cpu", "ROOT": str(tmp_path / "nb")}).namespace["out"]
    assert list(got["gene_id"]) == list(want["gene_id"])
    assert [list(t) for t in got["tissue_names"]] == [list(t) for t in want["tissue_names"]]
    _close(np.stack(got["predicted_expression"]), np.stack(want["predicted_expression"]),
           PRED_TOL, "predicted_expression")
    _close(np.stack(got["embeddings"]), np.stack(want["embeddings"]), EMB_TOL, "embeddings")


def test_vcf2exp_runs_under_nbclient(monkeypatch, tmp_path):
    """The document runs as a notebook: a ``python3`` kernel executes it
    with its parameters set to the CPU and a work directory."""
    from nbclient import NotebookClient

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    notebook = _read("vcf2exp")
    notebook.cells[1].source += f'DEVICE = "cpu"\nROOT = {str(tmp_path / "nb")!r}\n'
    client = NotebookClient(notebook, timeout=300, kernel_name="python3",
                            resources={"metadata": {"path": str(NB_DIR)}})
    client.execute()
    outputs = [o for c in notebook.cells if c.cell_type == "code" for o in c.get("outputs", [])]
    assert not any(o.get("output_type") == "error" for o in outputs)
    rich = [o for o in outputs if o.get("output_type") in ("display_data", "execute_result")]
    assert any("text/html" in o.get("data", {}) for o in rich)
    assert any("image/png" in o.get("data", {}) for o in rich)
    assert any("anatomagram" in "".join(o["data"]["text/html"]) for o in rich
               if "text/html" in o.get("data", {}))
    assert (tmp_path / "nb" / "anatomagram_vcf2exp.html").exists()

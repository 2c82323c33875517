"""The port's artifact downloader (``variantformer_tpu_torch/data/
download_artifacts.py``) against the JAX package's, offline:

* the artifact lists are the JAX module's, pair for pair and in order;
* ``validate`` passes, and refuses what the JAX one refuses;
* ``--list`` prints the JAX module's lines;
* ``download`` lands files under the downloader's names through its two
  transports (here copying from a local fake bucket), and a second call
  transports nothing;
* the gold-locus stage resolves the same files as the JAX function through
  local parquet manifests;
* the example flows' real mode reads the downloader's names.

No test opens the network: every transport fails at once unless a test
replaces it with a local copy, and ``VFX_FETCH_RETRY_TIMEOUT=0``.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import pandas as pd
import pytest

from variantformer_tpu.data import download_artifacts as jax_dl
from variantformer_tpu_torch.data import download_artifacts as dl
from variantformer_tpu_torch.examples import _common

REPO = Path(__file__).resolve().parent.parent


def _pairs(arts):
    return [(a.remote_key, a.local_path) for a in arts]


@pytest.fixture(autouse=True)
def _no_network(monkeypatch, tmp_path):
    from variantformer_tpu.utils import assets as jax_assets
    from variantformer_tpu_torch.utils import assets

    def refuse(*args):
        raise RuntimeError(f"no network in the tests ({args[-2]})")

    monkeypatch.setattr(assets.CachedFetcher, "_default_transport", refuse)
    monkeypatch.setattr(jax_assets.CachedFetcher, "_default_transport", refuse)
    monkeypatch.setattr(dl, "_fetch_s3", refuse)
    monkeypatch.setattr(dl, "_fetch_url", refuse)
    monkeypatch.setattr(dl, "_expand_prefix", refuse)
    monkeypatch.setenv("VFX_FETCH_RETRY_TIMEOUT", "0")
    monkeypatch.setenv("VFX_ARTIFACTS_DIR", str(tmp_path / "artifacts"))


@pytest.mark.parametrize("name", ["ARTIFACTS", "PREFIX_ARTIFACTS", "VOCAB_ARTIFACTS"])
def test_artifact_lists_are_the_jax_modules(name):
    assert _pairs(getattr(dl, name)) == _pairs(getattr(jax_dl, name))


def test_gold_loci_and_bucket_are_the_jax_modules():
    assert dl.BUCKET == jax_dl.BUCKET
    assert dl.GOLD_GENES == jax_dl.GOLD_GENES
    assert dl.GOLD_CHROMS == jax_dl.GOLD_CHROMS
    assert dl.GOLD_AD_PREDICTORS == jax_dl.GOLD_AD_PREDICTORS
    url = dl.VOCAB_ARTIFACTS[0]
    assert url.is_url and not dl.ARTIFACTS[0].is_url


@pytest.mark.parametrize("case", ["valid", "duplicate local path", "prefix without /",
                                  "single file ending in /"])
def test_validate(case, monkeypatch):
    """The shipped lists pass; each broken list is refused by both packages
    with the same message."""
    arts, prefixes = list(dl.ARTIFACTS), list(dl.PREFIX_ARTIFACTS)
    if case == "duplicate local path":
        arts.append(dl.Artifact("model/other/checkpoint.pth", arts[0].local_path))
    elif case == "prefix without /":
        prefixes.append(dl.Artifact("model/common/bulk", "bulk"))
    elif case == "single file ending in /":
        arts.append(dl.Artifact("model/common/dir/", "dir/"))
    messages = []
    for mod in (dl, jax_dl):
        cls = mod.Artifact
        monkeypatch.setattr(mod, "ARTIFACTS", [cls(*p) for p in _pairs(arts)])
        monkeypatch.setattr(mod, "PREFIX_ARTIFACTS", [cls(*p) for p in _pairs(prefixes)])
        if case == "valid":
            mod.validate()
            continue
        with pytest.raises(ValueError) as err:
            mod.validate()
        messages.append(str(err.value))
    if case != "valid":
        assert messages[0] == messages[1]


def test_list_prints_the_jax_modules_lines(capsys, monkeypatch):
    dl.main(["--list"])
    port = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["download_artifacts", "--list"])
    jax_dl.main()
    want = capsys.readouterr().out
    assert port.splitlines() == want.splitlines()
    assert len(port.splitlines()) == len(dl.ARTIFACTS) + len(dl.PREFIX_ARTIFACTS)


def test_list_as_a_module():
    """``python -m variantformer_tpu_torch.data.download_artifacts --list``,
    in a process where the JAX package cannot be imported."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['variantformer_tpu'] = None\n"
            "sys.argv = ['download_artifacts', '--list']\n"
            "runpy.run_module('variantformer_tpu_torch.data.download_artifacts', "
            "run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines()[0] == "model/v4_ag/all_genes_gencodeV24.csv -> " \
                                          "all_genes_ag_gencodeV24.csv"


@pytest.fixture
def fake_bucket(monkeypatch, tmp_path):
    """Both transports copy from ``tmp_path/bucket`` (S3 keys) and
    ``tmp_path/web`` (URLs by their last path part); returns the calls."""
    calls = []

    def s3(key, dst):
        calls.append(("s3", key))
        shutil.copyfile(tmp_path / "bucket" / key, dst)

    def url(u, dst):
        calls.append(("url", u))
        shutil.copyfile(tmp_path / "web" / u.rsplit("/", 1)[1], dst)

    for art in dl.ARTIFACTS:
        src = (tmp_path / "web" / art.remote_key.rsplit("/", 1)[1] if art.is_url
               else tmp_path / "bucket" / art.remote_key)
        src.parent.mkdir(parents=True, exist_ok=True)
        src.write_text(f"contents of {art.remote_key}\n")
    monkeypatch.setattr(dl, "_fetch_s3", s3)
    monkeypatch.setattr(dl, "_fetch_url", url)
    return calls


@pytest.mark.parametrize("only,transport", [("HG00096", "s3"), ("vocabs/tissue", "url")])
def test_download_lands_files_under_the_downloaders_names(fake_bucket, tmp_path, only,
                                                          transport):
    dest = tmp_path / "dest"
    done = dl.download(only=only, dest=str(dest))
    chosen = [a for a in dl.ARTIFACTS if only in a.remote_key or only in a.local_path]
    assert len(chosen) == 2
    assert [Path(p) for p in done] == [(dest / a.local_path).resolve() for a in chosen]
    for art in chosen:
        assert (dest / art.local_path).read_text() == f"contents of {art.remote_key}\n"
    assert [kind for kind, _ in fake_bucket] == [transport, transport]
    assert sorted(p.name for p in dest.rglob("*") if p.is_file() and p.suffix != ".lock") == \
        sorted(Path(a.local_path).name for a in chosen)  # no staging file left
    fake_bucket.clear()
    assert dl.download(only=only, dest=str(dest)) == done
    assert fake_bucket == []


def _write_manifests(base: Path, files: Path) -> None:
    """Parquet manifests under ``base`` (the artifacts layout) addressing
    local files under ``files``; one population's gene file is missing."""
    files.mkdir(parents=True, exist_ok=True)

    def local(name, exists=True):
        path = files / name
        if exists:
            path.write_text(name)
        return str(path)

    manifests = {
        "model/common/reference_genomes/genes_seqs_manifest.parquet": pd.DataFrame(
            [{"gene_id": g, "population": p,
              "file_path": local(f"{g}_{p}.npz", exists=(g, p) != (dl.GOLD_GENES[0], "EUR"))}
             for g in dl.GOLD_GENES for p in ("EUR", "REF_HG38")]),
        "model/common/reference_genomes/cres_seqs_manifest.parquet": pd.DataFrame(
            [{"chromosome": c, "population": p, "file_path": local(f"{c}_{p}.pkl.gz")}
             for c in dl.GOLD_CHROMS for p in ("EUR", "REF_HG38")]),
        "model/common/cres_all_genes_manifest.parquet": pd.DataFrame(
            [{"gene_id": g, "file_path": local(f"{g}.csv")} for g in dl.GOLD_GENES]),
        "alzheimer_disease/v4_pcg/manifest.parquet": pd.DataFrame(
            [{"gene_id": g, "tissue_id": t, "file_path": local(f"pcg_{g}_{t}.npz")}
             for g, t in dl.GOLD_AD_PREDICTORS]),
        "alzheimer_disease/v4_ag/manifest.parquet": pd.DataFrame(
            [{"gene_id": "ENSG00000000000.1", "tissue_id": 0,
              "file_path": local("ag_other.npz")}]),
    }
    for rel, frame in manifests.items():
        (base / rel).parent.mkdir(parents=True, exist_ok=True)
        frame.to_parquet(base / rel)


def test_gold_locus_stage_matches_the_jax_function(tmp_path):
    base = tmp_path / "artifacts"  # VFX_ARTIFACTS_DIR
    _write_manifests(base, tmp_path / "files")
    got = dl.download_gold_locus_data()
    want = jax_dl.download_gold_locus_data()
    assert got == want
    assert len(got) == 3 + 4 + 2 + 1  # one gene file missing, no v4_ag predictor
    assert all(Path(p).exists() for p in got)


def test_gold_locus_stage_reads_the_manifests_under_dest(tmp_path):
    """``dest`` is where the manifests were downloaded (the JAX function
    reads the artifacts directory whatever ``dest`` is)."""
    dest = tmp_path / "elsewhere"
    _write_manifests(dest, tmp_path / "files")
    _write_manifests(tmp_path / "artifacts", tmp_path / "files")
    assert dl.download_gold_locus_data(str(dest)) == dl.download_gold_locus_data()
    shutil.rmtree(tmp_path / "artifacts")
    assert len(dl.download_gold_locus_data(str(dest))) == 10


def test_examples_read_the_downloaders_names():
    """One source for the names: ``examples/_common`` imports them, and
    each is a local path the downloader writes."""
    written = {a.local_path for a in dl.ARTIFACTS}
    assert _common.FASTA is dl.FASTA and _common.DONOR_VCF is dl.DONOR_VCF
    assert _common.CHECKPOINTS is dl.CHECKPOINTS and _common.GENCODE is dl.GENCODE
    assert _common.TOKENIZER_CHECKPOINT is dl.TOKENIZER_CHECKPOINT
    names = [dl.FASTA, dl.DONOR_VCF, dl.TOKENIZER_CHECKPOINT, *dl.CHECKPOINTS.values(),
             *dl.GENCODE.values()]
    assert set(names) <= written
    assert set(dl.CHECKPOINTS) == set(dl.GENCODE) == {"v4_pcg", "v4_ag"}

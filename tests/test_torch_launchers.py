"""The port's multi-process launchers (``variantformer_tpu_torch/scripts``)
against the JAX package's ``scripts/launch_genome_wide.py`` and
``scripts/launch_train.py``, on the CPU over gloo.

* ``seq2gene_shard_batches(process_split=)`` gives the JAX function's shard
  order for every process and epoch, its ``ValueError`` and its warning.
* The genome-wide launcher: two processes split the 2-gene synthetic set
  ``[1, 1]`` and their rows are a world of one's; ``--mesh`` with one node of
  two ranks gives the same rows. Its real mode runs on an artifacts
  directory laid out under the downloader's names, where the JAX package's
  default sources raise ``FileNotFoundError``.
* The training launcher: two ranks step in lockstep with a world of one
  (each epoch's train loss within rel 2e-5, the JAX test's bound), and a
  world of one matches the JAX launcher from an orbax checkpoint of the same
  numpy tree at f32 (rtol 1e-4).

Every multi-process run is spawned once per module, all at the same time,
with a wall-clock limit; the worlds of one run in this process meanwhile.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch
import yaml

from variantformer_tpu.config import ModelConfig as JaxModelConfig
from variantformer_tpu.config import PrecisionPolicy, Seq2GeneConfig, WindowEncoderConfig
from variantformer_tpu.models.checkpoint import save_checkpoint as jax_save_checkpoint
from variantformer_tpu.models.init import init_seq2gene as jax_init
from variantformer_tpu.train.loop import seq2gene_shard_batches as jax_shard_batches
from variantformer_tpu_torch.examples import _common
from variantformer_tpu_torch.models.checkpoint import save_checkpoint
from variantformer_tpu_torch.parallel.launch import shutdown_distributed
from variantformer_tpu_torch.scripts import launch_genome_wide, launch_train
from variantformer_tpu_torch.train.loop import seq2gene_shard_batches
from variantformer_tpu_torch.utils.assets import resolve_vocab_path

REPO = Path(__file__).resolve().parent.parent
WALL_S = 240.0
TRAIN_ARGS = ["--tissue-ids", "0,2", "--epochs", "2", "--global-batch", "2",
              "--lr", "1e-3", "--tiny-model", "--no-shuffle"]


def _write_train_shards(shards: Path, n: int = 4) -> None:
    """``n`` tiny seq2gene shards; shard ``i``'s first target is ``1 + i``."""
    rng = np.random.default_rng(0)
    shards.mkdir(parents=True)
    for i in range(n):
        np.savez(
            shards / f"GENE{i}.1__D1.npz",
            cre_tokens=rng.integers(4, 64, (4, 8)).astype(np.int32),
            cre_tok_len=np.full(4, 8, np.int32),
            cre_labels=rng.integers(0, 9, 4).astype(np.int32),
            gene_tokens=rng.integers(4, 64, (3, 8)).astype(np.int32),
            gene_tok_len=np.full(3, 8, np.int32),
            strand=np.int32(0),
            tissue_ids=np.asarray([0, 2], np.int32),
            targets=np.asarray([1.0 + i, 0.5], np.float32),
        )


def _env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env.pop("LOCAL_WORLD_SIZE", None)
    env.update(extra)
    return env


def _spawn(log: Path, argv: list, env: dict) -> tuple:
    fh = open(log, "w")
    return subprocess.Popen(argv, stdout=fh, stderr=subprocess.STDOUT, env=env, cwd=REPO), fh


def _world(root: Path, name: str, module: str, args: list, n: int = 2, **env) -> list:
    """``n`` ranks of ``python -m module args`` over a ``file://`` store."""
    store = root / f"{name}.store"
    return [
        _spawn(root / f"{name}.rank{r}.log",
               [sys.executable, "-m", module, *args, "--device", "cpu",
                "--num-processes", str(n), "--process-id", str(r),
                "--init-method", f"file://{store}"], _env(**env))
        for r in range(n)
    ]


def _wait(procs: dict, deadline: float) -> None:
    failed = []
    for name, ranks in procs.items():
        for rank, (p, fh) in enumerate(ranks):
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            finally:
                fh.close()
            if p.returncode:
                failed.append(f"{name} rank {rank}: rc {p.returncode}\n"
                              + Path(fh.name).read_text()[-3000:])
    assert not failed, "\n".join(failed)


def _in_process(main, argv: list):
    try:
        return main(argv)
    finally:
        shutdown_distributed()


def _tiny_jax_config():
    return JaxModelConfig(
        window_encoder=WindowEncoderConfig(
            vocab_size=64, embedding_dim=32, num_heads=4, num_layers=1,
            ffn_hidden_dim=64, token_length=8,
        ),
        seq2gene=Seq2GeneConfig(
            emb_dim=32, gene_emb_dim=32, token_dim=32, num_heads=4,
            num_layers=2, ffn_hidden_dim=64,
        ),
        precision=PrecisionPolicy(compute_dtype="float32"),
    )


def _rows(out: Path, host: int = 0) -> pd.DataFrame:
    frames = [pd.read_parquet(p) for p in sorted((out / f"host_{host:03d}").glob("*.parquet"))]
    return pd.concat(frames, ignore_index=True)


def _sorted(df: pd.DataFrame) -> pd.DataFrame:
    return df.sort_values(["gene_id", "tissue"]).reset_index(drop=True)


def _losses(out: Path) -> list:
    return [e["train_loss"] for e in json.loads(
        (out / "host_000" / "history.json").read_text())["epochs"]]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tiny models' many small operations run no
    faster on more, and the suite's other workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launcher world of this module: the multi-process ones (and the
    JAX launcher) spawned together, the worlds of one in this process while
    they run."""
    root = tmp_path_factory.mktemp("launchers")
    shards = root / "shards"
    _write_train_shards(shards)
    cfg = _tiny_jax_config()
    params = jax.tree.map(np.asarray, jax_init(jax.random.key(0), cfg))
    jax_save_checkpoint(root / "orbax", params, cfg)
    save_checkpoint(root / "port_ckpt", params, launch_train.tiny_config())

    gw = ["--synthetic", "--tissues", "tissue0,tissue3"]
    train = ["--shards", str(shards), *TRAIN_ARGS, "--checkpoint", str(root / "port_ckpt")]
    gw_module = "variantformer_tpu_torch.scripts.launch_genome_wide"
    train_module = "variantformer_tpu_torch.scripts.launch_train"
    procs = {
        "gw2": _world(root, "gw2", gw_module, [*gw, "--out", str(root / "gw2")]),
        "gw_mesh": _world(root, "gw_mesh", gw_module,
                          [*gw, "--mesh", "--out", str(root / "gw_mesh")],
                          LOCAL_WORLD_SIZE="2"),
        "train2": _world(root, "train2", train_module, [*train, "--out", str(root / "train2")]),
        "jax_train": [_spawn(
            root / "jax_train.log",
            [sys.executable, str(REPO / "scripts" / "launch_train.py"), "--shards", str(shards),
             *TRAIN_ARGS, "--checkpoint", str(root / "orbax"), "--platform", "cpu",
             "--out", str(root / "jax_train")],
            {k: v for k, v in _env(JAX_PLATFORMS="cpu").items() if k != "XLA_FLAGS"})],
    }
    deadline = time.monotonic() + WALL_S
    try:
        one = {
            "gw1": _in_process(launch_genome_wide.main,
                               [*gw, "--device", "cpu", "--out", str(root / "gw1")]),
            "train1": _in_process(launch_train.main,
                                  [*train, "--device", "cpu", "--out", str(root / "train1")]),
            "seeded": _in_process(launch_train.main,
                                  ["--shards", str(shards), *TRAIN_ARGS, "--device", "cpu",
                                   "--out", str(root / "seeded")]),
        }
        _wait(procs, deadline)
    finally:
        for p, fh in (x for ranks in procs.values() for x in ranks):
            p.kill()
            fh.close()
    return root, one


# -- process_split ------------------------------------------------------------

@pytest.mark.parametrize("files,procs,shuffle,epoch", [
    (4, 2, False, 0),
    (4, 2, True, 0),
    (4, 2, True, 1),
    (5, 2, False, 0),   # the trailing shard dropped, with a warning
    (5, 2, True, 3),    # a different random remainder dropped each epoch
    (7, 3, True, 2),
    (4, 1, True, 5),
    (3, 4, True, 0),    # fewer shards than processes: ValueError
])
def test_process_split_matches_jax(tmp_path, caplog, files, procs, shuffle, epoch):
    """Each process's batches, epoch by epoch, are the JAX function's (the
    targets name the shards); the split raises and warns where it does."""
    _write_train_shards(tmp_path / "shards", files)
    kw = dict(batch_size=1, shuffle=shuffle)
    if files < procs:
        for fn, extra in ((jax_shard_batches, {}), (seq2gene_shard_batches, {"device": "cpu"})):
            with pytest.raises(ValueError, match="cannot feed"):
                fn(tmp_path / "shards", [0, 2], process_split=(0, procs), **kw, **extra)
        return
    seen = []
    for pi in range(procs):
        want = jax_shard_batches(tmp_path / "shards", [0, 2], process_split=(pi, procs), **kw)
        got = seq2gene_shard_batches(tmp_path / "shards", [0, 2], process_split=(pi, procs),
                                     device="cpu", **kw)
        w = [(np.asarray(t), np.asarray(m)) for _, t, m in want(epoch)]
        g = [(t.numpy(), m.numpy()) for _, t, m in got(epoch)]
        assert len(g) == len(w) == files // procs
        for (gt, gm), (wt, wm) in zip(g, w):
            np.testing.assert_array_equal(gt, wt)
            np.testing.assert_array_equal(gm, wm)
        seen += [int(t[0, 0]) - 1 for t, _ in g]
    assert len(set(seen)) == len(seen) == files - files % procs
    warned = [r for r in caplog.records if "drops the" in r.getMessage()]
    want_warn = files % procs and not shuffle
    assert {r.name for r in warned} == ({"variantformer_tpu.train.loop",
                                        "variantformer_tpu_torch.train.loop"}
                                       if want_warn else set())


# -- the genome-wide launcher --------------------------------------------------

def test_genome_wide_two_ranks_split_the_genes(runs):
    """Two ranks take one gene each (not both: a silent world of one would),
    and the union of their rows is the world of one's."""
    root, one = runs
    stats = [json.loads((root / "gw2" / f"host_{i:03d}" / "stats.json").read_text())
             for i in range(2)]
    assert [s["genes"] for s in stats] == [1, 1]
    assert [s["host"] for s in stats] == [0, 1]
    assert one["gw1"]["genes"] == 2
    assert set(one["gw1"]) == {"host", "genes", "seconds", "genes_per_sec"}
    want = _sorted(_rows(root / "gw1"))
    got = _sorted(pd.concat([_rows(root / "gw2", 0), _rows(root / "gw2", 1)]))
    pd.testing.assert_frame_equal(got, want)
    assert len(want) == 4 and np.isfinite(want["predicted_expression"]).all()


def test_genome_wide_mesh_one_node_of_two_ranks(runs):
    """``--mesh`` with ``LOCAL_WORLD_SIZE=2``: one node, whose first rank
    writes every gene's rows, the world of one's."""
    root, _ = runs
    assert sorted(p.name for p in (root / "gw_mesh").glob("host_*")) == ["host_000"]
    stats = json.loads((root / "gw_mesh" / "host_000" / "stats.json").read_text())
    assert stats["genes"] == 2 and stats["host"] == 0
    pd.testing.assert_frame_equal(_sorted(_rows(root / "gw_mesh")), _sorted(_rows(root / "gw1")))


def test_genome_wide_real_mode_reads_the_downloaders_names(tmp_path, monkeypatch):
    """The JAX launcher's real mode builds ``VCFProcessor`` on the default
    (empty) sources and cannot run; the port's reads ``real_sources``: an
    artifacts directory laid out from the synthetic environment under the
    downloader's names gives ``predict``'s rows."""
    from variantformer_tpu.api.vcfprocessor import VCFProcessor as JaxProcessor
    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor

    jax_proc = JaxProcessor(model_class="v4_pcg")
    with pytest.raises(FileNotFoundError):
        jax_proc.get_genes()
    with pytest.raises(FileNotFoundError):
        jax_proc.load_model()

    env = tmp_path / "env"
    sources, cfg, extras = _common.synthetic_env(env)
    cre_maps = {g: sources.cre_map_provider(g) for g in ("GENE1.1", "GENE2.1")}
    params = _common.synthetic_params(cfg, "cpu")
    artifacts = _common.write_artifacts(tmp_path / "artifacts", env / "genome.fa",
                                        env / "gencode.csv", cre_maps, params, cfg)
    monkeypatch.setenv("VFX_ARTIFACTS_DIR", str(artifacts))
    assert _common.artifacts_present()
    real, _ = _common.real_sources()
    assert Path(real.checkpoint_path).name == "v4_pcg_epoch11_checkpoint.pth"
    for path in (real.fasta_path, real.gencode_path, real.checkpoint_path,
                 real.tokenizer_checkpoint_path):
        assert Path(path).exists(), path

    vocab = yaml.safe_load(Path(resolve_vocab_path("tissue_vocab.yaml")).read_text())
    tissues = list(vocab)[:3]
    stats = _in_process(launch_genome_wide.main, [
        "--vcf", extras["vcf"], "--tissues", ",".join(tissues), "--device", "cpu",
        "--out", str(tmp_path / "out")])
    assert stats["genes"] == 2
    got = _sorted(_rows(tmp_path / "out"))

    proc = VCFProcessor(sources=real, device="cpu")
    proc.load_model()
    pred = proc.predict(extras["vcf"], pd.DataFrame(
        {"gene_id": ["GENE1.1", "GENE2.1"], "tissues": ",".join(tissues)}))
    want = _sorted(pd.DataFrame([
        {"gene_id": r["gene_id"], "tissue": t, "predicted_expression": float(v)}
        for _, r in pred.iterrows()
        for t, v in zip(r["tissue_names"], r["predicted_expression"])]))
    assert list(got["gene_id"]) == list(want["gene_id"])
    assert list(got["tissue"]) == list(want["tissue"])
    np.testing.assert_allclose(got["predicted_expression"], want["predicted_expression"],
                               rtol=1e-6, atol=1e-6)


# -- the training launcher -----------------------------------------------------

def test_train_two_ranks_step_with_a_world_of_one(runs):
    """The same global batches in the same order: only the reduction order
    differs (``tests/test_multichip_parity.py``'s bound)."""
    root, one = runs
    single, double = _losses(root / "train1"), _losses(root / "train2")
    assert len(single) == len(double) == 2
    for a, b in zip(single, double):
        assert b == pytest.approx(a, rel=2e-5)
    assert double[1] < double[0]
    rank1 = json.loads((root / "train2" / "host_001" / "history.json").read_text())
    assert rank1["processes"] == 2 and rank1["global_batch"] == 2 and rank1["steps"] == 4
    assert [e["train_loss"] for e in rank1["epochs"]] == double
    assert one["train1"]["steps"] == 4 and one["train1"]["processes"] == 1
    assert not (root / "train1" / "trained").exists()   # --tiny-model writes none


def test_train_world_of_one_matches_the_jax_launcher(runs):
    """The port's launcher and the JAX one from the same weights (orbax and
    the port's format): each epoch's train loss at the port's f32 bound
    against optax."""
    root, _ = runs
    np.testing.assert_allclose(_losses(root / "train1"), _losses(root / "jax_train"),
                               rtol=1e-4)


def test_train_from_the_seeded_init(runs):
    """Without ``--checkpoint`` the launcher trains the seeded init: finite,
    falling losses."""
    _, one = runs
    losses = [e["train_loss"] for e in one["seeded"]["epochs"]]
    assert np.isfinite(losses).all() and losses[1] < losses[0]

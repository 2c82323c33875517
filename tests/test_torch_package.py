"""Isolation of the PyTorch port from the JAX package, and its device rules.

* No file of ``variantformer_tpu_torch/`` nor ``chip_smoke.py`` imports JAX or
  the JAX package (``variantformer_tpu``; the port's own name shares that
  prefix and is allowed).
* The package imports with JAX and triton made unimportable.
* Entry points default to the card and raise where there is none: nothing
  falls back to the CPU silently (the processors, and the sweeps, the live
  app and AD risk over them, the launchers and the example flows).
* The port's ``init_seq2gene`` builds the JAX package's tree, key for key
  and shape for shape.
* The kernel launch counters stay at 0 on the CPU path.
* The host engines build from the port's own sources
  (``variantformer_tpu_torch/native/``) into its git-ignored ``_build/``, and
  no port file runs ``make`` in, or names a path of,
  ``variantformer_tpu/native``.
"""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.test_model_smoke import tiny_batch, tiny_config
from tests.torch_port_helpers import port_batch, port_config
from variantformer_tpu.config import ModelConfig
from variantformer_tpu.models.init import init_seq2gene as jax_init
from variantformer_tpu_torch.device import resolve_device
from variantformer_tpu_torch.models.init import init_seq2gene
from variantformer_tpu_torch.models.params import to_tensors
from variantformer_tpu_torch.models.seq2gene import seq2gene_forward
from variantformer_tpu_torch.ops import kernels
from variantformer_tpu_torch.utils import native

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "variantformer_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "variantformer_tpu"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                if _forbidden(str(node.args[0].value)):
                    bad.append(node.args[0].value)
    assert not bad, f"{path.name} imports {bad}"


def test_forbidden_prefix_rule():
    assert _forbidden("variantformer_tpu") and _forbidden("variantformer_tpu.ops.attention")
    assert _forbidden("jax.numpy") and not _forbidden("variantformer_tpu_torch.ops")


def test_package_imports_without_jax_or_triton():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['triton'] = None\n"
        "import pkgutil, importlib, variantformer_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'variantformer_tpu' or k.startswith('variantformer_tpu.')\n"
        "               for k in sys.modules), 'JAX package was imported'\n"
        "print(len(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 20


def test_default_device_raises_without_cuda(monkeypatch):
    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        VCFProcessor()
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_sweeps_live_and_ad_risk_default_to_the_card(monkeypatch):
    """The sweeps, the live app and AD risk run on the processor they are
    given, whose default device is the card; ``torch_predict_margin``
    defaults to it too. Without a card each raises."""
    import inspect

    from variantformer_tpu_torch.api.ad_risk import (
        ADriskFromVCF,
        TreeEnsemble,
        torch_predict_margin,
    )
    from variantformer_tpu_torch.api.live import LiveExpressionApp
    from variantformer_tpu_torch.api.sweeps import genome_wide_expression, saturation_scan
    from variantformer_tpu_torch.api.variantprocessor import VariantProcessor
    from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor

    assert inspect.signature(torch_predict_margin).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    leaf = np.zeros(1, np.int32)
    ens = TreeEnsemble(feature=leaf - 1, threshold=np.zeros(1, np.float32), left=leaf,
                       right=leaf, value=np.ones(1, np.float32), tree_offsets=leaf)
    calls = (
        lambda: genome_wide_expression(VCFProcessor(), None, ["tissue0"]),
        lambda: saturation_scan(VariantProcessor(), "chr1", 1, 2, "G.1", ["tissue0"]),
        lambda: LiveExpressionApp(VCFProcessor()),
        lambda: ADriskFromVCF(VCFProcessor()),
        lambda: torch_predict_margin(ens, np.zeros((2, 3), np.float32)),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    assert torch_predict_margin(ens, np.zeros((2, 3), np.float32), device="cpu").tolist() == [1, 1]


FLOWS = ("vcf2exp", "variant2exp", "vcf2embed", "snp_indel_predictions", "eqtl_analysis",
         "vcf2risk", "variant2risk", "finetune_seq2gene", "live_app")


def test_launchers_and_example_flows_default_to_the_card(monkeypatch, tmp_path):
    """The two launchers (``--device``), ``build_processor`` and every
    example flow default to the card; without one each raises before any
    process group comes up."""
    import importlib
    import inspect

    import torch.distributed as dist

    from variantformer_tpu_torch.examples import _common
    from variantformer_tpu_torch.scripts import launch_genome_wide, launch_train

    gw = ["--synthetic", "--tissues", "tissue0", "--out", str(tmp_path / "gw")]
    train = ["--shards", str(tmp_path), "--tissue-ids", "0", "--out", str(tmp_path / "tr"),
             "--tiny-model"]
    assert launch_genome_wide.parse_args(gw).device == "cuda"
    assert launch_train.parse_args(train).device == "cuda"
    assert inspect.signature(_common.build_processor).parameters["device"].default == "cuda"
    for name in FLOWS:
        main = importlib.import_module(f"variantformer_tpu_torch.examples.{name}").main
        assert inspect.signature(main).parameters["device"].default == "cuda", name
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: launch_genome_wide.main(gw), lambda: launch_train.main(train),
                 lambda: _common.build_processor(tmp_path / "env")):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
        assert not dist.is_initialized()


def test_seq2reg_training_defaults_to_the_card(monkeypatch, tmp_path):
    """The seq2reg entry points that make tensors (the window encoder's
    init, the shard batches) default to the card and raise without one;
    the step, the eval loss and the metrics run on the parameters' device."""
    import inspect

    from variantformer_tpu_torch.models.init import init_window_encoder
    from variantformer_tpu_torch.train.loop import seq2reg_shard_batches

    assert inspect.signature(seq2reg_shard_batches).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "train").mkdir()
    np.savez(tmp_path / "train" / "S_t_chr1_chunk_0.npz", tokens=np.zeros((1, 2), np.int32))
    with pytest.raises(RuntimeError, match="cuda"):
        seq2reg_shard_batches(tmp_path, {"t": 0})
    with pytest.raises(RuntimeError, match="cuda"):
        init_window_encoder(port_config(tiny_config()).window_encoder, seed=0)


def _shapes(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_shapes(v, f"{prefix}/{k}"))
        return out
    return {prefix: tuple(tree.shape)}


def _full_width(num_layers, enc_layers):
    """v4_pcg widths (ModelConfig defaults) with the depth cut."""
    cfg = ModelConfig()
    return dataclasses.replace(
        cfg,
        window_encoder=dataclasses.replace(cfg.window_encoder, num_layers=enc_layers),
        seq2gene=dataclasses.replace(cfg.seq2gene, num_layers=num_layers),
    )


@pytest.mark.parametrize("which", ["tiny", "v4_pcg_width"])
def test_init_tree_matches_jax(which):
    cfg = tiny_config() if which == "tiny" else _full_width(2, 1)
    want = _shapes(jax.eval_shape(lambda k: jax_init(k, cfg), jax.random.key(0)))
    got = _shapes(init_seq2gene(port_config(cfg), seed=0, device="cpu"))
    assert got == want


def test_init_full_v4_pcg_shapes_match_jax():
    """The released config itself, counted without materialising JAX weights;
    the port's depth-independent leaves are checked through the cut tree."""
    cfg = ModelConfig()
    want = _shapes(jax.eval_shape(lambda k: jax_init(k, cfg), jax.random.key(0)))
    cut = _shapes(init_seq2gene(port_config(_full_width(2, 1)), seed=0, device="cpu"))
    for key, shape in want.items():
        layers = "_layers/" in key or "tokenizer/layers/" in key
        assert key in cut, key
        assert cut[key][1 if layers else 0:] == shape[1 if layers else 0:], key
    assert want["/gene_layers/mixer/wqkv/w"] == (25, 1536, 4608)
    assert want["/cre_layers/cross/wkv/w"] == (24, 1536, 3072)
    assert want["/cre_tokenizer/layers/ffn_out/w"] == (8, 1024, 512)


def test_init_is_seeded():
    cfg = port_config(tiny_config())
    a, b, c = (init_seq2gene(cfg, s, device="cpu") for s in (7, 7, 8))
    assert torch.equal(a["gene_layers"]["mixer"]["wqkv"]["w"], b["gene_layers"]["mixer"]["wqkv"]["w"])
    assert not torch.equal(a["gene_layers"]["mixer"]["wqkv"]["w"], c["gene_layers"]["mixer"]["wqkv"]["w"])


def test_weight_bridge_keeps_values_and_tree():
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}, "ids": np.arange(3)}
    out = to_tensors(tree, "cpu", torch.bfloat16)
    assert out["a"]["w"].dtype == torch.bfloat16 and out["ids"].dtype == torch.int64
    np.testing.assert_array_equal(out["a"]["w"].float().numpy(), tree["a"]["w"])


def test_launch_counters_stay_zero_on_cpu():
    kernels.reset_launches()
    cfg = port_config(tiny_config())
    params = init_seq2gene(cfg, seed=0, device="cpu")
    out = seq2gene_forward(params, port_batch(tiny_batch(np.random.default_rng(0))), cfg)
    assert torch.isfinite(out.pred_expression).all()
    assert set(kernels.LAUNCHES) >= {"fused_window_encoder", "fused_gene_modulator"}
    assert all(v == 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


_C_TYPES = {"int": kernels._I, "long long": kernels._L, "float": kernels._F}


def _c_params(src: str, fn: str) -> list:
    """The ctypes kinds of a C entry point's parameters, read from its
    ``extern "C"`` prototype in the source."""
    text = (kernels.CSRC / src).read_text()
    head = f'extern "C" int {fn}('
    start = text.index(head) + len(head)
    kinds = []
    for param in text[start:text.index(")", start)].split(","):
        words = param.replace("const ", "").split()
        kinds.append(kernels._P if "*" in param else _C_TYPES[" ".join(words[:-1])])
    return kinds


@pytest.mark.parametrize("src,fn", [(src, fn) for src, fns in kernels._SIGNATURES.items()
                                    for fn in fns])
def test_ctypes_signatures_match_the_c_entry_points(src, fn):
    """Each wrapper's ctypes argument list has its C prototype's count and
    kinds (pointer, int, long long, float), so no launch can pass too few
    arguments or one of the wrong width."""
    assert kernels._SIGNATURES[src][fn] == _c_params(src, fn)


def test_wrappers_take_plain_versions_on_cpu():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    torch.testing.assert_close(kernels.gemm(a, w), kernels.gemm_plain(a, w), rtol=0, atol=0)
    f = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    torch.testing.assert_close(kernels.geglu(f), kernels.geglu_plain(f), rtol=0, atol=0)
    x = torch.from_numpy(rng.normal(size=(3, 4, 8)).astype(np.float32))
    lens = torch.tensor([0, 1, 4], dtype=torch.int32)
    pooled = kernels.masked_mean_pool(x, lens)
    assert (pooled[0] == 0).all()
    torch.testing.assert_close(pooled[2], x[2].mean(0))
    assert all(v == 0 for v in kernels.LAUNCHES.values())


def test_smoke_script_refuses_without_cuda():
    """``chip_smoke.py`` exits non-zero and prints no result line on a host
    without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_native_build_reads_port_sources_and_writes_under_build(tmp_path, monkeypatch):
    """The C++ host engines compile from ``variantformer_tpu_torch/native/*.cpp``
    alone, into ``_build/native-<hash>/``, with no machine-specific flag."""
    port = REPO / "variantformer_tpu_torch"
    assert native.NATIVE_DIR == port / "native"
    assert native.BUILD_ROOT == port / "_build"
    assert native.build_dir().parent == native.BUILD_ROOT
    assert sorted(native.SOURCES.values()) == sorted(p.name for p in native.NATIVE_DIR.glob("*.cpp"))
    assert not any(f.startswith("-march") or f.startswith("-mtune") for f in native.CXX_FLAGS)
    assert "variantformer_tpu_torch/_build/" in (REPO / ".gitignore").read_text().splitlines()

    commands = []
    run = subprocess.run

    def recording_run(cmd, *args, **kwargs):
        commands.append(cmd)
        return run(cmd, *args, **kwargs)

    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(native.subprocess, "run", recording_run)
    libs = [native.build(name) for name in native.SOURCES]
    assert [c[0] for c in commands] == [native.CXX] * 2
    for cmd, lib in zip(commands, libs):
        srcs = [a for a in cmd if a.endswith(".cpp")]
        assert len(srcs) == 1 and Path(srcs[0]).parent == port / "native"
        assert Path(cmd[cmd.index("-o") + 1]).parent == lib.parent
        assert lib.parent.parent == tmp_path / "_build" and lib.exists()
    assert [native.build(name) for name in native.SOURCES] == libs and len(commands) == 2


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_port_file_uses_the_jax_native_build(path):
    """Nothing of the port runs ``make`` or opens ``variantformer_tpu/native``."""
    text = path.read_text()
    assert "variantformer_tpu/native" not in text
    consts = [n.value for n in ast.walk(ast.parse(text)) if isinstance(n, ast.Constant)]
    assert "variantformer_tpu" not in consts   # no path built from the JAX package's name
    assert "make" not in consts and not any(
        isinstance(c, str) and c.startswith("make ") for c in consts)

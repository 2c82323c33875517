"""Isolation of the PyTorch port from the JAX package, and its device rules.

* No file of ``variantformer_tpu_torch/`` nor ``chip_smoke.py`` imports JAX or
  the JAX package (``variantformer_tpu``; the port's own name shares that
  prefix and is allowed).
* The package imports with JAX and triton made unimportable.
* Entry points default to the card and raise where there is none: nothing
  falls back to the CPU silently.
* The port's ``init_seq2gene`` builds the JAX package's tree, key for key
  and shape for shape.
* The kernel launch counters stay at 0 on the CPU path.
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

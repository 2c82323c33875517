"""Serving export of the port (``variantformer_tpu_torch/api/serving.py``) on
the CPU.

The counterpart of ``tests/test_serving.py``: a tiny config at float32
round-trips ``export_forward`` / ``load_exported`` with every output leaf
equal to the direct forward, bit for bit, for both routes (``"xla"``, the
plain forward; ``"fused2"``, the whole stacks as the ``vfx_torch`` ops),
and the direct forward agrees with the JAX package's ``impl="xla"`` at
1e-4 on the same weights. A batch of another shape and an unknown route
are refused. The card's artifact of the released model's widths (depth cut
to 4 gene layers and 2 encoder layers) cross-builds on fake tensors
(nothing runs, no weight is made), holds the three ops and is far smaller
than the weights; the ops pass ``torch.library.opcheck`` on CPU inputs;
loading for the card raises without one.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tests.test_model_smoke import tiny_batch, tiny_config
from tests.torch_port_helpers import as_f32, port_batch, port_config, port_params
from variantformer_tpu.config import PrecisionPolicy
from variantformer_tpu.models.init import init_seq2gene as jax_init
from variantformer_tpu.models.seq2gene import seq2gene_forward as jax_forward
from variantformer_tpu_torch import bench
from variantformer_tpu_torch.api.serving import export_forward, load_exported
from variantformer_tpu_torch.config import ModelConfig
from variantformer_tpu_torch.models.init import count_params, init_seq2gene
from variantformer_tpu_torch.models.seq2gene import seq2gene_forward, seq2gene_forward_plain
from variantformer_tpu_torch.ops import fused_encoder as FE
from variantformer_tpu_torch.ops import fused_modulator as FM

OPS = ("vfx_torch.fused_window_encoder.default", "vfx_torch.fused_gene_modulator.default",
       "vfx_torch.cre_stack.default")


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(tiny_config(), precision=PrecisionPolicy(compute_dtype="float32"))
    jparams = jax_init(jax.random.key(0), cfg)
    jbatch = tiny_batch(np.random.default_rng(0))
    return cfg, jparams, jbatch, port_config(cfg), port_params(jparams), port_batch(jbatch)


@pytest.fixture(scope="module")
def artifacts(tiny, tmp_path_factory):
    _, _, _, pcfg, params, batch = tiny
    root = tmp_path_factory.mktemp("serving")
    return {impl: export_forward(pcfg, params, batch, root / f"serving_{impl}.pt2", impl=impl,
                                 device="cpu")
            for impl in ("xla", "fused2")}


def _graph_ops(path) -> set:
    return {str(n.target) for n in torch.export.load(path).graph.nodes if n.op == "call_function"}


@pytest.mark.parametrize("impl", ["xla", "fused2"])
def test_export_roundtrip_exact(tiny, artifacts, impl):
    cfg, jparams, jbatch, pcfg, params, batch = tiny
    forward = seq2gene_forward if impl == "fused2" else seq2gene_forward_plain
    with torch.no_grad():
        direct = forward(params, batch, pcfg)
    ref = jax_forward(jparams, jbatch, cfg, impl="xla")
    for name in ("pred_expression", "pooled_embedding"):
        np.testing.assert_allclose(as_f32(getattr(direct, name)), as_f32(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)

    path = artifacts[impl]
    assert (set(OPS) <= _graph_ops(path)) == (impl == "fused2")
    served = load_exported(path, device="cpu")(params, batch)
    assert type(served).__name__ == "Seq2GeneOutput"
    for name in direct._fields:
        if getattr(direct, name) is None:  # optional stream outputs
            assert getattr(served, name) is None, name
            continue
        np.testing.assert_array_equal(getattr(served, name).numpy(),
                                      getattr(direct, name).numpy(), err_msg=name)

    # Shape contract: a batch of another shape is refused, not mis-run.
    bad = port_batch(tiny_batch(np.random.default_rng(1), d=3))
    with pytest.raises(ValueError, match="batch shapes"):
        load_exported(path, device="cpu")(params, bad)


def test_unknown_route_raises(tiny, tmp_path):
    _, _, _, pcfg, params, batch = tiny
    with pytest.raises(ValueError, match="bogus"):
        export_forward(pcfg, params, batch, tmp_path / "x.pt2", impl="bogus", device="cpu")
    assert not (tmp_path / "x.pt2").exists()


def test_card_artifact_cross_builds_without_a_card(tmp_path):
    """The kernel-route artifact for the card at the released widths, built
    from fake weights and a real bench batch with no card present: it holds
    the three ops, names the card, and is far smaller than the bf16 weights;
    loading it for the CPU is refused."""
    full = ModelConfig()
    cfg = dataclasses.replace(
        full, seq2gene=dataclasses.replace(full.seq2gene, num_layers=4),
        window_encoder=dataclasses.replace(full.window_encoder, num_layers=2))
    with FakeTensorMode():
        params = init_seq2gene(cfg, 0, device="cpu", dtype=torch.bfloat16)
        weights = 2 * count_params(params)
        params = bench.packed_params(cfg, params)
    batch = bench.example_batch(1, 384, cfg.dataset.max_chunks, cfg.dataset.max_length, 54,
                                cfg.window_encoder.vocab_size, device="cpu")
    path = export_forward(cfg, params, batch, tmp_path / "serving_cuda.pt2", impl="fused2",
                          device="cuda")
    assert set(OPS) <= _graph_ops(path)
    size = (tmp_path / "serving_cuda.pt2").stat().st_size
    assert 1000 < size < weights / 100, (size, weights)
    with pytest.raises(ValueError, match="built for cuda"):
        load_exported(path, device="cpu")


def test_loading_for_the_card_raises_without_one(artifacts, monkeypatch):
    path = artifacts["xla"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        load_exported(path, device="cuda")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        load_exported(path)


def test_custom_ops_pass_opcheck():
    """Schema, fake-tensor and dispatch checks of the two ops on CPU inputs
    (their CPU kernels are the plain versions)."""
    rng = np.random.default_rng(4)
    f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.3)
    heads, e, n, length = 2, 16, 3, 8
    enc = {k: v[:1].contiguous() for k, v in FE.pack_encoder_layers(
        init_seq2gene(port_config(tiny_config()), 1, device="cpu")["cre_tokenizer"]["layers"],
        heads, torch.float32).items()}
    assert enc["wqkv"].shape[1] == e
    args = (f32(n, length, e), torch.tensor([8, 1, 0], dtype=torch.int32),
            [enc[k] for k in FE.PACKED], torch.tensor([0.5, 0.25]), 0.25, heads)
    torch.library.opcheck(FE.window_encoder_op, args)

    cfg = port_config(tiny_config())
    layers = init_seq2gene(cfg, 2, device="cpu")["gene_layers"]
    mod = FM.pack_gene_layers(layers, cfg.seq2gene.num_heads, torch.float32)
    nl, em = mod["wqkv"].shape[0], cfg.seq2gene.emb_dim
    args = (f32(2, 3, 5, em), f32(nl, 2, 4, em), torch.tensor([5, 2], dtype=torch.int32),
            torch.tensor([4, 1], dtype=torch.int32), [mod[k] for k in FM.PACKED],
            torch.tensor([0.5, 0.25, 0.125, 0.0625]), 0.5, cfg.seq2gene.num_heads)
    torch.library.opcheck(FM.gene_modulator_op, args)

"""The port's multi-device inference (``variantformer_tpu_torch/parallel``)
against one process and against the JAX package, on the CPU.

Each world (2 ranks: data=2; 4 ranks at ``make_mesh(num_model=2)``: data=2,
model=2) is spawned once per module by ``tests/torch_mesh_worker.py`` over
gloo and runs every scenario of this file; the JAX references and the
unmeshed port run here, in the parent. The counterparts of
``tests/test_multichip_parity.py``'s ``test_use_mesh_sweep_matches_single_
device``, ``test_tissue_sharded_forward_matches_single_device``,
``test_use_mesh_tissue_partition_matches_single_device``,
``test_donor_dp_fused_forward_matches_single_device``,
``test_tissue_dp_fused_forward_matches_single_device`` and
``test_use_mesh_keeps_fused_kernels_{donor,tissue}_partition``.

Tolerances: the meshed port against the unmeshed port at f32 2e-5 (the JAX
tests' own), against JAX ``impl="xla"`` single-device 1e-4. The kernel
route's programs take the whole-stack kernels' plain versions here (CPU
tensors), so they too meet 2e-5 against the unmeshed port.
"""

import dataclasses
import types

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from tests import torch_mesh_worker as worker
from tests.test_api_end_to_end import _tiny_cfg, fixture_env  # noqa: F401  (the genome)
from tests.test_model_smoke import tiny_batch, tiny_config
from tests.test_torch_vep_model import (  # noqa: F401  (fixtures)
    FLOATS,
    _assert_frames_match,
    _jax_native_loaded,
    _no_remote_fetch,
    _variant_df,
)
from tests.torch_port_helpers import port_batch, port_config
from variantformer_tpu.api.sweeps import genome_wide_expression as jax_sweep
from variantformer_tpu.api.vcfprocessor import VCFProcessor as JaxVCFProcessor
from variantformer_tpu.config import PrecisionPolicy
from variantformer_tpu.models.init import init_seq2gene
from variantformer_tpu.models.seq2gene import seq2gene_forward as jax_forward
from variantformer_tpu.parallel import mesh as jax_mesh
from variantformer_tpu_torch.api.vcfprocessor import VCFProcessor
from variantformer_tpu_torch.models.checkpoint import save_checkpoint
from variantformer_tpu_torch.models.params import leaves, to_tensors
from variantformer_tpu_torch.models.seq2gene import seq2gene_forward
from variantformer_tpu_torch.parallel import mesh as pmesh

MESH_TOL = dict(rtol=2e-5, atol=2e-5)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
FIELDS = ("pred_expression", "pooled_embedding", "gene_token_embedding", "cre_token_embedding")
WORLDS = {2: 1, 4: 2}  # ranks -> num_model
GENES = ["GENEPLUS.1", "GENEMINUS.1", "GENEPLUS.1"]  # 3 donors: padding on every mesh
TISSUES = ["tissue0", "tissue3", "tissue5"]           # 3 tissues: padding too
VEP_POSITIONS = (130, 321, 721)


def _f32(cfg):
    return dataclasses.replace(cfg, precision=PrecisionPolicy(compute_dtype="float32"))


def _tree(batch) -> dict:
    return {k: None if v is None else np.asarray(v) for k, v in batch._asdict().items()}


@pytest.fixture(scope="module")
def model():
    cfg = _f32(tiny_config())
    return cfg, jax.tree.map(np.asarray, init_seq2gene(jax.random.key(0), cfg))


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(3)
    tissue = tiny_batch(rng, d=1, c=13, g=7, t=5)
    # CRE tokens bucketed shorter than the gene windows', as pack_samples does.
    tissue = tissue._replace(cre_tokens=tissue.cre_tokens[..., :6],
                             cre_tok_len=np.minimum(tissue.cre_tok_len, 6))
    return {
        "donor": tiny_batch(rng, d=4),
        "odd": tiny_batch(rng, d=3),
        "tissue": tissue,
        "donor_all": tiny_batch(rng, d=4),
    }


@pytest.fixture(scope="module")
def api_model():
    cfg = _f32(_tiny_cfg(500))
    return cfg, jax.tree.map(np.asarray, init_seq2gene(jax.random.key(0), cfg))


@pytest.fixture(scope="module")
def paths(fixture_env, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("maps")
    src = fixture_env["sources"]
    cre_maps = {}
    for gene in set(GENES):
        cre_maps[gene] = str(root / f"{gene}.csv")
        src.cre_map_provider(gene).to_csv(cre_maps[gene], index=False)
    variants = _variant_df(fixture_env["seq"], VEP_POSITIONS).to_dict("records")
    return {"fasta": src.fasta_path, "gencode": src.gencode_path,
            "bpe_vocab": src.bpe_vocab_path, "tissue_vocab": src.tissue_vocab_path,
            "cre_maps": cre_maps, "vcf": fixture_env["vcf"], "variants": variants}


@pytest.fixture(scope="module")
def context_model(api_model):
    """The API model with the context-flavour encoder: the layered encoder
    and the whole gene stack (#2 on the card) under ``impl="fused2"``."""
    cfg, _ = api_model
    cfg = dataclasses.replace(cfg, window_encoder=dataclasses.replace(cfg.window_encoder,
                                                                      use_context=True))
    return cfg, jax.tree.map(np.asarray, init_seq2gene(jax.random.key(1), cfg))


@pytest.fixture(scope="module", params=sorted(WORLDS), ids=lambda n: f"{n}ranks")
def world(request, model, batches, api_model, context_model, paths, tmp_path_factory):
    n = request.param
    cfg, params = model
    out = tmp_path_factory.mktemp(f"world{n}")
    save_checkpoint(out / "ckpt", params)
    acfg, aparams = api_model
    scenarios = [
        ("topology", "topology", {}),
        ("forwards", "forwards", dict(cfg=port_config(cfg), params=params,
                                      batches={k: _tree(b) for k, b in batches.items()},
                                      num_model=WORLDS[n], ckpt=str(out / "ckpt"))),
        ("processors", "processors", dict(cfg=port_config(acfg), params=aparams, paths=paths,
                                          num_model=WORLDS[n], genes=GENES, tissues=TISSUES,
                                          out_dir=str(out),
                                          context=dict(cfg=port_config(context_model[0]),
                                                       params=context_model[1]))),
    ]
    return n, worker.launch(n, scenarios, out / "run")


def _port(params, batch, cfg, impl):
    with torch.inference_mode():
        out = seq2gene_forward(to_tensors(params, "cpu"), port_batch(batch), port_config(cfg),
                               impl=impl)
    return {k: getattr(out, k).float().numpy() for k in FIELDS}


def _check(got: dict, want: dict, tol, t=None):
    for k in FIELDS:
        w = np.asarray(want[k] if isinstance(want, dict) else getattr(want, k), np.float32)
        np.testing.assert_allclose(got[k], w if t is None else w[:, :t], err_msg=k, **tol)


# -- the mesh and the parameter layout (no processes) ---------------------------------


def test_param_specs_match_jax_leaf_for_leaf(model):
    _, params = model
    ours = leaves(pmesh.param_specs(params))
    theirs = jax.tree.leaves(jax_mesh.param_specs(params),
                             is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert len(ours) == len(theirs) > 0
    for axis, spec in zip(ours, theirs):
        want = [i for i, a in enumerate(spec) if a == "model"]
        assert ([axis] if axis is not None else []) == want


def _fake_mesh(m, j):
    return types.SimpleNamespace(shape={"data": 1, "model": m}, coords=(0, j),
                                 device=torch.device("cpu"))


def test_geglu_value_and_gate_pair_on_every_rank():
    """Rank m holds chunk m of GeGLU's value half and of its gate half, with
    rows m of ffn_out: the partial FFNs summed over the ranks give the whole
    FFN. A plain contiguous split of ffn_in (what the JAX spec alone says)
    does not, so this test tells the two apart."""
    from variantformer_tpu_torch.models import core

    rng = np.random.default_rng(0)
    e, f = 8, 12
    p = {"ffn_in": {"w": rng.standard_normal((e, 2 * f)), "b": rng.standard_normal(2 * f)},
         "ffn_out": {"w": rng.standard_normal((f, e)), "b": np.zeros(e)}}
    p = to_tensors(p, "cpu", torch.float64)
    x = torch.from_numpy(rng.standard_normal((3, e)))
    want = core.geglu_ffn(p, x, torch.float64)

    def partial(slices):
        h = core.geglu(core.linear(slices["ffn_in"], x, torch.float64))
        return h @ slices["ffn_out"]["w"]

    paired = sum(partial(pmesh.shard_params(p, _fake_mesh(2, j))) for j in range(2))
    torch.testing.assert_close(paired + p["ffn_out"]["b"], want)
    contiguous = sum(partial({"ffn_in": {k: v.chunk(2, -1)[j] for k, v in p["ffn_in"].items()},
                              "ffn_out": {"w": p["ffn_out"]["w"].chunk(2, 0)[j]}})
                     for j in range(2))
    assert not torch.allclose(contiguous + p["ffn_out"]["b"], want)


def test_shard_params_refuses_an_uneven_split(model):
    _, params = model
    with pytest.raises(ValueError, match="does not split"):
        pmesh.shard_params(params, _fake_mesh(5, 0))
    cfg = port_config(model[0])
    with pytest.raises(ValueError, match="heads"):
        pmesh.check_model_split(cfg, _fake_mesh(3, 0))


def test_make_mesh_shape_rule(world):
    n, ranks = world
    for r, res in enumerate(ranks):
        top = res["topology"]
        assert top["info"] == {"process_index": r, "process_count": n, "local_devices": 1,
                               "global_devices": n}
        assert top["default"] == {"data": 1, "model": n}  # the first of 4, 2, 1 dividing n
        for m, (shape, coords) in top["meshes"].items():
            assert shape == {"data": n // m, "model": m}
            assert coords == (r // m, r % m)
        assert top["hosts"] == list(range(10))[r::n]


# -- the forwards -------------------------------------------------------------------


def test_sharded_forward_matches_single_device(world, model, batches):
    n, ranks = world
    cfg, params = model
    want = _port(params, batches["donor"], cfg, "xla")
    ref = jax_forward(params, batches["donor"], cfg, impl="xla")
    for res in ranks:  # the same outputs on every rank
        _check(res["forwards"]["tp_donor"], want, MESH_TOL)
        _check(res["forwards"]["tp_donor"], ref, JAX_TOL)


def test_odd_donor_count_replicates_without_duplicates(world, model, batches):
    _, ranks = world
    cfg, params = model
    want = _port(params, batches["odd"], cfg, "xla")
    for res in ranks:
        assert res["forwards"]["odd_split"] is False
        assert res["forwards"]["tp_odd"]["pred_expression"].shape == (3, 3)
        _check(res["forwards"]["tp_odd"], want, MESH_TOL)


def test_tissue_sharded_forward_matches_single_device(world, model, batches):
    _, ranks = world
    cfg, params = model
    want = _port(params, batches["tissue"], cfg, "xla")
    ref = jax_forward(params, batches["tissue"], cfg, impl="xla")
    for res in ranks:
        assert res["forwards"]["tissue_padded"] == (6, 14, 8, 5)  # data axis 2
        _check(res["forwards"]["tp_tissue"], want, MESH_TOL)
        _check(res["forwards"]["tp_tissue"], ref, JAX_TOL)


def test_donor_dp_fused_forward_matches_single_device(world, model, batches):
    _, ranks = world
    cfg, params = model
    want = _port(params, batches["donor_all"], cfg, "fused2")
    ref = jax_forward(params, batches["donor_all"], cfg, impl="xla")
    for res in ranks:
        _check(res["forwards"]["dp_donor"], want, MESH_TOL)
        _check(res["forwards"]["dp_donor"], ref, JAX_TOL)


def test_tissue_dp_fused_forward_matches_single_device(world, model, batches):
    _, ranks = world
    cfg, params = model
    want = _port(params, batches["tissue"], cfg, "fused2")
    ref = jax_forward(params, batches["tissue"], cfg, impl="xla")
    for res in ranks:
        _check(res["forwards"]["dp_tissue"], want, MESH_TOL)
        _check(res["forwards"]["dp_tissue"], ref, JAX_TOL)


def test_load_checkpoint_restores_each_ranks_slices(world, model):
    n, ranks = world
    _, params = model
    m = WORLDS[n]
    whole = [np.asarray(x).shape for x in leaves(params)]
    specs = leaves(pmesh.param_specs(params))
    for res in ranks:
        assert res["forwards"]["ckpt_equal"] is True
        for got, full, axis in zip(res["forwards"]["ckpt_shapes"], whole, specs, strict=True):
            want = list(full)
            if axis is not None:
                want[axis] //= m
            assert list(got) == want


def test_window_gather_needs_the_dual_encoder(model, batches):
    cfg, params = model
    with pytest.raises(ValueError, match="window_gather_axes requires a kernel route"):
        seq2gene_forward(to_tensors(params, "cpu"), port_batch(batches["tissue"]),
                         port_config(cfg), impl="xla", window_group=object())


# -- the processors -------------------------------------------------------------------


def _sweep_frame(proc, mod, env_vcf):
    df = mod(proc, env_vcf, TISSUES, genes=GENES, batch_size=len(GENES))
    df = df.drop_duplicates(["gene_id", "tissue"]).sort_values(["gene_id", "tissue"])
    return list(df["gene_id"]), df["predicted_expression"].to_numpy(np.float64)


@pytest.fixture(scope="module")
def unmeshed(api_model, paths, fixture_env):  # noqa: F811
    from variantformer_tpu_torch.api.sweeps import genome_wide_expression

    cfg, params = api_model
    sources = worker._csv_sources(paths)
    port = VCFProcessor(sources=sources, config=port_config(cfg), device="cpu", impl="xla")
    port.set_params(params)
    jproc = JaxVCFProcessor(sources=fixture_env["sources"], config=cfg, impl="xla")
    jproc.set_params(params)
    query = pd.DataFrame({"gene_id": [GENES[0]], "tissues": [",".join(TISSUES)]})
    return {
        "sweep": _sweep_frame(port, genome_wide_expression, paths["vcf"]),
        "jax_sweep": _sweep_frame(jproc, jax_sweep, paths["vcf"]),
        "predict": np.stack(port.predict(paths["vcf"], query)["predicted_expression"]),
        "jax_predict": np.stack(jproc.predict(paths["vcf"], query)["predicted_expression"]),
    }


@pytest.mark.parametrize("impl", ["xla", "fused2"])
def test_use_mesh_sweep_matches_single_device(world, unmeshed, impl):
    """A 3-donor group on every mesh: donors padded to the ranks they split
    over and sliced back."""
    _, ranks = world
    genes, want = unmeshed["sweep"]
    _, ref = unmeshed["jax_sweep"]
    for res in ranks:
        got = res["processors"][f"sweep_{impl}"]
        assert got["gene_id"] == genes
        np.testing.assert_allclose(got["pred"], want, **MESH_TOL)
        np.testing.assert_allclose(got["pred"], ref, **JAX_TOL)


def test_use_mesh_tissue_partition_matches_single_device(world, unmeshed):
    _, ranks = world
    for res in ranks:
        for key in ("tissue_xla", "tissue_fused2"):
            np.testing.assert_allclose(res["processors"][key], unmeshed["predict"],
                                       err_msg=key, **MESH_TOL)
            np.testing.assert_allclose(res["processors"][key], unmeshed["jax_predict"],
                                       err_msg=key, **JAX_TOL)


def test_use_mesh_tissue_partition_keeps_the_gene_kernel_for_a_layered_encoder(
        world, context_model, paths, fixture_env):  # noqa: F811
    """A context-flavour config under the tissue partition keeps its
    unmeshed route (the layered encoder on each rank's window shard, the
    labels sliced to it; the whole gene stack, #2 on the card, on each
    tissue shard) instead of falling back to ``impl="xla"``, and matches
    the unmeshed port at 2e-5 and JAX ``impl="xla"`` at 1e-4."""
    _, ranks = world
    cfg, params = context_model
    query = pd.DataFrame({"gene_id": [GENES[0]], "tissues": [",".join(TISSUES)]})
    port = VCFProcessor(sources=worker._csv_sources(paths), config=port_config(cfg),
                        device="cpu", impl="fused2")
    port.set_params(params)
    want = np.stack(port.predict(paths["vcf"], query)["predicted_expression"])
    jproc = JaxVCFProcessor(sources=fixture_env["sources"], config=cfg, impl="xla")
    jproc.set_params(params)
    ref = np.stack(jproc.predict(paths["vcf"], query)["predicted_expression"])
    for res in ranks:
        r = res["processors"]
        assert r["context_route"] == ("fused2", True, True, False)
        np.testing.assert_allclose(r["context_tissue"], want, **MESH_TOL)
        np.testing.assert_allclose(r["context_tissue"], ref, **JAX_TOL)


def test_use_mesh_keeps_fused_kernels_donor_and_tissue_partition(world):
    """The kernel route is kept under both partitions (impl, the program,
    the gene pack), survives re-meshing, and ``_reset_mesh`` restores it;
    ``impl="xla"`` runs the layered route without a pack."""
    _, ranks = world
    for res in ranks:
        r = res["processors"]
        assert r["route_xla"] == ("xla", False, False)
        assert r["route_fused2"] == ("fused2", True, True)
        assert r["tissue_route"] == ("fused2", True, True)
        assert r["remesh_route"] == ("fused2", True, True)
        assert r["reset_route"] == ("fused2", True, True)
        assert r["streams_refused"] is True


def test_variant_processor_use_mesh_matches_single_device(world, api_model, paths,
                                                          fixture_env, tmp_path):  # noqa: F811
    """``VariantProcessor.use_mesh`` (the kernel route's donor program over
    every rank; D=3 triples padded, the ref-once cache off): the unmeshed
    port's frame at 2e-5 and the JAX package's at 1e-4."""
    from variantformer_tpu.api.variantprocessor import VariantProcessor as JaxVariantProcessor
    from variantformer_tpu_torch.api.variantprocessor import VariantProcessor

    _, ranks = world
    cfg, params = api_model
    var_df = pd.DataFrame(paths["variants"])
    args = dict(vcf_path=paths["vcf"], sample_name="S1")
    port = VariantProcessor(sources=worker._csv_sources(paths), config=port_config(cfg),
                            device="cpu")
    port.set_params(params)
    want = port.predict(var_df, str(tmp_path / "port"), **args)
    jproc = JaxVariantProcessor(sources=fixture_env["sources"], config=cfg, impl="xla")
    jproc.set_params(params)
    ref = jproc.predict(var_df, str(tmp_path / "jax"), **args)
    for res in ranks:
        got = res["processors"]["vep"]
        assert res["processors"]["vep_stats"].get("ref_hits", 0) == 0  # no ref-once cache
        assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0
        for col in want.columns:
            if col in FLOATS:
                np.testing.assert_allclose(np.stack(got[col].to_list()).astype(np.float64),
                                           np.stack(want[col].to_list()).astype(np.float64),
                                           err_msg=col, **MESH_TOL)
            else:
                assert got[col].to_list() == want[col].to_list(), col
        _assert_frames_match(got, ref)


@pytest.mark.parametrize("impl", ["xla", "fused", "fused2"])
def test_impl_routes_match_jax(model, batches, impl):
    """The port's ``impl`` picks the JAX package's routes; each matches JAX
    ``impl="xla"`` at f32 1e-4, and ``VCFProcessor`` packs only the stacks
    its route launches."""
    cfg, params = model
    ref = jax_forward(params, batches["donor"], cfg, impl="xla")
    _check(_port(params, batches["donor"], cfg, impl), ref, JAX_TOL)
    proc = VCFProcessor(config=port_config(cfg), device="cpu", impl=impl)
    proc.set_params(params)
    assert ("layers_packed" in proc._params["cre_tokenizer"]) == (impl != "xla")
    assert ("gene_layers_packed" in proc._params) == (impl == "fused2")
    with pytest.raises(ValueError, match="impl must be one of"):
        VCFProcessor(config=port_config(cfg), device="cpu", impl="bogus")

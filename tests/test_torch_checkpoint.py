"""The rest of vcf2exp's surface in the port against the JAX package.

* Synthetic state_dicts in the reference's checkpoint layout (the key names
  and [out, in] shapes of the reference's modules, built here layer by layer
  from a seed) go through both converters; the trees must be equal exactly.
  ``chip_smoke.py``'s writer of that layout must give the same keys and
  shapes and convert back to the tree it was written from.
* ``ModelManager.load_model`` from saved ``.pth`` files gives the JAX
  package's config updates, head layout and parameters.
* The port's checkpoint format round trips; the local-manifest and cached-
  fetcher cases of ``tests/test_assets.py`` hold for the port's copy.
* ``VCFProcessor(device="cpu").load_model()`` then ``predict`` matches the
  JAX package at float32 within 1e-4; without a CRE-map provider ``predict``
  reads the manifest.
No test reaches a network: the fetcher's remote transport is replaced by one
that fails.
"""

import dataclasses
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
from tests.test_model_smoke import tiny_config
from tests.test_torch_vcfprocessor import GENES, _cfg, _sources, genome  # noqa: F401
from tests.torch_port_helpers import load_jax_native, port_config
from variantformer_tpu.api.model_manager import ModelManager as JaxManager
from variantformer_tpu.api.vcfprocessor import DataSources as JaxSources
from variantformer_tpu.api.vcfprocessor import VCFProcessor as JaxProcessor
from variantformer_tpu.config import ModelConfig, Seq2GeneConfig
from variantformer_tpu.models import convert as jax_convert
from variantformer_tpu.models.init import count_params as jax_count_params
from variantformer_tpu.models.init import init_seq2gene as jax_init
from variantformer_tpu.models.init import init_window_encoder as jax_init_encoder
from variantformer_tpu_torch.api.model_manager import ModelManager
from variantformer_tpu_torch.api.vcfprocessor import DataSources, VCFProcessor
from variantformer_tpu_torch.models import convert
from variantformer_tpu_torch.models.checkpoint import (
    convert_torch_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from variantformer_tpu_torch.models.init import count_params, init_seq2gene, init_window_encoder
from variantformer_tpu_torch.models.params import to_numpy
from variantformer_tpu_torch.utils import assets
from variantformer_tpu_torch.utils.assets import CachedFetcher, ManifestLookup
from variantformer_tpu_torch.utils.retry import retry_with_backoff

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _jax_native_loaded():
    load_jax_native()


@pytest.fixture(autouse=True)
def _no_network(monkeypatch):
    def refuse(self, rel, dst):
        raise AssertionError(f"remote fetch of {rel} attempted")

    monkeypatch.setattr(CachedFetcher, "_default_transport", refuse)


# -- the reference's checkpoint layout, module by module --------------------

class _Sd(dict):
    """A state_dict under construction: seeded float32 weights in torch's
    [out, in] Linear layout under the reference's module names."""

    def __init__(self, seed: int):
        super().__init__()
        self.rng = np.random.default_rng(seed)

    def w(self, *shape):
        return self.rng.normal(size=shape).astype(np.float32)

    def linear(self, p, fan_in, fan_out):
        self[f"{p}.weight"], self[f"{p}.bias"] = self.w(fan_out, fan_in), self.w(fan_out)

    def norm(self, p, dim):
        self[f"{p}.weight"], self[f"{p}.bias"] = 1 + 0.1 * self.w(dim), self.w(dim)

    def ffn(self, p, e, hidden):
        self.linear(f"{p}.linear_geglu_1", e, hidden)
        self.linear(f"{p}.linear_geglu_2", hidden // 2, e)

    def plain_layer(self, p, e, hidden):
        """FlashTransformerLayer: MHA a direct attribute."""
        self.norm(f"{p}.norm1", e)
        self.norm(f"{p}.norm2", e)
        self.linear(f"{p}.MHA.Wqkv", e, 3 * e)
        self.linear(f"{p}.MHA.out_proj", e, e)
        self.ffn(p, e, hidden)

    def cross(self, p, e):
        self.linear(f"{p}.crossMHA.MHA.Wq", e, e)
        self.linear(f"{p}.crossMHA.MHA.Wkv", e, 2 * e)
        self.linear(f"{p}.crossMHA.MHA.out_proj", e, e)

    def context_layer(self, p, e, hidden):
        """ContextFlashAttentionEncoderLayer: self (mixer) + cross + GeGLU."""
        for n in ("norm1", "norm2", "norm3"):
            self.norm(f"{p}.{n}", e)
        self.linear(f"{p}.mixer.MHA.Wqkv", e, 3 * e)
        self.linear(f"{p}.mixer.MHA.out_proj", e, e)
        self.cross(p, e)
        self.ffn(p, e, hidden)

    def cross_only_layer(self, p, e, hidden):
        self.norm(f"{p}.norm1", e)
        self.norm(f"{p}.norm2", e)
        self.cross(p, e)
        self.ffn(p, e, hidden)

    def seq2reg(self, p, wcfg, use_context=False):
        e = wcfg.embedding_dim
        self[f"{p}token_embedding.weight"] = self.w(wcfg.vocab_size, e)
        self[f"{p}context_embedding.weight"] = self.w(9, e)
        layer = self.context_layer if use_context else self.plain_layer
        for i in range(wcfg.num_layers):
            layer(f"{p}transformer_encoder.{i}", e, wcfg.ffn_hidden_dim)
        for t in range(wcfg.num_tissues):
            self.linear(f"{p}tissue_classifiers.{t}", e, wcfg.num_classes)

    def head(self, p, e):
        """The bigger head: Sequential(Linear, LayerNorm, _, _, Linear, _, Linear)."""
        self.linear(f"{p}.0", e, e)
        self.norm(f"{p}.1", e)
        self.linear(f"{p}.4", e, e)
        self.linear(f"{p}.6", e, 1)


def reference_sd(cfg, seed=0, layout="combined", multi_head=False, context_encoder=False,
                 cross_only=False):
    """A seq2gene state_dict in the reference's layout: the combined
    modulator or the two-module model, shared or per-tissue heads, plain or
    context tokenizer layers, full or cross-only gene layers."""
    wcfg, mcfg = cfg.window_encoder, cfg.seq2gene
    e, hidden = mcfg.emb_dim, mcfg.ffn_hidden_dim
    sd = _Sd(seed)
    sd.seq2reg("cre_tokenizer.", wcfg, context_encoder)
    sd.seq2reg("gene_tokenizer.", wcfg, context_encoder)
    sd.linear("cre_map", mcfg.token_dim, e)
    sd.linear("gene_map", mcfg.gene_emb_dim, e)
    sd["start_tkn.registry_tokens.weight"] = sd.w(mcfg.num_tissues, e)
    if layout == "combined":
        cre, gene = "combined_modulator.cre_layers", "combined_modulator.gene_layers"
        sd["combined_modulator.second_level_context_embedding.weight"] = sd.w(9, e)
    else:
        cre, gene = "epigenetics_modulator.epigenetics_modulator", "gene_modulator.gene_modulator"
        sd["epigenetics_modulator.second_level_context_embedding.weight"] = sd.w(9, e)
    for i in range(mcfg.num_layers - 1):
        sd.context_layer(f"{cre}.{i}", e, hidden)
    for i in range(mcfg.num_layers):
        (sd.cross_only_layer if cross_only else sd.context_layer)(f"{gene}.{i}", e, hidden)
    heads = "tissue_heads.tissue_expressions"
    for t in range(mcfg.num_tissues if multi_head else 1):
        sd.head(f"{heads}.{t}" if multi_head else heads, e)
    return dict(sd)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def _assert_trees_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        a = got[k].numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        b = np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


LAYOUTS = {
    "combined_shared_head": {},
    "combined_multi_head": {"multi_head": True},
    "two_module": {"layout": "two_module"},
    "context_tokenizers": {"context_encoder": True},
    "cross_only_gene_layers": {"cross_only": True},
}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_converters_give_equal_trees(layout):
    cfg = tiny_config()
    sd = reference_sd(cfg, **LAYOUTS[layout])
    kw = dict(num_heads=cfg.seq2gene.num_heads, encoder_num_heads=cfg.window_encoder.num_heads)
    _assert_trees_equal(convert.convert_seq2gene(sd, **kw),
                        jax_convert.convert_seq2gene(sd, **kw))
    for name in ("cre_tokenizer", "gene_tokenizer"):
        assert convert.window_encoder_uses_context(sd, name) == LAYOUTS[layout].get(
            "context_encoder", False)
        _assert_trees_equal(
            convert.convert_window_encoder(sd, name, cfg.window_encoder.num_heads),
            jax_convert.convert_window_encoder(sd, name, cfg.window_encoder.num_heads))


@pytest.mark.parametrize("multi_head", [False, True], ids=["shared_head", "multi_head"])
def test_converted_tree_has_the_init_layout(multi_head):
    """The layout built here converts to the tree ``init_seq2gene`` makes."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, seq2gene=dataclasses.replace(cfg.seq2gene,
                                                                multi_head=multi_head))
    tree = convert.convert_seq2gene(reference_sd(cfg, multi_head=multi_head),
                                    num_heads=cfg.seq2gene.num_heads,
                                    encoder_num_heads=cfg.window_encoder.num_heads)
    want = jax.eval_shape(lambda k: jax_init(k, cfg), jax.random.key(0))
    assert {k: v.shape for k, v in _flat(tree).items()} == {
        k: tuple(v.shape) for k, v in _flat(want).items()}


@pytest.mark.parametrize("multi_head", [False, True], ids=["shared_head", "multi_head"])
def test_smoke_writer_round_trips(multi_head):
    """``chip_smoke.reference_state_dict`` writes the layout built here (same
    keys and shapes) and converts back to the tree it was written from."""
    cfg = port_config(tiny_config())
    cfg = dataclasses.replace(cfg, seq2gene=dataclasses.replace(cfg.seq2gene,
                                                                multi_head=multi_head))
    params = init_seq2gene(cfg, seed=3, device="cpu")
    sd = {k: v.numpy() for k, v in chip_smoke.reference_state_dict(params, cfg).items()}
    spec = reference_sd(tiny_config(), multi_head=multi_head)
    assert {k: v.shape for k, v in sd.items()} == {k: v.shape for k, v in spec.items()}
    back = convert.convert_seq2gene(sd, num_heads=cfg.seq2gene.num_heads,
                                    encoder_num_heads=cfg.window_encoder.num_heads)
    _assert_trees_equal(back, to_numpy(params))


# -- .pth files and the model manager ---------------------------------------

TOKEN_E, TOKEN_HEADS = 16, 2


def _write_pth(path, sd, hyper=None, top_level=True, bf16=False):
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    if bf16:
        tensors = {k: v.to(torch.bfloat16) for k, v in tensors.items()}
    obj = {"state_dict": tensors, "hyper_parameters": hyper or {}} if top_level else tensors
    torch.save(obj, path)
    return str(path)


@pytest.mark.parametrize("top_level", [True, False], ids=["state_dict_key", "whole_file"])
def test_load_torch_checkpoint_equals_jax(tmp_path, top_level):
    sd = reference_sd(tiny_config())
    path = _write_pth(tmp_path / "m.pth", sd, {"emb_dim": 24}, top_level=top_level, bf16=True)
    got, got_hyper = convert.load_torch_checkpoint(path)
    want, want_hyper = jax_convert.load_torch_checkpoint(path)
    assert got.keys() == want.keys() and got_hyper == want_hyper
    assert got_hyper == ({"emb_dim": 24} if top_level else {})
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])


def _model_files(tmp_path, case):
    """A tokenizer checkpoint and a seq2gene checkpoint whose config differs
    from the processor's: the manager must calibrate it from them."""
    base = tiny_config()
    multi = case == "multi_head"
    true_cfg = dataclasses.replace(
        base, seq2gene=dataclasses.replace(base.seq2gene, emb_dim=32, num_heads=4,
                                           num_layers=2, multi_head=multi))
    sd = reference_sd(true_cfg, seed=1, multi_head=multi)
    hyper = {"emb_dim": 32, "num_heads": 4, "num_layers": 2, "use_context": True,
             "gene_emb_dim": TOKEN_E, "token_dim": TOKEN_E, "num_tissues": 63,
             "only_cross_attention": False, "use_bigger_head": True, "gene_pooling": None}
    model = _write_pth(tmp_path / "model.pth", sd, hyper if case != "whole_file" else None,
                       top_level=case != "whole_file")
    tok_sd = _Sd(2)
    tok_sd.seq2reg("", true_cfg.window_encoder)
    tok = _write_pth(tmp_path / "tok.pth", dict(tok_sd), {
        "embedding_dim": TOKEN_E, "num_heads": TOKEN_HEADS, "num_layers": 2, "vocab_size": 32,
        "use_context": True, "seq_pool": None})
    start = ModelConfig(window_encoder=dataclasses.replace(base.window_encoder, num_heads=4),
                        seq2gene=Seq2GeneConfig(emb_dim=8, num_heads=2, num_layers=5))
    if case == "whole_file":
        start = true_cfg
    return start, model, tok


@pytest.mark.parametrize("case", ["calibrated", "multi_head", "whole_file"])
def test_model_manager_matches_jax(tmp_path, case):
    start, model, tok = _model_files(tmp_path, case)
    jax_cfg = dataclasses.replace(start, checkpoint_path=model)
    ref = JaxManager(jax_cfg, tokenizer_checkpoint_path=tok).load_model(param_dtype=jnp.float32)
    got = ModelManager(port_config(jax_cfg), tokenizer_checkpoint_path=tok).load_model(
        torch.float32, device="cpu")
    assert dataclasses.asdict(got.config) == dataclasses.asdict(ref.config)
    assert got.config.seq2gene.multi_head == (case == "multi_head")
    assert not got.config.window_encoder.use_context   # from the weights, not the hyper
    assert got.config.window_encoder.num_heads == TOKEN_HEADS
    _assert_trees_equal(got.params, jax.tree.map(np.asarray, ref.params))
    bf16 = ModelManager(port_config(jax_cfg)).load_model(device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in _flat(bf16.params).values())
    assert count_params(bf16.params) == jax_count_params(ref.params)


def test_port_checkpoint_round_trip(tmp_path):
    cfg = port_config(tiny_config())
    params = init_seq2gene(cfg, seed=0, device="cpu")
    save_checkpoint(tmp_path / "ckpt", params, cfg)
    loaded, loaded_cfg = load_checkpoint(tmp_path / "ckpt", device="cpu")
    _assert_trees_equal(loaded, to_numpy(params))
    assert loaded_cfg == cfg
    half, _ = load_checkpoint(tmp_path / "ckpt", dtype=torch.bfloat16, device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in _flat(half).values())
    save_checkpoint(tmp_path / "bare", to_numpy(params))
    assert load_checkpoint(tmp_path / "bare", device="cpu")[1] is None


def test_convert_torch_checkpoint_and_cli(tmp_path):
    cfg = tiny_config()
    sd = reference_sd(cfg)
    pth = _write_pth(tmp_path / "m.pth", sd, {"emb_dim": 24})
    kw = dict(num_heads=cfg.seq2gene.num_heads, encoder_num_heads=cfg.window_encoder.num_heads)
    tree, hyper = convert_torch_checkpoint(pth, str(tmp_path / "out"), **kw)
    assert hyper == {"emb_dim": 24}
    want = jax_convert.convert_seq2gene(sd, **kw)
    _assert_trees_equal(load_checkpoint(tmp_path / "out", device="cpu")[0], want)
    proc = subprocess.run(
        [sys.executable, "-m", "variantformer_tpu_torch.models.checkpoint", pth,
         str(tmp_path / "cli"), "--num-heads", "4", "--encoder-num-heads", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    _assert_trees_equal(load_checkpoint(tmp_path / "cli", device="cpu")[0], want)


def test_init_window_encoder_and_count_params():
    cfg = tiny_config()
    port = init_window_encoder(port_config(cfg.window_encoder), seed=0, device="cpu")
    want = jax.eval_shape(lambda k: jax_init_encoder(k, cfg.window_encoder), jax.random.key(0))
    assert {k: tuple(v.shape) for k, v in _flat(port).items()} == {
        k: tuple(v.shape) for k, v in _flat(want).items()}
    shapes = jax.eval_shape(lambda k: jax_init(k, cfg), jax.random.key(0))
    port_tree = init_seq2gene(port_config(cfg), 0, device="cpu")
    assert count_params(port_tree) == count_params(to_numpy(port_tree)) == \
        jax_count_params(shapes)


# -- manifests, fetcher, retry ----------------------------------------------

def test_manifest_lookup(tmp_path):
    manifest = tmp_path / "manifest.parquet"
    files, rows = {}, []
    for gene in ["G1", "G2"]:
        f = tmp_path / f"{gene}.csv"
        f.write_text("a,b\n1,2\n")
        rows.append({"gene_id": gene, "file_path": str(f)})
        files[gene] = str(f)
    pd.DataFrame(rows).to_parquet(manifest)
    lookup = ManifestLookup(str(manifest), ("gene_id",))
    assert lookup.exists("G1") and not lookup.exists("G3")
    assert lookup.get_file_path("G2") == files["G2"]
    assert lookup.get_file_path("G3") is None
    assert lookup.get_unique("gene_id") == ["G1", "G2"]


def test_two_key_manifest(tmp_path):
    manifest = tmp_path / "m.parquet"
    f = tmp_path / "x.bin"
    f.write_bytes(b"x")
    pd.DataFrame([{"gene_id": "G1", "population": "EUR", "file_path": str(f)}]).to_parquet(
        manifest)
    lookup = ManifestLookup(str(manifest), ("gene_id", "population"))
    assert lookup.exists("G1", "EUR") and not lookup.exists("G1", "AFR")
    assert lookup.get_record("G1", "EUR").file_path == str(f)


def test_cached_fetcher_fetches_once(tmp_path):
    """Threads fetching one object at once converge on one file, fetched
    once; a failing transport is retried."""
    src = tmp_path / "remote"
    src.mkdir()
    (src / "a.bin").write_bytes(b"payload")
    calls = []

    def transport(rel, dst):
        calls.append(rel)
        if len(calls) == 1:
            raise OSError("transient")
        Path(dst).write_bytes((src / rel).read_bytes())

    fetcher = CachedFetcher(tmp_dir=tmp_path / "cache", transport=transport)
    with ThreadPoolExecutor(max_workers=8) as pool:
        paths = set(pool.map(lambda _: fetcher.get("a.bin"), range(16)))
    assert len(paths) == 1 and Path(paths.pop()).read_bytes() == b"payload"
    assert calls == ["a.bin", "a.bin"]


def test_retry_with_backoff():
    attempts = []

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise OSError("transient")
        return "ok"

    assert retry_with_backoff(flaky, initial_delay=0.001) == "ok" and len(attempts) == 3
    with pytest.raises(TypeError):   # permanent: raised at once
        retry_with_backoff(lambda: (_ for _ in ()).throw(TypeError("bug")), initial_delay=0.001)
    with pytest.raises(OSError):
        retry_with_backoff(lambda: (_ for _ in ()).throw(OSError("down")), timeout=0.01,
                           initial_delay=0.005)


# -- the processor ----------------------------------------------------------

def _processor_pth(tmp_path, cfg, use_context=False):
    """The tiny vcf2exp config's weights as a reference-layout .pth."""
    sd = reference_sd(cfg, seed=5, context_encoder=use_context)
    return _write_pth(tmp_path / "vf.pth", sd, {"emb_dim": cfg.seq2gene.emb_dim})


def test_load_model_then_predict_matches_jax_f32(genome, tmp_path):  # noqa: F811
    cfg = _cfg()
    pth = _processor_pth(tmp_path, cfg)
    query = pd.DataFrame({"gene_id": GENES, "tissues": ["tissue0,tissue3", "tissue5"]})

    jax_sources = dataclasses.replace(_sources(genome, JaxSources), checkpoint_path=pth)
    jax_proc = JaxProcessor(sources=jax_sources, config=cfg, impl="xla")
    jax_proc.load_model(param_dtype=jnp.float32)
    ref = jax_proc.predict(genome["vcf"], query)

    sources = dataclasses.replace(_sources(genome, DataSources), checkpoint_path=pth)
    proc = VCFProcessor(sources=sources, config=port_config(cfg), device="cpu")
    params = proc.load_model(param_dtype=torch.float32)
    assert params["gene_layers"]["mixer"]["wqkv"]["w"].dtype == torch.float32
    assert dataclasses.asdict(proc.config) == dataclasses.asdict(jax_proc.config)
    out = proc.predict(genome["vcf"], query)
    assert list(out["gene_id"]) == list(ref["gene_id"])
    for col in ("predicted_expression", "embeddings"):
        for got, want in zip(out[col], ref[col]):
            assert got.shape == want.shape, col
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=col)

    assert list(proc.get_tissues()) == [f"tissue{i}" for i in range(8)]
    (validated, builder), loader = proc.create_data(genome["vcf"], query)
    assert list(validated["gene_id"]) == GENES
    for (row, sample), gene in zip(loader, GENES):
        assert row["gene_id"] == sample.gene_id == gene
        np.testing.assert_array_equal(sample.cre_tokens, builder.build(gene).cre_tokens)
    proc.cleanup()
    with pytest.raises(RuntimeError, match="load_model"):
        proc.predict(genome["vcf"], query)


def test_predict_reads_the_cre_map_manifest(genome, tmp_path, monkeypatch):  # noqa: F811
    """With no provider, ``predict`` reads the per-gene CRE maps through
    ``assets.gene_cre_manifest`` (here a local parquet under
    ``$VFX_ARTIFACTS_DIR``) and gives what the explicit provider gives."""
    artifacts = tmp_path / "artifacts"
    manifest = artifacts / "model/common/cres_all_genes_manifest.parquet"
    manifest.parent.mkdir(parents=True)
    rows = []
    for gene, cre in genome["cre_maps"].items():
        csv = tmp_path / f"{gene}.csv"
        cre.assign(extra_column=1).to_csv(csv, index=False)
        rows.append({"gene_id": gene, "file_path": str(csv)})
    pd.DataFrame(rows).to_parquet(manifest)
    monkeypatch.setenv("VFX_ARTIFACTS_DIR", str(artifacts))
    assert assets.artifacts_dir() == artifacts

    cfg = port_config(_cfg())
    params = init_seq2gene(cfg, seed=2, device="cpu")
    query = pd.DataFrame({"gene_id": GENES, "tissues": ["tissue1", "tissue1"]})
    outs = []
    for provider in (genome["cre_maps"].__getitem__, None):
        sources = dataclasses.replace(_sources(genome, DataSources), cre_map_provider=provider)
        proc = VCFProcessor(sources=sources, config=cfg, device="cpu")
        proc.set_params(params)
        outs.append(np.stack(proc.predict(genome["vcf"], query)["predicted_expression"]))
    np.testing.assert_array_equal(outs[1], outs[0])
    with pytest.raises(KeyError, match="NOPE"):
        DataSources().default_cre_map_provider()("NOPE.1")


def test_context_checkpoint_loads_but_does_not_run(genome, tmp_path):  # noqa: F811
    cfg = _cfg()
    pth = _processor_pth(tmp_path, cfg, use_context=True)
    sources = dataclasses.replace(_sources(genome, DataSources), checkpoint_path=pth)
    proc = VCFProcessor(sources=sources, config=port_config(cfg), device="cpu")
    params = proc.load_model(param_dtype=torch.float32)
    assert proc.config.window_encoder.use_context
    assert "cross" in params["cre_tokenizer"]["layers"]
    query = pd.DataFrame({"gene_id": GENES[:1], "tissues": ["tissue0"]})
    with pytest.raises(NotImplementedError, match="context"):
        proc.predict(genome["vcf"], query)


def test_load_model_needs_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        ModelManager(port_config(tiny_config())).load_model()
    with pytest.raises(RuntimeError, match="cuda"):
        load_checkpoint("/nonexistent")

"""The port's model variants against the JAX package's, on the CPU.

The variants: the context-flavour window encoder (``use_context``), max
pooling, cross-only gene layers (``only_cross_attention``), the gene
stack's residual (``use_res``) and head dims the attention kernels are not
built for (padded to 64 or 128 lanes in the packs). Weights come from the JAX
package's ``init_*`` through the weight bridge. Tolerances: 1e-4 against
``impl="xla"`` in float32 (the same algorithm, summed in another order);
5e-2 (pred) / 6e-2 (embeddings) against ``impl="fused2"`` in bf16, the bound
the JAX package holds its Pallas path to. The route each config takes (the
whole-stack wrappers or the plain loops) is held to the JAX package's rule
for its Pallas kernels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_model_smoke import tiny_batch, tiny_config
from tests.torch_port_helpers import as_f32, port_batch, port_config, port_params
from variantformer_tpu.config import PrecisionPolicy, WindowEncoderConfig
from variantformer_tpu.models import seq2gene as jax_seq2gene
from variantformer_tpu.models.core import AttnSpec as JaxSpec
from variantformer_tpu.models.init import _context_layer_stack, init_seq2gene, init_window_encoder
from variantformer_tpu.models.seq2reg import classify_windows as jax_classify
from variantformer_tpu.models.seq2reg import encode_windows as jax_encode
from variantformer_tpu.ops import fused_encoder as jax_fe
from variantformer_tpu.ops import fused_modulator as jax_fm
from variantformer_tpu.train import optimizer as JO
from variantformer_tpu.train.steps import TrainState as JaxTrainState
from variantformer_tpu.train.steps import make_seq2gene_train_step as jax_train_step
from variantformer_tpu_torch.models import seq2gene as port_seq2gene
from variantformer_tpu_torch.models import seq2reg as port_seq2reg
from variantformer_tpu_torch.models.core import AttnSpec
from variantformer_tpu_torch.models.params import to_numpy
from variantformer_tpu_torch.models.seq2gene import seq2gene_forward, whole_gene_stack
from variantformer_tpu_torch.models.seq2reg import (
    classify_windows,
    encode_windows,
    encode_windows_dual,
    whole_stack,
)
from variantformer_tpu_torch.ops import fused_encoder
from variantformer_tpu_torch.ops.alibi import alibi_slopes
from variantformer_tpu_torch.ops.fused_encoder import pack_encoder_layers
from variantformer_tpu_torch.ops.fused_modulator import fused_gene_modulator, pack_gene_layers
from variantformer_tpu_torch.train.optimizer import make_optimizer
from variantformer_tpu_torch.train.steps import TrainState, make_seq2gene_train_step

# The variants of the chip run's variants_path, (a)-(d); (e), a head dim
# other than 48 and 64, is the padded-pack cases below.
VARIANTS = {
    "a_context": {"use_context": True},
    "b_max_pool": {"seq_pool": "max"},
    "c_only_cross": {"only_cross_attention": True},
    "d_only_cross_res": {"only_cross_attention": True, "use_res": True},
}
_WINDOW_FIELDS = ("use_context", "seq_pool", "num_heads", "embedding_dim")


def _variant(cfg, f32=True, **kw):
    """``cfg`` with window-encoder and gene-stack fields replaced."""
    w = {k: v for k, v in kw.items() if k in _WINDOW_FIELDS}
    g = {k: v for k, v in kw.items() if k not in _WINDOW_FIELDS}
    cfg = dataclasses.replace(
        cfg, window_encoder=dataclasses.replace(cfg.window_encoder, **w),
        seq2gene=dataclasses.replace(cfg.seq2gene, **g),
    )
    if f32:
        cfg = dataclasses.replace(cfg, precision=PrecisionPolicy(compute_dtype="float32"))
    return cfg


def _assert_outputs(out, ref, pred_tol, emb_tol):
    np.testing.assert_allclose(as_f32(out.pred_expression), as_f32(ref.pred_expression),
                               rtol=pred_tol, atol=pred_tol)
    np.testing.assert_allclose(as_f32(out.pooled_embedding), as_f32(ref.pooled_embedding),
                               rtol=emb_tol, atol=emb_tol)


# --- the window encoder ----------------------------------------------------------

E, H, LAYERS, FFN, L, N = 32, 4, 2, 64, 12, 7


def _enc_cfg(use_context, seq_pool, heads=H, e=E):
    return WindowEncoderConfig(
        vocab_size=40, embedding_dim=e, num_heads=heads, num_layers=LAYERS, ffn_hidden_dim=FFN,
        token_length=L, num_tissues=5, num_classes=3, use_context=use_context,
        seq_pool=seq_pool,
    )


def _enc_inputs(seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, 40, (N, L)).astype(np.int32)
    tok_len = rng.integers(1, L + 1, N).astype(np.int32)
    tok_len[:2] = [1, L]
    # ids 9 and 10 lie past the 9-row context table (the shard writer's
    # 11-class ids): both packages read its last row
    context = rng.integers(0, 11, N).astype(np.int32)
    context[:2] = [9, 10]
    return tokens, tok_len, context


@pytest.mark.parametrize("seq_pool", ["mean", "max"])
@pytest.mark.parametrize("use_context", [False, True])
def test_encode_windows_matches_jax_xla_f32(use_context, seq_pool):
    cfg = _enc_cfg(use_context, seq_pool)
    params = init_window_encoder(jax.random.key(1), cfg)
    tokens, tok_len, context = _enc_inputs(2)
    ref = jax_encode(params, jnp.asarray(tokens), jnp.asarray(tok_len), jnp.asarray(context),
                     cfg, JaxSpec(H, E // H), jnp.float32)
    out = encode_windows(port_params(params), torch.from_numpy(tokens),
                         torch.from_numpy(tok_len), torch.from_numpy(context), port_config(cfg),
                         AttnSpec(H, E // H), torch.float32)
    assert out.shape == (N, E) and out.dtype == torch.float32
    np.testing.assert_allclose(as_f32(out), as_f32(ref), rtol=1e-4, atol=1e-4)
    if use_context:
        # the context flavour reads the labels: other labels, other output
        other = encode_windows(port_params(params), torch.from_numpy(tokens),
                               torch.from_numpy(tok_len), torch.from_numpy((context + 1) % 8),
                               port_config(cfg), AttnSpec(H, E // H), torch.float32)
        assert not torch.allclose(other, out)


def test_classify_windows_matches_jax():
    cfg = _enc_cfg(False, "mean")
    params = init_window_encoder(jax.random.key(3), cfg)
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(N, E)).astype(np.float32)
    tissues = rng.integers(0, 5, N).astype(np.int32)
    ref = jax_classify(params, jnp.asarray(emb), jnp.asarray(tissues))
    out = classify_windows(port_params(params), torch.from_numpy(emb), torch.from_numpy(tissues))
    assert out.shape == (N, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(as_f32(out), as_f32(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("which", ["cross_only", "self_only"])
def test_core_layers_match_jax(which):
    """The cross-only and self-only layer blocks (norm names and res_long
    wiring) against the JAX package's at f32 1e-5."""
    from variantformer_tpu.models import core as jax_core
    from variantformer_tpu_torch.models import core as port_core

    layers = _context_layer_stack(jax.random.key(12), 1, E, FFN)
    p = jax.tree.map(lambda a: a[0], layers)
    rng = np.random.default_rng(12)
    x = rng.normal(size=(3, 5, E)).astype(np.float32)
    ctx = rng.normal(size=(3, 4, E)).astype(np.float32)
    lens = np.array([5, 2, 1], np.int32)
    spec, jspec = AttnSpec(H, E // H), JaxSpec(H, E // H)
    if which == "cross_only":
        ref = jax_core.cross_only_encoder_layer(p, jnp.asarray(x), jnp.asarray(ctx),
                                                jnp.asarray(lens), jspec, jnp.float32)
        out = port_core.cross_only_encoder_layer(port_params(p), torch.from_numpy(x),
                                                 torch.from_numpy(ctx), torch.from_numpy(lens),
                                                 spec, torch.float32)
    else:
        slopes = alibi_slopes(H)
        ref = jax_core.self_only_encoder_layer(p, jnp.asarray(x), jnp.asarray(lens),
                                               jnp.asarray(slopes), jspec, jnp.float32)
        out = port_core.self_only_encoder_layer(port_params(p), torch.from_numpy(x),
                                                torch.from_numpy(lens), torch.from_numpy(slopes),
                                                spec, torch.float32)
    np.testing.assert_allclose(as_f32(out), np.asarray(ref), rtol=1e-5, atol=1e-5)


# --- the whole forward ------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_matches_jax_xla_f32(variant):
    cfg = _variant(tiny_config(), **VARIANTS[variant])
    params = init_seq2gene(jax.random.key(4), cfg)
    batch = tiny_batch(np.random.default_rng(4))
    ref = jax_seq2gene.seq2gene_forward(params, batch, cfg, impl="xla")
    out = seq2gene_forward(port_params(params), port_batch(batch), port_config(cfg))
    _assert_outputs(out, ref, 1e-4, 1e-4)


@pytest.mark.parametrize("variant", ["a_context", "c_only_cross"])
def test_forward_matches_jax_fused2_bf16(variant):
    """(a) runs the JAX Pallas gene stack and (c) its Pallas encoder, both
    in interpret mode here; the port's plain versions of the same routes."""
    cfg = _variant(tiny_config(), f32=False, **VARIANTS[variant])
    params = init_seq2gene(jax.random.key(5), cfg)
    batch = tiny_batch(np.random.default_rng(5))
    ref = jax_seq2gene.seq2gene_forward(params, batch, cfg, impl="fused2")
    out = seq2gene_forward(port_params(params), port_batch(batch), port_config(cfg))
    _assert_outputs(out, ref, 5e-2, 6e-2)


# Configs whose route is held to the JAX package's: the variants, the
# released flavour, use_res alone, and gene head dims 12 (padded to 64 on
# the card) and 80 (past the kernels: the plain loop, as JAX's XLA path).
ROUTES = {
    "released": {},
    **VARIANTS,
    "use_res": {"use_res": True},
    "gene_hd12": {"num_heads": 2},
    "gene_hd80": {"emb_dim": 160, "num_heads": 2},
}


def _spy(monkeypatch, module, name, calls, fn=None):
    original = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return (fn or original)(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("config", sorted(ROUTES))
def test_route_matches_jax_rule(config, monkeypatch):
    """The port takes its whole-stack encoder where the JAX package's
    ``impl="fused2"`` takes its Pallas encoder, and its whole-stack gene
    stack where JAX takes its Pallas modulator. The JAX kernels and its
    layered ``encode_windows`` are spied and stood in for by shapes (no
    Pallas program runs here: JAX's fused2 refuses max pooling inside its
    Pallas encoder, which implements the mean; its XLA path runs it); the
    port's whole-stack wrappers are spied and run."""
    kw = dict(ROUTES[config])
    if "emb_dim" in kw:
        kw["ffn_hidden_dim"] = 2 * kw["emb_dim"]
    cfg = _variant(tiny_config(), f32=False, **kw)
    batch = tiny_batch(np.random.default_rng(6))
    jax_calls: list = []
    pooled = lambda x, *a: jnp.zeros((x.shape[0], x.shape[-1]), x.dtype)
    _spy(monkeypatch, jax_fe, "fused_window_encoder_dual_diff", jax_calls,
         lambda xa, la, pa, xb, lb, pb, *a: (pooled(xa), pooled(xb)))
    _spy(monkeypatch, jax_seq2gene, "encode_windows", jax_calls,
         lambda p, tokens, *a: jnp.zeros((tokens.shape[0], p["token_embedding"].shape[1])))
    _spy(monkeypatch, jax_fm, "fused_gene_modulator_diff", jax_calls, lambda g, *a: g)
    _spy(monkeypatch, jax_fm, "fused_gene_modulator_packed", jax_calls, lambda g, *a, **k: g)
    jax_seq2gene.seq2gene_forward(init_seq2gene(jax.random.key(6), cfg), batch, cfg,
                                  impl="fused2")
    jax_route = ("fused_window_encoder_dual_diff" in jax_calls,
                 "fused_gene_modulator_diff" in jax_calls)

    port_calls: list = []
    for name in ("fused_window_encoder", "fused_window_encoder_plain",
                 "fused_window_encoder_diff"):
        _spy(monkeypatch, port_seq2reg, name, port_calls)
    for name in ("fused_gene_modulator", "fused_gene_modulator_plain",
                 "fused_gene_modulator_diff"):
        _spy(monkeypatch, port_seq2gene, name, port_calls)
    pcfg = port_config(cfg)
    params = port_params(init_seq2gene(jax.random.key(6), cfg))
    out = seq2gene_forward(params, port_batch(batch), pcfg)
    assert torch.isfinite(out.pred_expression).all()
    port_route = (port_calls.count("fused_window_encoder") == 2,
                  "fused_gene_modulator" in port_calls)
    assert port_route == jax_route == (whole_stack(pcfg.window_encoder), whole_gene_stack(pcfg))
    assert not {"fused_window_encoder_plain", "fused_gene_modulator_plain"} & set(port_calls)


def test_pools_with_context_raise():
    """Window-dedup pools carry no per-window labels: with the context
    encoder both packages refuse them."""
    cfg = _variant(tiny_config(), **VARIANTS["a_context"])
    batch = tiny_batch(np.random.default_rng(7))
    d, c, length = batch.cre_tokens.shape
    g = batch.gene_tokens.shape[1]
    pools = dict(
        cre_pool_tokens=batch.cre_tokens.reshape(d * c, length),
        cre_pool_len=batch.cre_tok_len.reshape(d * c),
        cre_gather=jnp.arange(d * c, dtype=jnp.int32).reshape(d, c),
        gene_pool_tokens=batch.gene_tokens.reshape(d * g, length),
        gene_pool_len=batch.gene_tok_len.reshape(d * g),
        gene_gather=jnp.arange(d * g, dtype=jnp.int32).reshape(d, g),
    )
    pooled = batch._replace(**pools)
    params = init_seq2gene(jax.random.key(7), cfg)
    with pytest.raises(ValueError, match="context-free"):
        jax_seq2gene.seq2gene_forward(params, pooled, cfg, impl="xla")
    with pytest.raises(ValueError, match="context-free"):
        seq2gene_forward(port_params(params), port_batch(pooled), port_config(cfg))


# --- heads padded in the packs --------------------------------------------------


@pytest.mark.parametrize("hd", [8, 12, 32, 96])
def test_encoder_padded_heads_match_jax_xla_f32(hd):
    """The whole-stack encoder on packs whose heads are padded to 64 lanes
    (128 above 64, as the JAX package pads them; its plain version here,
    the kernels' operands on the card) against the JAX layer loop."""
    heads = 2
    e = heads * hd
    lanes = 64 if hd <= 64 else 128
    cfg = _enc_cfg(False, "mean", heads=heads, e=e)
    params = init_window_encoder(jax.random.key(8), cfg)
    tokens, tok_len, context = _enc_inputs(8)
    ref = jax_encode(params, jnp.asarray(tokens), jnp.asarray(tok_len), jnp.asarray(context),
                     cfg, JaxSpec(heads, hd), jnp.float32)
    pp = port_params(params)
    packed = pack_encoder_layers(pp["layers"], heads, torch.float32)
    assert packed["wqkv"].shape == (LAYERS, e, 3 * heads * lanes)
    assert packed["wout"].shape == (LAYERS, heads * lanes, e)
    t, n = torch.from_numpy(tokens), torch.from_numpy(tok_len)
    out, _ = encode_windows_dual(pp, t, n, pp, t, n, port_config(cfg), AttnSpec(heads, hd),
                                 torch.float32)
    np.testing.assert_allclose(as_f32(out), as_f32(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("hd", [8, 12, 32])
def test_gene_stack_padded_heads_match_jax_xla_f32(hd):
    """The whole gene stack on packs whose heads are padded to 64 lanes
    against the JAX package's ``_gene_layer`` loop (valid gene rows)."""
    heads, nl, t, g1, c = 2, 2, 3, 6, 5
    e = heads * hd
    layers = _context_layer_stack(jax.random.key(9), nl, e, 2 * e)
    rng = np.random.default_rng(9)
    gene = (rng.normal(size=(2, t, g1, e)) * 0.5).astype(np.float32)
    cre = (rng.normal(size=(nl, 2, c, e)) * 0.5).astype(np.float32)
    gene_len, cre_len = [g1, 4], [c, 2]
    slopes = alibi_slopes(heads)
    x = jnp.asarray(gene)
    for i in range(nl):
        x = jax_seq2gene._gene_layer(
            jax.tree.map(lambda a: a[i], layers), x, jnp.asarray(cre[i]),
            jnp.asarray(gene_len, jnp.int32), jnp.asarray(cre_len, jnp.int32),
            jnp.asarray(slopes), False, JaxSpec(heads, hd), jnp.float32)
    packed = pack_gene_layers(port_params(layers), heads, torch.float32)
    assert packed["wcq"].shape == (nl, e, heads * 64)
    assert packed["wco"].shape == (nl, heads * 64, e)
    out = fused_gene_modulator(
        torch.from_numpy(gene), torch.from_numpy(cre), torch.tensor(gene_len, dtype=torch.int32),
        torch.tensor(cre_len, dtype=torch.int32), packed, torch.from_numpy(slopes),
        hd ** -0.5, heads)
    for i, n in enumerate(gene_len):
        np.testing.assert_allclose(as_f32(out[i, :, :n]), np.asarray(x[i, :, :n]),
                                   rtol=1e-4, atol=1e-4)


def test_encoder_head_dims_past_64_raise():
    """A head dim of 65-128 goes to the JAX package's Pallas encoder (padded
    to 128 lanes); the port packs it the same way, and the card's kernel
    chains take the 128-lane packs (``attention`` and ``attention_bwd`` are
    built for head dim 128). Past 128 the pack refuses, as the JAX
    package's does; a pack of a width no build takes is refused by name
    before any launch."""
    heads = 2
    layers = port_params(_context_layer_stack(jax.random.key(0), 1, heads * 96, 64))
    packed = pack_encoder_layers(layers, heads, torch.float32)
    assert packed["wqkv"].shape[-1] == 3 * heads * 128
    fused_encoder.require_kernel_lanes(128)
    with pytest.raises(NotImplementedError, match="96-lane heads"):
        fused_encoder.require_kernel_lanes(96)
    layers = port_params(_context_layer_stack(jax.random.key(0), 1, heads * 130, 64))
    with pytest.raises(NotImplementedError, match="> 128"):
        pack_encoder_layers(layers, heads, torch.float32)


# --- training steps ---------------------------------------------------------------


@pytest.mark.mid
@pytest.mark.parametrize("variant", ["a_context", "c_only_cross"])
def test_train_steps_match_jax_xla_f32(variant):
    """Two f32 steps of both packages' seq2gene train step from the same
    parameters (CRE tokenizer frozen, gene tokenizer trained, remat on):
    losses and every parameter leaf within 1e-4."""
    cfg = _variant(tiny_config(), remat=True, **VARIANTS[variant])
    params = init_seq2gene(jax.random.key(10), cfg)
    batch = tiny_batch(np.random.default_rng(10))
    targets = np.random.default_rng(11).uniform(0, 3, (2, 3)).astype(np.float32)
    mask = np.ones((2, 3), bool)
    mask[0, 1] = False
    tx = JO.make_optimizer(params, learning_rate=1e-3, train_gene_tokenizer=True)
    state = JaxTrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = jax_train_step(cfg, tx, impl="xla", freeze_tokenizers=True, train_gene_tokenizer=True)
    ported = port_params(params)
    opt = make_optimizer(ported, learning_rate=1e-3, train_gene_tokenizer=True)
    pstate = TrainState(ported, opt, 0)
    pstep = make_seq2gene_train_step(port_config(cfg), opt, freeze_tokenizers=True,
                                     train_gene_tokenizer=True)
    for _ in range(2):
        state, jloss = step(state, batch, jnp.asarray(targets), jnp.asarray(mask))
        pstate, ploss = pstep(pstate, port_batch(batch), torch.from_numpy(targets),
                              torch.from_numpy(mask))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-4)
    got = to_numpy(pstate.params)
    for path, want in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        want = np.asarray(want)
        rel = np.linalg.norm(leaf - want) / max(np.linalg.norm(want), 1e-12)
        assert rel < 1e-4, f"{jax.tree_util.keystr(path)}: rel L2 {rel}"
    before = to_numpy(port_params(params))
    moved = lambda name: any(not np.array_equal(a, b) for a, b in zip(
        jax.tree.leaves(got[name]), jax.tree.leaves(before[name])))
    assert moved("cre_map") and moved("gene_layers")
    # Cross-only gene layers treat each gene row alone, so the registry row
    # the heads read never sees the gene windows: the gene tokenizer gets a
    # zero gradient in both packages, and (Adam) does not move.
    assert moved("gene_tokenizer") == (variant == "a_context")
    assert not moved("cre_tokenizer")

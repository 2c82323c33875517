"""The port's seq2gene training path against the JAX package's, on the CPU.

Losses, optimizer masks, Adam/AdamW updates, the plateau tracker, the train
step, the shard writer and batches, and ``fit`` with checkpoint and resume.
Parameters come from the JAX package's ``init_seq2gene`` through the weight
bridge; inputs are made with numpy from a seed and handed to both packages.
Tolerances: 1e-5 for the losses, 1e-6 for optimizer updates on the same
gradients, 1e-4 for three f32 train steps against ``impl="xla"`` (the same
algorithm, only the summation order differs) and 5e-2 for three bf16 steps
against ``impl="fused2"`` (the bound ``tests/test_fused_modulator_vjp.py``
holds fused2 to; the Pallas kernels use tanh GELU).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_model_smoke import tiny_batch, tiny_config
from tests.test_torch_vcfprocessor import GENES, _builders, genome  # noqa: F401
from tests.torch_port_helpers import port_batch, port_config, port_params
from variantformer_tpu.config import PrecisionPolicy
from variantformer_tpu.data.train_pipeline import TrainingShardWriter as JaxShardWriter
from variantformer_tpu.models.init import init_seq2gene
from variantformer_tpu.train import losses as JL
from variantformer_tpu.train import optimizer as JO
from variantformer_tpu.train.loop import PlateauTracker as JaxPlateau
from variantformer_tpu.train.loop import seq2gene_shard_batches as jax_shard_batches
from variantformer_tpu.train.steps import TrainState as JaxTrainState
from variantformer_tpu.train.steps import make_seq2gene_train_step as jax_train_step
from variantformer_tpu_torch.data.train_pipeline import TrainingShardWriter, load_shard
from variantformer_tpu_torch.models.params import leaves, to_numpy
from variantformer_tpu_torch.train import losses as L
from variantformer_tpu_torch.train.loop import (
    PlateauTracker,
    fit,
    load_train_state,
    make_seq2gene_eval_loss,
    seq2gene_shard_batches,
)
from variantformer_tpu_torch.train.optimizer import (
    apply_update,
    decay_mask,
    make_optimizer,
    set_lr_scale,
    trainable_mask,
)
from variantformer_tpu_torch.train.steps import TrainState, make_seq2gene_train_step


def _f32(cfg):
    return dataclasses.replace(cfg, precision=PrecisionPolicy(compute_dtype="float32"))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


# --- losses -----------------------------------------------------------------


@pytest.mark.parametrize("name", ["poisson_nll", "mse"])
def test_regression_losses_match_jax(name):
    rng = np.random.default_rng(0)
    pred = rng.uniform(0.01, 5.0, 64).astype(np.float32)
    target = rng.integers(0, 8, 64).astype(np.float32)
    ours = getattr(L, name)(torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    ref = np.asarray(getattr(JL, name)(jnp.asarray(pred), jnp.asarray(target)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("loss_type", ["cross_entropy", "weighted_cross_entropy", "focal"])
def test_classification_losses_match_jax(loss_type):
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((16, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 16).astype(np.int32)
    weights = np.asarray([1.0, 2.0, 0.5, 3.0, 1.5], np.float32)
    ours = L.get_classification_loss(loss_type, 2.0, weights)(
        torch.from_numpy(logits), torch.from_numpy(labels)).numpy()
    ref = np.asarray(JL.get_classification_loss(loss_type, 2.0, weights)(
        jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("logit_scale", [None, 0.7])
def test_dual_contrastive_loss_matches_jax(logit_scale):
    emb = np.random.default_rng(2).standard_normal((6, 3, 4)).astype(np.float32)
    scale_t = None if logit_scale is None else torch.tensor(logit_scale)
    scale_j = None if logit_scale is None else jnp.asarray(logit_scale)
    ours = float(L.dual_contrastive_loss(torch.from_numpy(emb), scale_t))
    ref = float(JL.dual_contrastive_loss(jnp.asarray(emb), scale_j))
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


# --- optimizer ----------------------------------------------------------------


def _tiny_params(seed=0):
    return init_seq2gene(jax.random.key(seed), tiny_config())


@pytest.mark.parametrize("train_gene_tokenizer", [True, False])
def test_masks_match_jax_leaf_for_leaf(train_gene_tokenizer):
    params = _tiny_params()
    ported = port_params(params)
    keyed = lambda tree: {jax.tree_util.keystr(p): v
                          for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want_d = keyed(JO.decay_mask(params))
    want_t = keyed(JO.trainable_mask(params, train_gene_tokenizer))
    flat = _flat_keys(ported)
    got_d = dict(zip(flat, leaves(decay_mask(ported))))
    got_t = dict(zip(flat, leaves(trainable_mask(ported, train_gene_tokenizer))))
    assert got_d == want_d
    assert got_t == want_t


def _flat_keys(tree, prefix=""):
    if isinstance(tree, dict):
        return [k for name, v in tree.items() for k in _flat_keys(v, f"{prefix}['{name}']")]
    return [prefix]


def _adam_f64(params, grads_seq, scales, lr, wd, decay):
    """Adam/AdamW in float64 numpy, bias corrections exact: the yardstick
    both optimizers are held to."""
    p = {k: np.asarray(v, np.float64) for k, v in params.items()}
    m = {k: np.zeros_like(v) for k, v in p.items()}
    v2 = {k: np.zeros_like(v) for k, v in p.items()}
    for t, (grads, scale) in enumerate(zip(grads_seq, scales), start=1):
        for k in p:
            g = np.asarray(grads[k], np.float64)
            m[k] = 0.9 * m[k] + 0.1 * g
            v2[k] = 0.999 * v2[k] + 0.001 * g * g
            u = (m[k] / (1 - 0.9 ** t)) / (np.sqrt(v2[k] / (1 - 0.999 ** t)) + 1e-8)
            if decay[k]:
                u = u + wd * p[k]
            p[k] = p[k] - lr * scale * u
    return p


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_optimizer_updates_match_optax(kind):
    """Three updates from the same gradients, with a plateau scale != 1 from
    the second on: the port within rtol 1e-6 of Adam/AdamW in float64, and
    within 1e-4 of the JAX package's optax chain. optax computes the bias
    corrections 1 - beta^t in float32, where 1 - 0.999^t keeps only ~4
    significant digits at t <= 3, so its own updates stray ~3e-5 from
    exact; torch computes them in double."""
    params = _tiny_params()
    wd = 0.05 if kind == "adamw" else 0.0
    tx = JO.make_optimizer(params, learning_rate=1e-2, weight_decay=wd, optimizer=kind,
                           train_gene_tokenizer=False)
    opt_state = tx.init(params)
    ported = port_params(params)
    opt = make_optimizer(ported, learning_rate=1e-2, weight_decay=wd, optimizer=kind,
                         train_gene_tokenizer=False)
    assert isinstance(opt, torch.optim.AdamW if kind == "adamw" else torch.optim.Adam)
    rng = np.random.default_rng(3)
    jparams, grads_seq, scales = params, [], (1.0, 0.5, 0.25)
    for scale in scales:
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        grads_seq.append(grads)
        updates, opt_state = tx.update(grads, opt_state, jparams, value=scale)
        jparams = optax.apply_updates(jparams, updates)
        for t, g in zip(leaves(ported), leaves(port_params(grads))):
            t.grad = g if t.requires_grad else None
        set_lr_scale(opt, scale)
        opt.step()
    keyed = lambda tree: {jax.tree_util.keystr(p): np.asarray(v)
                          for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    trainable = keyed(JO.trainable_mask(params, False))
    live = [k for k, on in trainable.items() if on]
    exact = _adam_f64({k: keyed(params)[k] for k in live},
                      [{k: keyed(g)[k] for k in live} for g in grads_seq], scales, 1e-2, wd,
                      keyed(JO.decay_mask(params)))
    want = keyed(jparams)
    got = dict(zip(_flat_keys(ported), leaves(to_numpy(ported))))
    for key in live:
        # tolerances relative to each leaf's scale: an element that the
        # updates brought near 0 keeps the rounding error of its neighbours
        scale = np.abs(exact[key]).max()
        np.testing.assert_allclose(got[key], exact[key], rtol=1e-6, atol=1e-6 * scale,
                                   err_msg=key)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=key)
    for key in set(want) - set(live):  # frozen subtrees never move
        np.testing.assert_array_equal(got[key], np.asarray(keyed(params)[key]), err_msg=key)


def _leaves_sorted(tree):
    """Leaves in jax.tree order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves_sorted(tree[k])]
    return [tree]


def test_unported_optimizer_modes_raise():
    """The two optimizer modes that once raised run: ``plateau="step"`` with
    ``accumulate_steps=2`` (AdamW) follows the JAX package's optax chain
    (``reduce_on_plateau`` outside ``MultiSteps``) over six micro-steps, a
    monitored loss that stops improving included, within 1e-4; the LR scale
    drops where optax's does."""
    params = _tiny_params()
    kw = dict(learning_rate=1e-2, weight_decay=0.05, optimizer="adamw", train_gene_tokenizer=False,
              plateau="step", plateau_patience=1, accumulate_steps=2)
    tx = JO.make_optimizer(params, **kw)
    opt_state = tx.init(params)
    ported = port_params(params)
    opt = make_optimizer(ported, **kw)
    rng = np.random.default_rng(5)
    jparams = params
    for loss in (1.0, 0.8, 0.9, 0.9, 0.95, 0.97):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        updates, opt_state = tx.update(grads, opt_state, jparams, value=jnp.float32(loss))
        jparams = optax.apply_updates(jparams, updates)
        for t, g in zip(leaves(ported), leaves(port_params(grads))):
            t.grad = g if t.requires_grad else None
        apply_update(opt, loss)
    assert opt.monitor.scale < 1.0
    keyed = lambda tree: {jax.tree_util.keystr(p): np.asarray(v)
                          for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    want = keyed(jparams)
    got = dict(zip(_flat_keys(ported), leaves(to_numpy(ported))))
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=key)


@pytest.mark.parametrize("cooldown", [0, 2])
def test_plateau_tracker_matches_jax(cooldown):
    values = [1.0, 0.9, 0.9, 0.9, 0.9, 0.89, 0.6, 0.61, 0.6, 0.6, 0.6, 0.59, 0.85, 0.84, 0.9]
    ours = PlateauTracker(patience=2, factor=0.5, threshold=1e-4, min_scale=1e-3,
                          cooldown=cooldown)
    ref = JaxPlateau(patience=2, factor=0.5, threshold=1e-4, min_scale=1e-3, cooldown=cooldown)
    assert [ours.update(v) for v in values] == [ref.update(v) for v in values]
    assert ours.state_dict() == ref.state_dict()


# --- the train step ---------------------------------------------------------------


def _run_steps(cfg, impl, lr, n=3):
    """n steps of both packages' train step from the same params and batch
    (CRE tokenizer frozen, gene tokenizer trained): (jax losses, jax params,
    port losses, port params)."""
    params = init_seq2gene(jax.random.key(0), cfg)
    batch = tiny_batch(np.random.default_rng(0))
    targets = np.random.default_rng(1).uniform(0, 3, (2, 3)).astype(np.float32)
    mask = np.ones((2, 3), bool)
    mask[1, 2] = False

    tx = JO.make_optimizer(params, learning_rate=lr, train_gene_tokenizer=True)
    state = JaxTrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = jax_train_step(cfg, tx, impl=impl, freeze_tokenizers=True, train_gene_tokenizer=True)
    jax_losses = []
    for _ in range(n):
        state, loss = step(state, batch, jnp.asarray(targets), jnp.asarray(mask))
        jax_losses.append(float(loss))

    ported = port_params(params)
    opt = make_optimizer(ported, learning_rate=lr, train_gene_tokenizer=True)
    pstate = TrainState(ported, opt, 0)
    pstep = make_seq2gene_train_step(port_config(cfg), opt, freeze_tokenizers=True,
                                     train_gene_tokenizer=True)
    pbatch = port_batch(batch)
    port_losses = []
    for _ in range(n):
        pstate, loss = pstep(pstate, pbatch, torch.from_numpy(targets), torch.from_numpy(mask))
        port_losses.append(float(loss))
    assert pstate.step == n
    return jax_losses, jax.tree.map(np.asarray, state.params), port_losses, to_numpy(
        pstate.params)


@pytest.mark.mid
def test_train_steps_match_jax_xla_f32():
    jl, jp, pl, pp = _run_steps(_f32(tiny_config()), "xla", lr=1e-3)
    np.testing.assert_allclose(pl, jl, rtol=1e-4)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                 _leaves_sorted(pp)):
        rel = _rel_l2(got, want)
        assert rel < 1e-4, f"{jax.tree_util.keystr(path)}: params rel L2 {rel}"
    assert pl[-1] < pl[0]


@pytest.mark.mid
def test_train_steps_match_jax_fused2_bf16():
    jl, jp, pl, pp = _run_steps(tiny_config(), "fused2", lr=3e-3)
    np.testing.assert_allclose(pl, jl, rtol=5e-2)
    before = np.asarray(_tiny_params()["gene_layers"]["ffn_in"]["w"])
    assert np.abs(pp["gene_layers"]["ffn_in"]["w"] - before).max() > 0
    np.testing.assert_array_equal(pp["cre_tokenizer"]["layers"]["ffn_in"]["w"],
                                  np.asarray(_tiny_params()["cre_tokenizer"]["layers"]["ffn_in"]["w"]))


# --- shards, batches and fit ------------------------------------------------------------


def _expression():
    import pandas as pd

    rows = [{"gene_id": g, "donor": "S1", "tissue": f"tissue{t}", "TPM": 1.5 + i + t,
             "FPKM": 0.5 * t} for i, g in enumerate(GENES) for t in (0, 3, 5)]
    rows.append({"gene_id": GENES[0], "donor": "S1", "tissue": "unknown", "TPM": 1.0,
                 "FPKM": 1.0})
    return pd.DataFrame(rows)


def _write_both(genome, tmp_path):  # noqa: F811
    port, ref = _builders(genome, genome["vcf"])
    vocab = {f"tissue{i}": i for i in range(8)}
    ours = TrainingShardWriter({"S1": port}, _expression(), vocab, tmp_path / "port")
    theirs = JaxShardWriter({"S1": ref}, _expression(), vocab, tmp_path / "jax")
    return ours.build_all(GENES, ["S1"]), theirs.build_all(GENES, ["S1"])


def test_shards_match_jax_writer(genome, tmp_path):  # noqa: F811
    ours, theirs = _write_both(genome, tmp_path)
    assert [p.split("/")[-1] for p in ours] == [p.split("/")[-1] for p in theirs]
    assert (tmp_path / "port" / "manifest.json").read_text() == (
        tmp_path / "jax" / "manifest.json").read_text()
    for a, b in zip(ours, theirs):
        za, zb = load_shard(a), load_shard(b)
        assert sorted(za) == sorted(zb)
        for key in za:
            assert za[key].dtype == zb[key].dtype, key
            np.testing.assert_array_equal(za[key], zb[key], err_msg=key)


def test_shard_batches_match_jax(genome, tmp_path):  # noqa: F811
    _write_both(genome, tmp_path)
    tissues = [0, 1, 3, 5]
    ours = seq2gene_shard_batches(tmp_path / "port", tissues, batch_size=3, device="cpu")
    theirs = jax_shard_batches(tmp_path / "jax", tissues, batch_size=3)
    for epoch in (0, 1):
        got, want = list(ours(epoch)), list(theirs(epoch))
        assert len(got) == len(want) == 1
        for (b, t, m), (jb, jt, jm) in zip(got, want):
            for name, leaf in b._asdict().items():
                other = getattr(jb, name)
                if leaf is None:
                    assert other is None, name
                    continue
                np.testing.assert_array_equal(leaf.numpy(), np.asarray(other), err_msg=name)
            np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
            assert not m[-1].any()  # the short batch's pad sample is masked out


def _toy_shards(root, n=5, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        c, g, length = 4 + i % 2, 3, 8
        np.savez(
            root / f"GENE{i}.1__D1.npz",
            cre_tokens=rng.integers(4, 32, (c, length)).astype(np.int32),
            cre_tok_len=np.full(c, length, np.int32),
            cre_labels=rng.integers(0, 9, c).astype(np.int32),
            gene_tokens=rng.integers(4, 32, (g, length)).astype(np.int32),
            gene_tok_len=np.full(g, length, np.int32),
            strand=np.int32(i % 2),
            tissue_ids=np.asarray([0, 2], np.int32),
            targets=np.asarray([1.0 + i, 0.5], np.float32),
        )


@pytest.mark.mid
def test_fit_checkpoints_and_resumes(tmp_path):
    """fit for 2 epochs, then resume to 4, equals 4 epochs straight; the
    checkpoint restores params, optimizer state and step."""
    _toy_shards(tmp_path)
    cfg = port_config(tiny_config())
    tissues = [0, 1, 2]

    def setup():
        params = port_params(_tiny_params())
        opt = make_optimizer(params, learning_rate=3e-3, train_gene_tokenizer=True)
        step = make_seq2gene_train_step(cfg, opt, freeze_tokenizers=True,
                                        train_gene_tokenizer=True)
        return TrainState(params, opt, 0), step

    batches = seq2gene_shard_batches(tmp_path, tissues, batch_size=2, device="cpu")
    eval_loss = make_seq2gene_eval_loss(
        cfg, seq2gene_shard_batches(tmp_path, tissues, batch_size=2, shuffle=False,
                                    device="cpu"))
    state, step = setup()
    straight = fit(state, step, batches, eval_loss=eval_loss, epochs=4)
    assert straight.state.step == 4 * 3
    assert straight.history[-1]["val_loss"] < straight.history[0]["val_loss"]

    state, step = setup()
    ckpt = tmp_path / "ckpt"
    first = fit(state, step, batches, eval_loss=eval_loss, epochs=2, ckpt_dir=ckpt)
    assert (ckpt / "last" / "state.pt").exists() and (ckpt / "best" / "state.pt").exists()
    state, step = setup()
    restored = load_train_state(ckpt / "last", state)
    assert restored.step == first.state.step == 6
    for a, b in zip(leaves(restored.params), leaves(first.state.params)):
        assert torch.equal(a, b)
    state, step = setup()
    resumed = fit(state, step, batches, eval_loss=eval_loss, epochs=4, ckpt_dir=ckpt,
                  resume=True)
    assert [h["epoch"] for h in resumed.history] == [0, 1, 2, 3]
    assert resumed.state.step == straight.state.step
    for a, b in zip(resumed.history, straight.history):
        np.testing.assert_allclose(a["val_loss"], b["val_loss"], rtol=1e-6)
    for a, b in zip(leaves(resumed.state.params), leaves(straight.state.params)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    placed = []  # fit's shard_fn places every batch before the step

    def shard_fn(b):
        placed.append(len(b))
        return b

    fit(state, step, batches, epochs=1, shard_fn=shard_fn)
    assert placed == [3] * len(list(batches(0)))


def test_shard_batches_default_to_the_card(tmp_path):
    """Nothing moves to the CPU on its own: shard batches default to the
    card, and without one they raise, as the other entry points do."""
    _toy_shards(tmp_path, n=1)
    if torch.cuda.is_available():
        batch, _, _ = next(iter(seq2gene_shard_batches(tmp_path, [0])(0)))
        assert batch.cre_tokens.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            seq2gene_shard_batches(tmp_path, [0])

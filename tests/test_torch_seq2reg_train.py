"""The port's seq2reg training path against the JAX package's, on the CPU.

The window classifier's loss (every loss type, class weights, the dual
contrastive loss), its train step, the per-step plateau scale
(``optax.contrib.reduce_on_plateau``), gradient accumulation
(``optax.MultiSteps``), the shard writer and batches, the eval loss and
metrics, and ``fit`` with checkpoints and resume. Parameters come from the
JAX package's ``init_window_encoder`` through the weight bridge; inputs are
made with numpy from a seed. Tolerances: 1e-5 for losses, 1e-4 for three
f32 train steps (the same algorithm, summed in another order, and optax's
float32 Adam bias corrections), 1e-5 for accumulated updates, 1e-7 for the
plateau scale (both float32 state machines), exact for the shards.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from tests.test_torch_vcfprocessor import genome  # noqa: F401
from tests.torch_port_helpers import as_f32, port_config, port_params
from variantformer_tpu.config import ModelConfig, WindowEncoderConfig
from variantformer_tpu.data.train_pipeline import Seq2RegShardWriter as JaxSeq2RegWriter
from variantformer_tpu.models.init import init_window_encoder
from variantformer_tpu.train import optimizer as JO
from variantformer_tpu.train.loop import make_seq2reg_eval_loss as jax_eval_loss
from variantformer_tpu.train.loop import seq2reg_shard_batches as jax_batches
from variantformer_tpu.train.metrics import make_seq2reg_eval_metrics as jax_eval_metrics
from variantformer_tpu.train.steps import TrainState as JaxTrainState
from variantformer_tpu.train.steps import make_seq2reg_train_step as jax_step
from variantformer_tpu.train.steps import seq2reg_loss_fn as jax_loss_fn
from variantformer_tpu.utils.bpe import BPETokenizer as JaxTokenizer
from variantformer_tpu.utils.fasta import FastaReader as JaxFasta
from variantformer_tpu_torch.data.train_pipeline import Seq2RegShardWriter
from variantformer_tpu_torch.models.params import leaves, to_numpy
from variantformer_tpu_torch.train.loop import (
    fit,
    make_seq2reg_eval_loss,
    seq2reg_shard_batches,
)
from variantformer_tpu_torch.train.metrics import (
    classification_metrics,
    make_seq2reg_eval_metrics,
    per_class_f1,
)
from variantformer_tpu_torch.train.optimizer import (
    ReduceOnPlateau,
    ScheduledOptimizer,
    apply_update,
    make_optimizer,
)
from variantformer_tpu_torch.train.steps import (
    TrainState,
    make_seq2reg_train_step,
    seq2reg_loss_fn,
)
from variantformer_tpu_torch.utils.assets import resolve_vocab_path
from variantformer_tpu_torch.utils.bpe import BPETokenizer
from variantformer_tpu_torch.utils.fasta import FastaReader

CHUNK, LENGTH = 8, 16


def _cfg(use_context=False):
    wcfg = WindowEncoderConfig(
        vocab_size=32, embedding_dim=32, num_heads=4, num_layers=1, ffn_hidden_dim=64,
        token_length=LENGTH, num_tissues=2, num_classes=3, use_context=use_context,
    )
    return ModelConfig(window_encoder=wcfg)


def _batch(seed=0, n=CHUNK):
    """(tokens, tok_len, context, tissue_ids, labels): class-0 windows get
    low token ids, the others high ones."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, n).astype(np.int32)
    tokens = np.where(labels[:, None] == 0, rng.integers(4, 16, (n, LENGTH)),
                      rng.integers(16, 28, (n, LENGTH))).astype(np.int32)
    tok_len = rng.integers(1, LENGTH + 1, n).astype(np.int32)
    context = rng.integers(0, 9, n).astype(np.int32)
    tissues = rng.integers(0, 2, n).astype(np.int32)
    return tokens, tok_len, context, tissues, labels


def _keyed(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_keyed(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_keyed(v, f"{prefix}['{k}']"))
        return out
    return {prefix: tree.detach().numpy()}


# --- the loss ---------------------------------------------------------------------

LOSSES = {
    "ce": dict(loss_type="cross_entropy"),
    "weighted_ce": dict(loss_type="weighted_cross_entropy", class_weight=[0.5, 2.0, 1.25]),
    "focal": dict(loss_type="focal", gamma=2.0),
    "ce_dual": dict(loss_type="cross_entropy", use_dual_loss=True),
    "focal_dual_scale": dict(loss_type="focal", gamma=1.5, use_dual_loss=True, logit_scale=0.7),
    "ce_dual_fraction": dict(loss_type="cross_entropy", use_dual_loss=True, dual_fraction=0.3),
}


@pytest.mark.parametrize("use_context", [False, True])
@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_matches_jax(case, use_context):
    cfg = _cfg(use_context)
    params = init_window_encoder(jax.random.key(1), cfg.window_encoder)
    args = _batch(1)
    kw = LOSSES[case]
    jkw = dict(kw, logit_scale=None if kw.get("logit_scale") is None
               else jnp.float32(kw["logit_scale"]))
    ref, ref_logits = jax_loss_fn(params, *map(jnp.asarray, args), cfg, **jkw)
    loss, logits = seq2reg_loss_fn(port_params(params), *map(torch.from_numpy, args),
                                   port_config(cfg), **kw)
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-5)
    np.testing.assert_allclose(as_f32(logits), as_f32(ref_logits), rtol=1e-5, atol=1e-5)


# --- the train step ---------------------------------------------------------------


@pytest.mark.parametrize("kind,use_context,loss", [("adam", False, "ce"),
                                                   ("adamw", True, "focal_dual_scale")])
def test_train_steps_match_jax(kind, use_context, loss):
    """Three steps of both packages' seq2reg step on three batches: losses
    and every parameter leaf within 1e-4, except the self-attention key
    bias. Its gradient is 0 in exact arithmetic (it adds the same q.b_k to
    every score of a row, which the softmax drops), so both packages compute
    rounding noise there, which Adam scales to steps of up to the learning
    rate in either direction: that slice is held to 3 steps x lr."""
    cfg = _cfg(use_context)
    params = init_window_encoder(jax.random.key(2), cfg.window_encoder)
    kw = dict(learning_rate=3e-3, optimizer=kind, weight_decay=0.01 if kind == "adamw" else 0.0)
    loss_kw = dict(LOSSES[loss])
    tx = JO.make_optimizer(params, **kw)
    state = JaxTrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = jax_step(cfg, tx, **dict(loss_kw, logit_scale=None if "logit_scale" not in loss_kw
                                    else jnp.float32(loss_kw["logit_scale"])))
    ported = port_params(params)
    opt = make_optimizer(ported, **kw)
    pstate = TrainState(ported, opt, 0)
    pstep = make_seq2reg_train_step(port_config(cfg), opt, **loss_kw)
    for seed in range(3):
        args = _batch(10 + seed)
        state, jloss = step(state, *map(jnp.asarray, args))
        pstate, ploss = pstep(pstate, *map(torch.from_numpy, args))
        np.testing.assert_allclose(float(ploss), float(jloss), rtol=1e-4)
    assert pstate.step == 3
    want, got = _keyed(state.params), _port_keyed(pstate.params)
    qkv_b = "['layers']['mixer']['wqkv']['b']"
    wcfg = cfg.window_encoder
    heads = (wcfg.num_layers, wcfg.num_heads, 3, wcfg.embedding_dim // wcfg.num_heads)
    got_b, want_b = got.pop(qkv_b).reshape(heads), want.pop(qkv_b).reshape(heads)
    np.testing.assert_allclose(got_b[:, :, 1], want_b[:, :, 1], rtol=0, atol=3 * 3e-3)
    # ... and each package's move of that slice stays within the 3 steps x lr
    # that Adam can take, and both packages moved it or neither did
    init_b = _keyed(params)[qkv_b].reshape(heads)[:, :, 1]
    moves = got_b[:, :, 1] - init_b, want_b[:, :, 1] - init_b
    for move in moves:
        assert np.abs(move).max() <= 3 * 3e-3 * (1 + 1e-5)
    assert bool(np.any(moves[0])) == bool(np.any(moves[1]))
    got[qkv_b], want[qkv_b] = got_b[:, :, ::2], want_b[:, :, ::2]
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=key)


# --- the plateau scale and gradient accumulation ----------------------------------

LOSS_SEQUENCE = [1.0, 0.9, 0.9, 0.95, 0.91, 0.89, 0.8, 0.85, 0.84, 0.86, 0.9, 0.7, 0.71, 0.72,
                 0.73, 0.74, 0.5, 0.6, 0.61, 0.62] + [0.65] * 12


@pytest.mark.parametrize("accumulation_size,patience", [(1, 2), (1, 1), (3, 2), (2, 1)])
def test_plateau_scale_matches_optax(accumulation_size, patience):
    """The scale after every value of a loss sequence, against
    ``optax.contrib.reduce_on_plateau``'s state (its default rtol, atol and
    cooldown, as the JAX package's chain uses them), to 1e-7."""
    kw = dict(factor=0.5, patience=patience, accumulation_size=accumulation_size,
              min_scale=0.1)
    tx = optax.contrib.reduce_on_plateau(**kw)
    grads = {"w": jnp.ones((3,), jnp.float32)}
    state = tx.init(grads)
    ours = ReduceOnPlateau(**kw)
    got, want = [], []
    for v in LOSS_SEQUENCE:
        updates, state = tx.update(grads, state, value=jnp.float32(v))
        want.append(float(state.scale))
        got.append(ours.update(v))
        assert float(updates["w"][0]) == pytest.approx(got[-1], abs=1e-7)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert min(got) < 1.0
    restored = ReduceOnPlateau(**kw)
    restored.load_state_dict(ours.state_dict())
    assert restored.update(0.3) == ours.update(0.3)


@pytest.mark.parametrize("k", [2, 3])
def test_accumulation_matches_optax_multisteps(k):
    """``accumulate_steps=k`` (AdamW) against the JAX package's optax chain
    (``MultiSteps`` inside the trainable mask) over 2k micro-steps of random
    gradients and LR scales: the parameters stay put until each k-th call,
    then match within 1e-5."""
    cfg = _cfg(True)
    params = init_window_encoder(jax.random.key(3), cfg.window_encoder)
    kw = dict(learning_rate=1e-2, optimizer="adamw", weight_decay=0.05, accumulate_steps=k)
    tx = JO.make_optimizer(params, **kw)
    opt_state = tx.init(params)
    ported = port_params(params)
    opt = make_optimizer(ported, **kw)
    assert isinstance(opt, ScheduledOptimizer)
    rng = np.random.default_rng(3)
    jparams = params
    for i in range(2 * k):
        grads = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
        scale = 1.0 if i < k else 0.5
        updates, opt_state = tx.update(grads, opt_state, jparams, value=scale)
        jparams = optax.apply_updates(jparams, updates)
        before = [t.clone() for t in leaves(ported)]
        for t, g in zip(leaves(ported), leaves(port_params(grads))):
            t.grad = g
        apply_update(opt, scale)
        moved = any(not torch.equal(a, b) for a, b in zip(before, leaves(ported)))
        assert moved == ((i + 1) % k == 0), i
        want, got = _keyed(jparams), _port_keyed(ported)
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                       err_msg=f"micro-step {i}: {key}")


def test_step_plateau_mode_feeds_the_loss():
    """``plateau="step"`` feeds each step's own loss to the monitor when no
    value is given: a falling loss keeps the scale at 1, and the optimizer
    and the step must agree on the mode."""
    cfg = _cfg()
    params = port_params(init_window_encoder(jax.random.key(0), cfg.window_encoder))
    opt = make_optimizer(params, learning_rate=3e-3, plateau="step", plateau_patience=1)
    step = make_seq2reg_train_step(port_config(cfg), opt, plateau="step")
    state = TrainState(params, opt, 0)
    args = tuple(map(torch.from_numpy, _batch(4)))
    losses = []
    for _ in range(6):
        state, loss = step(state, *args)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert opt.monitor.scale > 0.9
    with pytest.raises(ValueError, match="plateau"):
        make_seq2reg_train_step(port_config(cfg), opt)
    with pytest.raises(ValueError, match="plateau"):
        make_seq2reg_train_step(port_config(cfg), make_optimizer(params), plateau="step")


# --- shards, batches, eval and fit --------------------------------------------------


def _label_frames(rng, ref):
    """Two subjects x two tissues of cCRE labels over the reference regions
    (one region left out of one frame)."""
    classes = ["PLS", "dELS", "pELS", "CTCF-only,CTCF-bound", "Low-DNase"]
    frames = {}
    for subject in ("S1", "S2"):
        for tissue in ("liver", "lung"):
            bed = ref[["chromosome", "start", "end"]].copy()
            bed["start"] += 50
            bed["end"] -= 50
            bed["tissue_cre"] = rng.choice(classes, len(bed))
            frames[(subject, tissue)] = bed.iloc[1:] if subject == "S2" else bed
    return frames


def _write_shards(genome, root, which, test_chr="chr8"):  # noqa: F811
    """The genome's CRE windows (padded by 50 bp) as reference regions, through
    one package's writer; reference sequence from its FASTA reader."""
    src = genome["root"]
    rows = [
        {"chromosome": r.chromosome, "start": r.start_cre - 50, "end": r.end_cre + 50,
         "cCRE": r.cre_name}
        for cre in genome["cre_maps"].values() for r in cre.itertuples()
    ]
    ref = pd.DataFrame(rows + [{**rows[0], "start": rows[0]["start"] + 900,
                                "end": rows[0]["end"] + 900}])
    path = resolve_vocab_path("bpe_vocabulary_500.json")
    if which == "port":
        fasta, tok = FastaReader(str(src / "genome.fa")), BPETokenizer.from_file(path)
        cls = Seq2RegShardWriter
    else:
        fasta, tok = JaxFasta(str(src / "genome.fa")), JaxTokenizer.from_file(path)
        cls = JaxSeq2RegWriter
    writer = cls(ref, tok, lambda s, c, a, b: fasta.fetch(c, a, b), root, chunk_size=4,
                 max_length=24, test_chr=test_chr)
    for (subject, tissue), bed in _label_frames(np.random.default_rng(0), ref).items():
        writer.add_labels(subject, tissue, bed)
    return writer.write(np.random.default_rng(1))


def test_shards_match_jax_writer(genome, tmp_path):  # noqa: F811
    ours = _write_shards(genome, tmp_path / "port", "port", test_chr="chr1")
    theirs = _write_shards(genome, tmp_path / "jax", "jax", test_chr="chr1")
    assert [p.split("/")[-2:] for p in ours] == [p.split("/")[-2:] for p in theirs]
    assert len(ours) >= 4 and all("/test/" in p for p in ours)
    assert (tmp_path / "port" / "manifest.json").read_text() == (
        tmp_path / "jax" / "manifest.json").read_text()
    for a, b in zip(ours, theirs):
        za, zb = np.load(a), np.load(b)
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            np.testing.assert_array_equal(za[key], zb[key], err_msg=f"{a}: {key}")
        assert za["tokens"].shape == (4, 24)
    # the train split, by the held-out chromosome
    train = _write_shards(genome, tmp_path / "train", "port")
    assert all("/train/" in p for p in train)
    assert json.loads((tmp_path / "train" / "manifest.json").read_text())["count"] == len(train)


def test_shard_batches_match_jax(genome, tmp_path):  # noqa: F811
    _write_shards(genome, tmp_path, "port", test_chr="chr9")
    vocab = {"liver": 1, "lung": 4}
    for label_key in ("tissue_class", "majority_class"):
        ours = seq2reg_shard_batches(tmp_path, vocab, label_key=label_key, device="cpu")
        theirs = jax_batches(tmp_path, vocab, label_key=label_key)
        for epoch in (0, 1):
            got, want = list(ours(epoch)), list(theirs(epoch))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                assert all(t.dtype == torch.int32 and t.device.type == "cpu" for t in g)
                for a, b in zip(g, w):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _write_legacy(path):
    rng = np.random.default_rng(0)
    np.savez(path, tokens=rng.integers(4, 16, (4, 8)).astype(np.int32),
             tok_len=np.full(4, 8, np.int32), ref_class=np.zeros(4, np.int32),
             tissue_class=np.zeros(4, np.int32))


def test_legacy_shard_tissue_recovery(tmp_path):
    """Shards without a 'tissue' key take it from their name when exactly
    one vocabulary tissue matches; otherwise both packages raise."""
    out = tmp_path / "train"
    out.mkdir(parents=True)
    _write_legacy(out / "HG_00096_adipose_subcutaneous_chr1_chunk_0.npz")
    vocab = {"adipose_subcutaneous": 3, "liver": 1}
    (_, _, _, tissue_ids, _), = list(seq2reg_shard_batches(tmp_path, vocab, device="cpu")(0))
    assert tissue_ids.tolist() == [3] * 4
    (_, _, _, jtissue, _), = list(jax_batches(tmp_path, vocab)(0))
    np.testing.assert_array_equal(tissue_ids.numpy(), jtissue)

    _write_legacy(out / "HG_upper_lung_chr1_chunk_0.npz")
    ambiguous = {"adipose_subcutaneous": 3, "lung": 2, "upper_lung": 5}
    for batches in (seq2reg_shard_batches(tmp_path, ambiguous, shuffle=False, device="cpu"),
                    jax_batches(tmp_path, ambiguous, shuffle=False)):
        with pytest.raises(ValueError, match="unambiguously"):
            list(batches(0))
    (out / "HG_upper_lung_chr1_chunk_0.npz").unlink()
    _write_legacy(out / "S1_unknowntissue_chr1_chunk_0.npz")
    for batches in (seq2reg_shard_batches(tmp_path, vocab, shuffle=False, device="cpu"),
                    jax_batches(tmp_path, vocab, shuffle=False)):
        with pytest.raises(ValueError, match="cannot recover"):
            list(batches(0))
    with pytest.raises(FileNotFoundError):
        seq2reg_shard_batches(tmp_path, vocab, split="test", device="cpu")


def _synthetic_shards(root, n_train=4, n_val=2, seed=0):
    """Shards in the writer's npz schema: class-0 windows get low token ids,
    class-1 high ones (learnable)."""
    rng = np.random.default_rng(seed)
    for split, count in (("train", n_train), ("test", n_val)):
        out = root / split
        out.mkdir(parents=True, exist_ok=True)
        for i in range(count):
            labels = rng.integers(0, 2, CHUNK).astype(np.int32)
            tokens = np.where(labels[:, None] == 0, rng.integers(4, 16, (CHUNK, LENGTH)),
                              rng.integers(16, 28, (CHUNK, LENGTH))).astype(np.int32)
            np.savez(out / f"S1_liver_chr1_chunk_{i}.npz", subject=np.array("S1"),
                     tissue=np.array("liver"), tokens=tokens,
                     tok_len=np.full(CHUNK, LENGTH, np.int32),
                     ref_class=rng.integers(0, 9, CHUNK).astype(np.int32),
                     tissue_class=labels, majority_class=labels,
                     start=np.arange(CHUNK, dtype=np.int64),
                     end=np.arange(CHUNK, dtype=np.int64) + 100)


@pytest.mark.parametrize("use_context", [False, True])
def test_eval_loss_and_metrics_match_jax(tmp_path, use_context):
    cfg = _cfg(use_context)
    _synthetic_shards(tmp_path)
    params = init_window_encoder(jax.random.key(4), cfg.window_encoder)
    vocab = {"liver": 1}
    val = seq2reg_shard_batches(tmp_path, vocab, split="test", shuffle=False, device="cpu")
    jval = jax_batches(tmp_path, vocab, split="test", shuffle=False)
    state = TrainState(port_params(params), None, 0)
    jstate = JaxTrainState(params, None, jnp.zeros((), jnp.int32))
    got = make_seq2reg_eval_loss(port_config(cfg), val)(state)
    want = jax_eval_loss(cfg, jval)(jstate)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    names = ["class0", "class1", "class,2"]
    m = make_seq2reg_eval_metrics(port_config(cfg), val, names, {1: "liver"})(state)
    assert m == jax_eval_metrics(cfg, jval, names, {1: "liver"})(jstate)
    assert "liver_val_acc" in m
    # The eval with a mesh's shard_fn (a world of one here) gives the same.
    from variantformer_tpu_torch.parallel import launch
    from variantformer_tpu_torch.parallel.mesh import data_shard_fn, make_mesh

    launch.initialize_distributed(device="cpu")
    try:
        shard = data_shard_fn(make_mesh())
        assert make_seq2reg_eval_metrics(port_config(cfg), val, names, {1: "liver"},
                                         shard_fn=shard)(state) == m
        np.testing.assert_allclose(make_seq2reg_eval_loss(port_config(cfg), val,
                                                          shard_fn=shard)(state), got, rtol=1e-6)
    finally:
        launch.shutdown_distributed()


def test_classification_metrics_reference_semantics():
    """Per-class F1 + acc, classes with no true samples skipped, per-tissue
    blocks prefixed with the tissue name, commas stripped."""
    labels = np.array([0, 0, 1, 1, 1, 2])
    preds = np.array([0, 1, 1, 1, 0, 2])
    f1 = per_class_f1(preds, labels, num_classes=4)
    assert set(f1) == {0, 1, 2} and abs(f1[0] - 0.5) < 1e-9 and f1[2] == 1.0
    m = classification_metrics(preds, labels, ["PLS", "pELS,dELS", "CTCF", "DNase"],
                               tissue_ids=np.array([0, 0, 0, 1, 1, 1]),
                               tissue_names={0: "liver", 1: "lung"})
    assert abs(m["val_acc"] - 4 / 6) < 1e-9
    assert "val_f1_class_pELSdELS" in m and "liver_val_acc" in m
    assert "liver_val_f1_class_CTCF" not in m and "lung_val_f1_class_CTCF" in m


@pytest.mark.mid
def test_fit_seq2reg_end_to_end(tmp_path):
    """``fit`` trains the window classifier from shards: the loss drops,
    ``last/`` and ``best/`` land, and a fresh state resumed from them
    continues the run (the history kept, the step count carried on)."""
    jcfg = _cfg()
    jcfg = dataclasses.replace(
        jcfg, window_encoder=dataclasses.replace(jcfg.window_encoder, num_classes=2))
    cfg = port_config(jcfg)
    _synthetic_shards(tmp_path / "shards")
    fresh = lambda: port_params(init_window_encoder(jax.random.key(0), jcfg.window_encoder))
    params = fresh()
    opt = make_optimizer(params, learning_rate=3e-3)
    step = make_seq2reg_train_step(cfg, opt)
    vocab = {"liver": 1}
    train_b = seq2reg_shard_batches(tmp_path / "shards", vocab, device="cpu")
    val_b = seq2reg_shard_batches(tmp_path / "shards", vocab, split="test", shuffle=False,
                                  device="cpu")
    eval_loss = make_seq2reg_eval_loss(cfg, val_b)
    res = fit(TrainState(params, opt, 0), step, train_b, eval_loss=eval_loss, epochs=3,
              ckpt_dir=tmp_path / "ckpt")
    assert len(res.history) == 3
    assert res.history[-1]["train_loss"] < res.history[0]["train_loss"]
    assert (tmp_path / "ckpt" / "last" / "state.pt").exists()
    assert (tmp_path / "ckpt" / "best" / "state.pt").exists()
    assert res.best_val == min(h["val_loss"] for h in res.history)
    trained = to_numpy(res.state.params)

    params2 = fresh()
    opt2 = make_optimizer(params2, learning_rate=3e-3)
    res2 = fit(TrainState(params2, opt2, 0), make_seq2reg_train_step(cfg, opt2), train_b,
               eval_loss=eval_loss, epochs=5, ckpt_dir=tmp_path / "ckpt", resume=True)
    assert [h["epoch"] for h in res2.history] == [0, 1, 2, 3, 4]
    assert res2.history[:3] == res.history
    assert res2.history[3]["train_loss"] < res.history[0]["train_loss"]
    assert res2.state.step == 5 * 4  # 4 train shards an epoch
    assert any(not np.array_equal(a, b) for a, b in zip(
        leaves(to_numpy(res2.state.params)), leaves(trained)))

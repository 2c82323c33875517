"""The port's multi-device training (``variantformer_tpu_torch/parallel``)
against one process and against the JAX package, on the CPU.

One world of 2 ranks and one of 4 are spawned once per module by
``tests/torch_mesh_worker.py`` over gloo: the layered route's steps, ``fit``
and seq2reg on both (data=2; data=2 x model=2), the donor partition over
every rank, ZeRO-1 and the launch helpers on the 2-rank world. The counterparts of
``tests/test_multichip_parity.py``'s ``test_sharded_train_step_matches_
single_device``, ``test_zero1_sharded_optimizer_matches_replicated``,
``test_fit_loop_with_donor_dp_fused_step`` and
``test_donor_dp_fused_train_step_matches_single_device``, and of
``tests/test_training.py``'s ``test_fit_on_mesh_matches_unmeshed`` and
``test_fit_seq2reg_on_mesh_matches_unmeshed``, at their tolerances against
the unmeshed port, and at the port's 1e-4 against the JAX package's
single-device ``impl="xla"`` step. The donor-partition step's gradients must
be the same bits in two runs (one flat bucket reduced in a fixed order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_mesh_worker as worker
from tests.test_model_smoke import tiny_batch, tiny_config
from tests.test_training import _write_seq2reg_shards
from tests.torch_port_helpers import port_batch, port_config
from variantformer_tpu.config import ModelConfig as JaxModelConfig
from variantformer_tpu.config import PrecisionPolicy
from variantformer_tpu.config import WindowEncoderConfig as JaxWindowEncoderConfig
from variantformer_tpu.models.init import init_seq2gene, init_window_encoder
from variantformer_tpu.train import optimizer as JO
from variantformer_tpu.train.loop import fit as jax_fit
from variantformer_tpu.train.loop import seq2gene_shard_batches as jax_shard_batches
from variantformer_tpu.train.loop import seq2reg_shard_batches as jax_seq2reg_batches
from variantformer_tpu.train.steps import TrainState as JaxTrainState
from variantformer_tpu.train.steps import make_seq2gene_train_step as jax_train_step
from variantformer_tpu.train.steps import make_seq2reg_train_step as jax_seq2reg_step
from variantformer_tpu_torch.config import ModelConfig, WindowEncoderConfig
from variantformer_tpu_torch.models.params import leaves, to_numpy, to_tensors
from variantformer_tpu_torch.train.loop import (
    fit,
    make_seq2gene_eval_loss,
    make_seq2reg_eval_loss,
    seq2gene_shard_batches,
    seq2reg_shard_batches,
)
from variantformer_tpu_torch.train.metrics import make_seq2reg_eval_metrics
from variantformer_tpu_torch.train.optimizer import make_optimizer
from variantformer_tpu_torch.train.steps import (
    TrainState,
    make_seq2gene_train_step,
    make_seq2reg_train_step,
    seq2gene_loss_fn,
)

WORLDS = {2: 1, 4: 2}  # ranks -> num_model of the layered route's mesh
OPT = dict(learning_rate=1e-3, weight_decay=0.01, optimizer="adamw",
           train_gene_tokenizer=True)
TISSUES = [0, 1, 2]
WCFG = dict(vocab_size=32, embedding_dim=32, num_heads=4, num_layers=1, ffn_hidden_dim=64,
            token_length=16, num_tissues=2, num_classes=2)


_REFS: dict = {}


def _once(key, fn):
    """The single-process references, computed once for both worlds."""
    if key not in _REFS:
        _REFS[key] = fn()
    return _REFS[key]


def _f32(cfg):
    return dataclasses.replace(cfg, precision=PrecisionPolicy(compute_dtype="float32"))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


@pytest.fixture(scope="module")
def model():
    cfg = _f32(tiny_config())
    return cfg, jax.tree.map(np.asarray, init_seq2gene(jax.random.key(0), cfg))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    batch = tiny_batch(rng, d=4)
    targets = rng.uniform(0, 3, (4, 3)).astype(np.float32)
    mask = np.ones((4, 3), bool)
    mask[1, 2] = mask[3, 0] = False
    return {k: None if v is None else np.asarray(v) for k, v in batch._asdict().items()}, \
        targets, mask


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Four seq2gene shards (two batches of two donors) and four seq2reg
    shards of 8 windows, as the JAX tests write them."""
    root = tmp_path_factory.mktemp("shards")
    (root / "s2g").mkdir()
    rng = np.random.default_rng(0)
    for i in range(4):
        c, g, length = 4, 3, 8
        np.savez(root / "s2g" / f"GENE{i}.1__D1.npz",
                 cre_tokens=rng.integers(4, 32, (c, length)).astype(np.int32),
                 cre_tok_len=np.full(c, length, np.int32),
                 cre_labels=rng.integers(0, 9, c).astype(np.int32),
                 gene_tokens=rng.integers(4, 32, (g, length)).astype(np.int32),
                 gene_tok_len=np.full(g, length, np.int32),
                 strand=np.int32(0),
                 tissue_ids=np.asarray([0, 2], np.int32),
                 targets=np.asarray([1.0 + i, 0.5], np.float32))
    _write_seq2reg_shards(root / "s2r", n_train=4, n_val=0)
    return root


@pytest.fixture(scope="module")
def seq2reg_params():
    wcfg = JaxWindowEncoderConfig(**WCFG)
    return jax.tree.map(np.asarray, init_window_encoder(jax.random.key(0), wcfg))


def _world(n, model, data, shards, seq2reg_params, tmp_path_factory):
    """The layered route's scenarios on both worlds (data=2, and data=2 x
    model=2); the donor partition's over the 2-rank world only."""
    cfg, params = model
    batch, targets, mask = data
    out = tmp_path_factory.mktemp(f"train{n}")
    pcfg, m = port_config(cfg), WORLDS[n]
    scenarios = [
        ("gspmd", "gspmd_steps", dict(cfg=pcfg, params=params, batch=batch, targets=targets,
                                      mask=mask, num_model=m)),
        ("fit", "fit_runs", dict(cfg=pcfg, params=params, shard_dir=str(shards / "s2g"),
                                 tissues=TISSUES, ckpt_dir=str(out / "ckpt"), num_model=m,
                                 kind="gspmd", batch_size=2)),
        ("seq2reg", "seq2reg_fit", dict(wcfg_fields=WCFG, params=seq2reg_params,
                                        shard_dir=str(shards / "s2r"), num_model=m)),
    ]
    if n == 2:
        scenarios += [
            ("dp", "donor_dp", dict(cfg=pcfg, params=params, batch=batch, targets=targets,
                                    mask=mask)),
            ("fit_dp", "fit_runs", dict(cfg=pcfg, params=params,
                                        shard_dir=str(shards / "s2g"), tissues=TISSUES,
                                        ckpt_dir=str(out / "ckpt_dp"), num_model=m,
                                        kind="donor", batch_size=n)),
            ("globalize", "globalize", dict(cfg=pcfg, params=params, batch=batch,
                                            targets=targets)),
        ]
    return n, out, worker.launch(n, scenarios, out / "run")


@pytest.fixture(scope="module", params=sorted(WORLDS), ids=lambda n: f"{n}ranks")
def world(request, model, data, shards, seq2reg_params, tmp_path_factory):
    return _once(f"world {request.param}", lambda: _world(
        request.param, model, data, shards, seq2reg_params, tmp_path_factory))


@pytest.fixture(scope="module")
def world2(model, data, shards, seq2reg_params, tmp_path_factory):
    return _once("world 2", lambda: _world(2, model, data, shards, seq2reg_params,
                                           tmp_path_factory))


def _port_steps(cfg, params, data, impl, opt_kw, n=2):
    batch, targets, mask = data
    p = to_tensors(params, "cpu")
    opt = make_optimizer(p, **opt_kw)
    state = TrainState(p, opt, 0)
    step = make_seq2gene_train_step(port_config(cfg), opt, impl=impl,
                                    train_gene_tokenizer=opt_kw.get("train_gene_tokenizer", True))
    args = (port_batch(_jax_batch(batch)), torch.from_numpy(targets), torch.from_numpy(mask))
    losses = []
    for _ in range(n):
        state, loss = step(state, *args, 1.0)
        losses.append(float(loss))
    return losses, to_numpy(state.params)


def _jax_batch(tree):
    from variantformer_tpu.models.seq2gene import Seq2GeneBatch

    return Seq2GeneBatch(**{k: None if v is None else jnp.asarray(v) for k, v in tree.items()})


def _jax_steps(cfg, params, data, opt_kw, n=2):
    batch, targets, mask = data
    tx = JO.make_optimizer(params, **opt_kw)
    state = JaxTrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    step = jax_train_step(cfg, tx, impl="xla",
                          train_gene_tokenizer=opt_kw.get("train_gene_tokenizer", True))
    losses = []
    for _ in range(n):
        state, loss = step(state, _jax_batch(batch), jnp.asarray(targets), jnp.asarray(mask),
                           1.0)
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, state.params)


def _assert_params(got, want, **tol):
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0], _sorted(got)):
        if tol:
            np.testing.assert_allclose(g, w, err_msg=jax.tree_util.keystr(path), **tol)
        else:
            assert _rel_l2(g, w) < 1e-4, jax.tree_util.keystr(path)


def _sorted(tree):
    """Leaves in the key order jax.tree flattens a dict (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _sorted(tree[k])]
    return [tree]


def test_sharded_train_step_matches_single_device(world, model, data):
    """``shard_train_state`` + the layered-route step: the heads and FFN
    columns split over the model axis, donors over data, gradients reduced
    over data; two AdamW steps give the single-device trajectory."""
    _, _, ranks = world
    cfg, params = model
    port_losses, port_params = _once("port xla", lambda: _port_steps(cfg, params, data, "xla",
                                                                      OPT))
    jax_losses, jax_params = _once("jax", lambda: _jax_steps(cfg, params, data, OPT))
    for res in ranks:
        got = res["gspmd"]
        np.testing.assert_allclose(got["losses"], port_losses, rtol=2e-5)
        _assert_params(got["params"], port_params, rtol=5e-5, atol=5e-5)
        np.testing.assert_allclose(got["losses"], jax_losses, rtol=1e-4)
        _assert_params(got["params"], jax_params)
    assert ranks[0]["gspmd"]["losses"][1] < ranks[0]["gspmd"]["losses"][0]


def test_donor_dp_gradients_match_single_device_and_repeat(world2, model, data):
    """The donor partition's reduced gradient (each rank's gradient of its
    masked-loss sum, one all-reduce, divided by the count) against the
    single-device mean-loss gradient; two runs give the same bits."""
    _, _, ranks = world2
    cfg, params = model
    batch, targets, mask = data
    p = to_tensors(params, "cpu")
    make_optimizer(p, **OPT)  # the same frozen leaves as the ranks' optimizers
    loss = seq2gene_loss_fn(p, port_batch(_jax_batch(batch)), torch.from_numpy(targets),
                            torch.from_numpy(mask), port_config(cfg))
    loss.backward()
    # A trainable leaf the loss does not reach gets zeros (as under jax.grad).
    want = [None if not t.requires_grad else
            np.zeros(t.shape, np.float32) if t.grad is None else t.grad.numpy()
            for t in leaves(p)]
    for res in ranks:
        got = res["dp"]
        assert got["grads_repeat"] is True
        np.testing.assert_allclose(got["vg_loss"], float(loss.detach()), rtol=1e-3)
        assert sum(g is not None for g in got["grads"]) > 0
        for g, w in zip(got["grads"], want, strict=True):
            assert (g is None) == (w is None)
            if w is not None:
                assert _rel_l2(g, w) < 5e-3
    # every rank holds the same gradient bits
    for res in ranks[1:]:
        for a, b in zip(res["dp"]["grads"], ranks[0]["dp"]["grads"]):
            assert (a is None and b is None) or np.array_equal(a, b)


def test_donor_dp_train_step_matches_single_device(world2, model, data):
    _, _, ranks = world2
    cfg, params = model
    port_losses, _ = _once("port dp", lambda: _port_steps(cfg, params, data, "fused2", OPT))
    jax_losses, jax_params = _once("jax", lambda: _jax_steps(cfg, params, data, OPT))
    for res in ranks:
        np.testing.assert_allclose(res["dp"]["dp_losses"], port_losses, rtol=1e-3)
        np.testing.assert_allclose(res["dp"]["dp_losses"], jax_losses, rtol=1e-4)
        _assert_params(res["dp"]["dp_params"], jax_params)


def test_zero1_sharded_optimizer_matches_replicated(world2):
    """ZeRO-1: the same trajectory as the replicated optimizer, each rank
    holding only its slice of every moment that has an axis the rank count
    divides, and ``state_dict`` giving the whole moments back."""
    n, _, ranks = world2
    for res in ranks:
        dp = res["dp"]
        np.testing.assert_allclose(dp["zero1_losses"], dp["dp_losses"], rtol=1e-6)
        for a, b in zip(_sorted(dp["zero1_params"]), _sorted(dp["dp_params"])):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6)
        sliced = 0
        for axis, part, full in zip(dp["zero1_specs"], dp["zero1_moment_shapes"],
                                    dp["zero1_full_shapes"], strict=True):
            want = list(full)
            if axis is not None:
                want[axis] //= n
                sliced += 1
            assert list(part) == want
        assert sliced > 0, "no moment received a ZeRO-1 slice"


@pytest.mark.parametrize("acc", [1, 2])
def test_zero1_state_dict_keeps_the_trajectory(world2, acc):
    """ZeRO-1 with its whole ``state_dict`` taken after every step (what
    ``fit`` saves each epoch) leaves the rank's slices in place; with
    ``accumulate_steps=2`` a state loaded back in the middle of a cycle
    keeps every accumulator, the unsliced leaves' too. Both against the
    replicated optimizer run the same way."""
    _, _, ranks = world2
    for res in ranks:
        if acc > 1:
            assert res["dp"]["zero1_unsliced"] > 0, "no leaf stays whole under ZeRO-1"
        runs = res["dp"][f"ckpt_acc{acc}"]
        np.testing.assert_allclose(runs["zero1"]["losses"], runs["dp"]["losses"], rtol=1e-6)
        assert runs["zero1"]["losses"][-1] != runs["zero1"]["losses"][0]
        for a, b in zip(_sorted(runs["zero1"]["params"]), _sorted(runs["dp"]["params"])):
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6)


def _port_fit(cfg, params, shard_dir, impl, opt_kw, batch_size=2):
    p = to_tensors(params, "cpu")
    opt = make_optimizer(p, **opt_kw)
    batches = seq2gene_shard_batches(shard_dir, TISSUES, batch_size=batch_size, shuffle=False,
                                     device="cpu")
    step = make_seq2gene_train_step(port_config(cfg), opt, impl=impl)
    return fit(TrainState(p, opt, 0), step, batches, epochs=2,
               eval_loss=make_seq2gene_eval_loss(port_config(cfg), batches, impl=impl))


def test_fit_on_mesh_matches_unmeshed(world, model, shards):
    """``fit(mesh=...)`` with the eval loss on the same placement: the
    single-device loss trajectory; rank 0 wrote the checkpoint and history,
    and a resume on every rank continues from them."""
    _, out, ranks = world
    cfg, params = model
    base = _once("port fit", lambda: _port_fit(cfg, params, shards / "s2g", "xla",
                                               dict(learning_rate=1e-3)))

    def jax_run():
        tx = JO.make_optimizer(params, learning_rate=1e-3)
        jax_state = JaxTrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
        return jax_fit(jax_state, jax_train_step(cfg, tx),
                       jax_shard_batches(shards / "s2g", TISSUES, batch_size=2, shuffle=False),
                       epochs=2)

    ref = _once("jax fit", jax_run)
    for res in ranks:
        hist = res["fit"]["history"]
        for a, b, j in zip(base.history, hist, ref.history, strict=True):
            assert b["train_loss"] == pytest.approx(a["train_loss"], rel=2e-5)
            assert b["val_loss"] == pytest.approx(a["val_loss"], rel=2e-5)
            assert b["train_loss"] == pytest.approx(j["train_loss"], rel=1e-4)
        resumed = res["fit"]["resumed"]
        assert len(resumed) == 3 and resumed[:2] == hist
    assert (out / "ckpt" / "last" / "state.pt").exists()
    assert (out / "ckpt" / "history.json").exists()


def test_fit_loop_with_donor_dp_fused_step(world2, model, shards):
    n, _, ranks = world2
    cfg, params = model
    base = _port_fit(cfg, params, shards / "s2g", "fused", dict(learning_rate=1e-3),
                     batch_size=n)
    for res in ranks:
        hist = res["fit_dp"]["history"]
        for a, b in zip(base.history, hist, strict=True):
            np.testing.assert_allclose(b["train_loss"], a["train_loss"], rtol=1e-3)
            np.testing.assert_allclose(b["val_loss"], a["val_loss"], rtol=1e-3)
        assert hist[-1]["train_loss"] < hist[0]["train_loss"]


def test_fit_seq2reg_on_mesh_matches_unmeshed(world, shards, seq2reg_params):
    _, _, ranks = world
    def port_run():
        cfg = ModelConfig(window_encoder=WindowEncoderConfig(**WCFG))
        p = to_tensors(seq2reg_params, "cpu")
        opt = make_optimizer(p, learning_rate=1e-3)
        batches = seq2reg_shard_batches(shards / "s2r", {"liver": 1}, shuffle=False,
                                        device="cpu")
        base = fit(TrainState(p, opt, 0), make_seq2reg_train_step(cfg, opt), batches, epochs=2,
                   eval_loss=make_seq2reg_eval_loss(cfg, batches))
        return base, make_seq2reg_eval_metrics(cfg, batches, ["a", "b"])(base.state)

    def jax_run():
        jcfg = JaxModelConfig(window_encoder=JaxWindowEncoderConfig(**WCFG))
        tx = JO.make_optimizer(seq2reg_params, learning_rate=1e-3)
        return jax_fit(JaxTrainState(seq2reg_params, tx.init(seq2reg_params),
                                     jnp.zeros((), jnp.int32)),
                       jax_seq2reg_step(jcfg, tx),
                       jax_seq2reg_batches(shards / "s2r", {"liver": 1}, shuffle=False),
                       epochs=2)

    base, metrics = _once("port seq2reg", port_run)
    ref = _once("jax seq2reg", jax_run)
    for res in ranks:
        for a, b, j in zip(base.history, res["seq2reg"]["history"], ref.history, strict=True):
            assert b["train_loss"] == pytest.approx(a["train_loss"], rel=2e-5)
            assert b["val_loss"] == pytest.approx(a["val_loss"], rel=2e-5)
            assert b["train_loss"] == pytest.approx(j["train_loss"], rel=1e-4)
        assert res["seq2reg"]["metrics"] == metrics


def test_globalize_train_state_and_step_args(world2, model, data):
    """The launch helpers for per-process runs: every rank ends with the
    first rank's parameters; the step args stay this process's own."""
    _, _, ranks = world2
    _, params = model
    batch, targets, _ = data
    first = np.asarray(leaves(params)[0], np.float32)
    for res in ranks:
        np.testing.assert_array_equal(res["globalize"]["first"], first)
        np.testing.assert_array_equal(res["globalize"]["args"][0], targets)
        assert res["globalize"]["args"][1] == 0.5
        np.testing.assert_array_equal(res["globalize"]["tokens"], batch["cre_tokens"])

"""The port's differentiable window encoder against the JAX package's
gradients, on the CPU.

``encode_windows_dual`` with parameters that require grad takes the
whole-stack autograd Function (checkpointing forward, recompute backward;
its plain version on CPU tensors). Its gradients (the token embeddings and
every layer leaf of both tokenizers) are held against ``jax.grad`` of JAX
``encode_windows(impl="xla")`` at float32 (rel L2 < 1e-4 per leaf: the same
algorithm, summed in another order), and against ``jax.grad`` through the
Pallas ``fused_window_encoder_dual_diff`` (interpret mode) in bf16 (rel L2
< 5e-2, the bound of ``tests/test_fused_encoder.py``; the Pallas backward
uses the tanh GELU derivative). Pad windows and pad token rows get exactly
0, and a frozen stack is never differentiated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import port_config, port_params
from variantformer_tpu.config import WindowEncoderConfig
from variantformer_tpu.models.core import AttnSpec as JaxSpec
from variantformer_tpu.models.init import init_window_encoder
from variantformer_tpu.models.seq2reg import encode_windows as jax_encode
from variantformer_tpu.models.seq2reg import encode_windows_dual as jax_encode_dual
from variantformer_tpu_torch.models.core import AttnSpec
from variantformer_tpu_torch.models.params import leaves
from variantformer_tpu_torch.models.seq2reg import encode_windows_dual
from variantformer_tpu_torch.ops import fused_encoder as FE
from variantformer_tpu_torch.ops.alibi import alibi_slopes

E, H, LAYERS, FFN, L = 32, 2, 2, 64, 12
TRAINED = ("token_embedding", "layers")


def _cfg():
    return WindowEncoderConfig(
        vocab_size=40, embedding_dim=E, num_heads=H, num_layers=LAYERS,
        ffn_hidden_dim=FFN, use_context=False, token_length=L,
    )


def _inputs(seed, n, lens):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, 40, (n, L)).astype(np.int32)
    tok_len = rng.integers(1, L + 1, n).astype(np.int32)
    tok_len[: len(lens)] = lens
    cot = rng.standard_normal((n, E)).astype(np.float32)
    return tokens, tok_len, cot


def _keyed(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_keyed(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _port_keyed(sub, f"{prefix}['{name}']").items()}
    return {prefix: None if tree.grad is None else tree.grad.float().numpy()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _port_grads(pa, pb, a, b, dtype):
    """Port gradients of sum(out_a * cot_a) + sum(out_b * cot_b) w.r.t. the
    trained leaves of both tokenizers."""
    cfg = port_config(_cfg())
    ta, tb = port_params(pa), port_params(pb)
    for t in leaves(_trained(ta)) + leaves(_trained(tb)):
        t.requires_grad_(True)
    out_a, out_b = encode_windows_dual(
        ta, torch.from_numpy(a[0]), torch.from_numpy(a[1]),
        tb, torch.from_numpy(b[0]), torch.from_numpy(b[1]),
        cfg, AttnSpec(H, E // H), dtype,
    )
    loss = (out_a.float() * torch.from_numpy(a[2])).sum() + (
        out_b.float() * torch.from_numpy(b[2])).sum()
    loss.backward()
    return _port_keyed(_trained(ta)), _port_keyed(_trained(tb))


def _case():
    pa = init_window_encoder(jax.random.key(0), _cfg())
    pb = init_window_encoder(jax.random.key(1), _cfg())
    a = _inputs(2, 5, [L, 1, 0])        # a pad window and a one-token window
    b = _inputs(3, 7, [3, 0, 0, L])     # two pad windows
    return pa, pb, a, b


def _trained(p):
    return {k: p[k] for k in TRAINED}


def test_grads_match_jax_xla_f32():
    pa, pb, a, b = _case()

    def loss(ta, tb):
        out = []
        for p, t, (tok, tl, cot) in ((pa, ta, a), (pb, tb, b)):
            y = jax_encode({**p, **t}, jnp.asarray(tok), jnp.asarray(tl),
                           jnp.zeros(len(tok), jnp.int32), _cfg(),
                           JaxSpec(H, E // H, impl="xla"), jnp.float32)
            out.append(jnp.sum(y * cot))
        return out[0] + out[1]

    ga, gb = jax.grad(loss, argnums=(0, 1))(_trained(pa), _trained(pb))
    got_a, got_b = _port_grads(pa, pb, a, b, torch.float32)
    for got, want in ((got_a, _keyed(ga)), (got_b, _keyed(gb))):
        assert set(got) == set(want)
        for key, w in want.items():
            rel = _rel(got[key], w)
            assert rel < 1e-4, f"{key}: rel L2 {rel}"


@pytest.mark.mid
def test_grads_match_jax_pallas_dual_diff_bf16():
    pa, pb, a, b = _case()

    def loss(ta, tb):
        ya, yb = jax_encode_dual(
            {**pa, **ta}, jnp.asarray(a[0]), jnp.asarray(a[1]),
            {**pb, **tb}, jnp.asarray(b[0]), jnp.asarray(b[1]),
            _cfg(), JaxSpec(H, E // H, impl="fused"), jnp.bfloat16,
        )
        return jnp.sum(ya.astype(jnp.float32) * a[2]) + jnp.sum(yb.astype(jnp.float32) * b[2])

    ga, gb = jax.grad(loss, argnums=(0, 1))(_trained(pa), _trained(pb))
    got_a, got_b = _port_grads(pa, pb, a, b, torch.bfloat16)
    for got, want in ((got_a, _keyed(ga)), (got_b, _keyed(gb))):
        for key, w in want.items():
            rel = _rel(got[key], w)
            assert rel < 5e-2, f"{key}: rel L2 {rel}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pad_windows_and_rows_get_exact_zeros(dtype):
    lens = [L, 5, 0, 1, 0, 7]
    n = len(lens)
    rng = np.random.default_rng(4)
    layers = port_params(init_window_encoder(jax.random.key(5), _cfg()))["layers"]
    x = torch.from_numpy(rng.standard_normal((n, L, E)).astype(np.float32)).to(dtype)
    x.requires_grad_(True)
    tok_len = torch.tensor(lens, dtype=torch.int32)
    out = FE.fused_window_encoder_diff(x, tok_len, layers, torch.from_numpy(alibi_slopes(H)),
                                       (E // H) ** -0.5, H)
    (dx,) = torch.autograd.grad(out, (x,), torch.randn(out.shape).to(dtype))
    for i, m in enumerate(lens):
        assert dx[i, m:].numel() == 0 or dx[i, m:].abs().max() == 0, f"window {i}"
        assert m == 0 or dx[i, :m].abs().max() > 0, f"window {i}"


def test_frozen_stack_runs_no_backward(monkeypatch):
    """A stack whose parameters need no gradient takes the inference chain:
    it gets no gradient and its backward never runs."""
    pa, pb, a, b = _case()
    calls = []
    real = FE.fused_window_encoder_bwd_plain
    monkeypatch.setattr(FE, "fused_window_encoder_bwd_plain",
                        lambda dpool, xsave, *args: calls.append(dpool.shape[0]) or real(
                            dpool, xsave, *args))
    ta, tb = port_params(pa), port_params(pb)
    for t in leaves(tb["layers"]) + [tb["token_embedding"]]:
        t.requires_grad_(True)
    out_a, out_b = encode_windows_dual(
        ta, torch.from_numpy(a[0]), torch.from_numpy(a[1]),
        tb, torch.from_numpy(b[0]), torch.from_numpy(b[1]),
        port_config(_cfg()), AttnSpec(H, E // H), torch.float32,
    )
    assert not out_a.requires_grad
    (out_a.sum() + out_b.sum()).backward()
    assert calls == [len(b[0])]
    assert all(t.grad is None for t in leaves(ta))
    assert all(t.grad is not None for t in leaves(tb["layers"]))

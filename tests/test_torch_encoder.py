"""The port's window encoder against the JAX package's, on the CPU.

``encode_windows`` (layered) and ``encode_windows_dual`` (through the
whole-stack wrapper, which takes its plain version on CPU tensors) are held
against JAX ``encode_windows(impl="xla")`` in float32 at 1e-4 (the same
algorithm, summed in another order), and against the Pallas kernel
(``impl="fused"``, interpret mode on the CPU) in bf16 at 3e-2, which covers
bf16 rounding and the kernel's tanh GELU against the port's exact erf GELU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import as_f32, port_config, port_params
from variantformer_tpu.config import WindowEncoderConfig
from variantformer_tpu.models.core import AttnSpec as JaxSpec
from variantformer_tpu.models.init import init_window_encoder
from variantformer_tpu.models.seq2reg import encode_windows as jax_encode
from variantformer_tpu.models.seq2reg import encode_windows_dual as jax_encode_dual
from variantformer_tpu_torch.models.core import AttnSpec
from variantformer_tpu_torch.models.seq2reg import encode_windows, encode_windows_dual
from variantformer_tpu_torch.ops.alibi import alibi_slopes
from variantformer_tpu_torch.ops.fused_encoder import (
    fused_window_encoder,
    fused_window_encoder_plain,
    pack_encoder_layers,
)

E, H, LAYERS, FFN, L = 64, 4, 3, 128, 24


def _cfg(pe="alibi"):
    return WindowEncoderConfig(
        vocab_size=60, embedding_dim=E, num_heads=H, num_layers=LAYERS,
        ffn_hidden_dim=FFN, use_context=False, token_length=L, positional_encoding=pe,
    )


def _inputs(seed, n, lens=None):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(4, 60, (n, L)).astype(np.int32)
    tok_len = rng.integers(1, L + 1, n).astype(np.int32)
    if lens is not None:
        tok_len[: len(lens)] = lens
    return tokens, tok_len


def _jax(cfg, params, tokens, tok_len, dtype, impl):
    return jax_encode(
        params, jnp.asarray(tokens), jnp.asarray(tok_len),
        jnp.zeros(len(tokens), jnp.int32), cfg, JaxSpec(H, E // H, impl=impl), dtype,
    )


def _port(cfg, params, tokens, tok_len, dtype):
    return encode_windows(
        port_params(params), torch.from_numpy(tokens), torch.from_numpy(tok_len),
        torch.zeros(len(tokens), dtype=torch.int32), port_config(cfg), AttnSpec(H, E // H),
        dtype,
    )


# Cases: window counts that fill no block evenly, tok_len = 1, and pad
# windows (tok_len = 0), which must stay finite and pool to exactly 0.
CASES = {
    "ragged_n": (5, None),
    "tok_len_1": (10, [1, 1, L]),
    "pad_windows": (7, [0, 3, 0]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("pe", ["alibi", "sinusoidal"])
def test_layered_matches_jax_xla_f32(case, pe):
    n, lens = CASES[case]
    cfg = _cfg(pe)
    params = init_window_encoder(jax.random.key(0), cfg)
    tokens, tok_len = _inputs(1, n, lens)
    ref = _jax(cfg, params, tokens, tok_len, jnp.float32, "xla")
    out = _port(cfg, params, tokens, tok_len, torch.float32)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(as_f32(out), as_f32(ref), rtol=1e-4, atol=1e-4)
    for i in np.flatnonzero(tok_len == 0):
        assert (out[i] == 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_dual_matches_jax_xla_f32(case):
    n, lens = CASES[case]
    cfg = _cfg()
    pa = init_window_encoder(jax.random.key(0), cfg)
    pb = init_window_encoder(jax.random.key(1), cfg)
    ta, la = _inputs(2, n, lens)
    tb, lb = _inputs(3, n + 3)
    ref_a = _jax(cfg, pa, ta, la, jnp.float32, "xla")
    ref_b = _jax(cfg, pb, tb, lb, jnp.float32, "xla")
    out_a, out_b = encode_windows_dual(
        port_params(pa), torch.from_numpy(ta), torch.from_numpy(la),
        port_params(pb), torch.from_numpy(tb), torch.from_numpy(lb),
        port_config(cfg), AttnSpec(H, E // H), torch.float32,
    )
    np.testing.assert_allclose(as_f32(out_a), as_f32(ref_a), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(as_f32(out_b), as_f32(ref_b), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dual_matches_jax_pallas_bf16(case):
    n, lens = CASES[case]
    cfg = _cfg()
    pa = init_window_encoder(jax.random.key(4), cfg)
    pb = init_window_encoder(jax.random.key(5), cfg)
    ta, la = _inputs(6, n, lens)
    tb, lb = _inputs(7, n + 2)
    ref_a, ref_b = jax_encode_dual(
        pa, jnp.asarray(ta), jnp.asarray(la), pb, jnp.asarray(tb), jnp.asarray(lb),
        cfg, JaxSpec(H, E // H, impl="fused"), jnp.bfloat16,
    )
    out_a, out_b = encode_windows_dual(
        port_params(pa), torch.from_numpy(ta), torch.from_numpy(la),
        port_params(pb), torch.from_numpy(tb), torch.from_numpy(lb),
        port_config(cfg), AttnSpec(H, E // H), torch.bfloat16,
    )
    assert out_a.dtype == torch.bfloat16
    assert torch.isfinite(out_a).all() and torch.isfinite(out_b).all()
    np.testing.assert_allclose(as_f32(out_a), as_f32(ref_a), rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(as_f32(out_b), as_f32(ref_b), rtol=3e-2, atol=3e-2)


def test_packed_stack_matches_layered():
    """The whole-stack wrapper on packed weights (q | k | v regrouped from the
    head-major layout) computes what the layered encoder computes."""
    cfg = _cfg()
    params = port_params(init_window_encoder(jax.random.key(8), cfg))
    tokens, tok_len = _inputs(9, 6, [0, 1])
    tokens_t, len_t = torch.from_numpy(tokens), torch.from_numpy(tok_len)
    ref = encode_windows(params, tokens_t, len_t, torch.zeros_like(len_t), port_config(cfg),
                         AttnSpec(H, E // H), torch.float32)
    packed = pack_encoder_layers(params["layers"], H, torch.float32)
    x = params["token_embedding"][tokens_t.long()]
    slopes = torch.from_numpy(alibi_slopes(H))
    out = fused_window_encoder(x, len_t, packed, slopes, (E // H) ** -0.5, H)
    plain = fused_window_encoder_plain(x, len_t, packed, slopes, (E // H) ** -0.5, H)
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)

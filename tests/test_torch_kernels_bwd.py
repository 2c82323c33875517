"""The backward kernels' plain versions against torch autograd of their
forwards' plain versions, at float32 on the CPU (rtol 1e-5).

On the card each ``*_bwd`` wrapper launches a hand-written CUDA kernel that
``chip_smoke.py`` holds against these plain versions; here the wrappers take
the plain versions because the tensors lie on the CPU. Covered: ALiBi, rows
with no valid key (kv_len 0), K/V shared by kv_div query rows (their
cotangents summed), and the exact zeros that pad rows and masked keys get.
"""

import numpy as np
import pytest
import torch

from variantformer_tpu_torch.ops import kernels
from variantformer_tpu_torch.ops.alibi import alibi_slopes

RTOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _close(got, want, name=""):
    """rtol 1e-5, elementwise and of the tensor's scale (an element near 0
    keeps the f32 rounding of its row's larger terms)."""
    torch.testing.assert_close(got, want, rtol=RTOL, atol=RTOL * float(want.abs().max()),
                               msg=name)


def _zero(t, name=""):
    assert t.numel() == 0 or t.abs().max() == 0, name


@pytest.mark.parametrize("residual", [False, True])
def test_gemm_dgrad_and_wgrad_match_autograd(residual):
    rng = np.random.default_rng(0)
    a, w = _rand(rng, 37, 16).requires_grad_(True), _rand(rng, 16, 24).requires_grad_(True)
    bias = _rand(rng, 24).requires_grad_(True)
    dy, res = _rand(rng, 37, 24), _rand(rng, 37, 16)
    da, dw, db = torch.autograd.grad(kernels.gemm_plain(a, w, bias), (a, w, bias), dy)
    _close(kernels.gemm_dgrad(dy, w.detach(), res if residual else None),
           da + res if residual else da, "dgrad")
    acc = _rand(rng, 16, 24)
    _close(kernels.gemm_wgrad(a.detach(), dy), dw, "wgrad")
    _close(kernels.gemm_wgrad(a.detach(), dy, out=acc.clone()), acc + dw, "wgrad into buffer")
    _close(kernels.colsum(dy), db, "colsum")


CASES = {
    # name: (B, Sq, Sk, heads, head_dim, kv_len, alibi, kv_div, len_div)
    "self alibi, kv_len 0 and partial": (4, 7, 7, 2, 8, [7, 0, 3, 1], True, 1, 1),
    "gene self, len shared by tissues": (6, 5, 5, 2, 4, [5, 2], True, 1, 3),
    "cross, K/V shared by 3 tissues": (6, 5, 9, 2, 4, [9, 4], False, 3, 3),
    "cross, one key": (4, 5, 1, 2, 4, [1, 1], False, 2, 2),
    "cross, no valid key": (4, 5, 6, 2, 4, [0, 6], False, 2, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_attention_bwd_matches_autograd(case):
    b, sq, sk, heads, hd, lens, alibi, kv_div, len_div = CASES[case]
    rng = np.random.default_rng(1)
    e = heads * hd
    q = _rand(rng, b, sq, e, scale=2.0).requires_grad_(True)
    k = _rand(rng, b // kv_div, sk, e, scale=2.0).requires_grad_(True)
    v = _rand(rng, b // kv_div, sk, e).requires_grad_(True)
    kv_len = torch.tensor(lens, dtype=torch.int32)
    slopes = torch.from_numpy(alibi_slopes(heads)) if alibi else None
    scale = hd ** -0.5
    args = (kv_len, slopes, scale, heads, kv_div, len_div)
    _, lse, o = kernels.attention_plain(q, k, v, *args, for_backward=True)
    do = _rand(rng, b, sq, e)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = kernels.attention_bwd(q.detach(), k.detach(), v.detach(), o.detach(), lse, do, *args)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g, w, name)
    # keys at or past a K/V row's length get exactly 0 (rows with no valid
    # key average V, so only their dK is 0); rows with no valid key get dQ 0
    per_row = [[lens[(r * kv_div + j) // len_div] for j in range(kv_div)]
               for r in range(b // kv_div)]
    for r, group in enumerate(per_row):
        if min(group) > 0:
            _zero(got[1][r, max(group):], f"dk row {r}")
            _zero(got[2][r, max(group):], f"dv row {r}")
        if max(group) == 0:
            _zero(got[1][r], f"dk row {r}")
    for i in range(b):
        if lens[i // len_div] == 0:
            _zero(got[0][i], f"dq row {i}")


def test_attention_bwd_writes_into_strided_buffers():
    """dq/dk/dv land in column slices of one fused buffer, as the chains use."""
    rng = np.random.default_rng(2)
    b, s, heads, hd = 3, 6, 2, 4
    e = heads * hd
    qkv = _rand(rng, b, s, 3 * e)
    q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
    kv_len = torch.tensor([6, 2, 0], dtype=torch.int32)
    slopes = torch.from_numpy(alibi_slopes(heads))
    _, lse, o = kernels.attention(q, k, v, kv_len, slopes, 0.5, heads, for_backward=True)
    do = _rand(rng, b, s, e)
    fused = torch.zeros_like(qkv)
    kernels.attention_bwd(q, k, v, o, lse, do, kv_len, slopes, 0.5, heads,
                          dq=fused[..., :e], dk=fused[..., e:2 * e], dv=fused[..., 2 * e:])
    want = kernels.attention_bwd_plain(q, k, v, o, lse, do, kv_len, slopes, 0.5, heads)
    _close(fused, torch.cat(want, dim=-1))


@pytest.mark.parametrize("n_res", [0, 1, 2])
def test_layernorm_bwd_matches_autograd(n_res):
    rng = np.random.default_rng(3)
    x = _rand(rng, 11, 16, scale=3.0).requires_grad_(True)
    scale = (torch.rand(16, generator=torch.Generator().manual_seed(0)) + 0.5).requires_grad_(True)
    bias = _rand(rng, 16, scale=0.1).requires_grad_(True)
    dy = _rand(rng, 11, 16)
    res = tuple(_rand(rng, 11, 16) for _ in range(n_res))
    dx, dscale, dbias = torch.autograd.grad(kernels.layernorm_plain(x, scale, bias),
                                            (x, scale, bias), dy)
    got = kernels.layernorm_bwd(x.detach(), dy, scale.detach(), res)
    _close(got[0], dx + sum(res) if res else dx, "dx")
    _close(got[1], dscale, "dscale")
    _close(got[2], dbias, "dbias")


def test_geglu_bwd_matches_autograd():
    rng = np.random.default_rng(4)
    f = _rand(rng, 9, 32, scale=2.0).requires_grad_(True)
    dm = _rand(rng, 9, 16)
    (want,) = torch.autograd.grad(kernels.geglu_plain(f), (f,), dm)
    _close(kernels.geglu_bwd(f.detach(), dm), want)


def test_masked_mean_pool_bwd_matches_autograd_with_exact_zeros():
    rng = np.random.default_rng(5)
    lens = [5, 0, 1, 3]
    tok_len = torch.tensor(lens, dtype=torch.int32)
    x = _rand(rng, 4, 5, 8).requires_grad_(True)
    dpool = _rand(rng, 4, 8)
    (want,) = torch.autograd.grad(kernels.masked_mean_pool_plain(x, tok_len), (x,), dpool)
    got = kernels.masked_mean_pool_bwd(dpool, tok_len, 5)
    _close(got, want)
    for i, n in enumerate(lens):
        _zero(got[i, n:], f"window {i}")

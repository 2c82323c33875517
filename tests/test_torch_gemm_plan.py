"""The launch plan of the TMA + wgmma GEMM (``ops/kernels.py`` ``gemm_plan``)
at every main-path shape, on the CPU.

The kernel (``csrc/gemm_sm90.cu``) runs only on the card, where
``chip_smoke.py`` holds it against its plain version; the plan it is given
is pure Python and is held here, for the forward products, the input
cotangents (``gemm_dgrad``) and the weight gradients of both chains: the
tiles cover M and N, every contraction split is non-empty, the contraction
is split only for a weight gradient whose output has fewer tiles than the
card has SMs, and the persistent
blocks' walk over (tile, split) units, as the kernel's ``unit_of`` decodes
it, visits every output tile and k-tile exactly once. The weight gradient's
split partials, emulated over the plan's row ranges and summed in split
order into a non-zero buffer as the kernel's sum pass adds them, give the
same bits from run to run and match the plain version at f32. The fused
FFN-in's walk (``gemm_geglu``, layout 3) maps each 128-column output tile to
its value and gate columns, and its tiles, emulated, give the plain bits.
"""

import numpy as np
import pytest
import torch

from variantformer_tpu_torch.config import ModelConfig
from variantformer_tpu_torch.ops import kernels
from variantformer_tpu_torch.ops.kernels import (
    GEMM_BLOCK_K,
    GEMM_BLOCK_M,
    GEMM_BLOCK_N,
    H100_SMS,
    gemm_plan,
)

_CFG = ModelConfig()
_E_ENC = _CFG.window_encoder.embedding_dim               # 512
_F_ENC = _CFG.window_encoder.ffn_hidden_dim              # 2048
_E_MOD, _F_MOD = _CFG.seq2gene.emb_dim, _CFG.seq2gene.ffn_hidden_dim  # 1536, 2048

# Rows of the main paths: vcf2exp's 4 genes x 54 tissues x 201 gene rows and
# 4 x 384 CRE windows of 200 tokens; training's 2 genes (21 708 gene rows,
# 400 gene windows = 80 000 token rows); a ragged encoder batch.
ROWS_MOD = {"serve": 4 * 54 * 201, "train": 2 * 54 * 201}
ROWS_ENC = {"cre windows": 4 * 384 * 200, "gene windows": 400 * 200, "ragged": 333 * 200 + 7}
PROJ_MOD = {"qkv": (_E_MOD, 3 * _E_MOD), "out": (_E_MOD, _E_MOD), "cross q": (_E_MOD, _E_MOD),
            "ffn_in": (_E_MOD, _F_MOD), "ffn_out": (_F_MOD // 2, _E_MOD)}
PROJ_ENC = {"qkv": (_E_ENC, 3 * _E_ENC), "out": (_E_ENC, _E_ENC),
            "ffn_in": (_E_ENC, _F_ENC), "ffn_out": (_F_ENC // 2, _E_ENC)}

FORWARD = {f"gene {p} {r}": (rows, k, n)
           for r, rows in ROWS_MOD.items() for p, (k, n) in PROJ_MOD.items()}
FORWARD.update({f"encoder {p} {r}": (rows, k, n)
                for r, rows in ROWS_ENC.items() for p, (k, n) in PROJ_ENC.items()})
# gemm_dgrad: dX [R, K] = dY [R, N] W[K, N]^T is the plan's (M=R, N=K, K=N),
# for every projection of the encoder's and the gene stack's backward.
DGRAD = {f"gene {p} {r}": (rows, k, n)
         for r, rows in ROWS_MOD.items() for p, (k, n) in PROJ_MOD.items()}
DGRAD.update({f"encoder {p} {r}": (rows, k, n)
              for r, rows in ROWS_ENC.items() if r != "cre windows"
              for p, (k, n) in PROJ_ENC.items()})
# gemm_wgrad: out [K, N] += X [R, K]^T dY [R, N] is the plan's (M=K, N, K=R).
WGRAD = {f"gene {p} {r}": (k, n, rows)
         for r, rows in ROWS_MOD.items() for p, (k, n) in PROJ_MOD.items()}
WGRAD.update({f"encoder {p}": (k, n, ROWS_ENC["gene windows"]) for p, (k, n) in PROJ_ENC.items()})


def _cdiv(a, b):
    return -(-a // b)


def _check_plan(plan, m, n, k, split):
    ktiles = _cdiv(k, GEMM_BLOCK_K)
    assert (plan.tiles_m - 1) * GEMM_BLOCK_M < m <= plan.tiles_m * GEMM_BLOCK_M
    assert (plan.tiles_n - 1) * GEMM_BLOCK_N < n <= plan.tiles_n * GEMM_BLOCK_N
    # every split non-empty, all k-tiles covered
    assert (plan.splits - 1) * plan.per_split < ktiles <= plan.splits * plan.per_split
    tiles = plan.tiles_m * plan.tiles_n
    if not split or tiles >= H100_SMS:
        assert plan.splits == 1
    assert plan.splits <= 8
    assert plan.blocks == min(tiles * plan.splits, H100_SMS)
    assert 1 <= plan.group_m <= min(8, plan.tiles_m)


@pytest.mark.parametrize("case", list(FORWARD))
def test_forward_plan_covers_the_output(case):
    m, k, n = FORWARD[case]
    _check_plan(gemm_plan(m, n, k), m, n, k, split=False)


@pytest.mark.parametrize("case", list(DGRAD))
def test_dgrad_plan_covers_the_output_unsplit(case):
    m, k, n = DGRAD[case]
    plan = gemm_plan(m, k, n)
    _check_plan(plan, m, k, n, split=False)
    assert plan.splits == 1 and plan.per_split == _cdiv(n, GEMM_BLOCK_K)


@pytest.mark.parametrize("case", list(WGRAD))
def test_wgrad_plan_covers_the_output_and_the_rows(case):
    m, n, k = WGRAD[case]
    _check_plan(gemm_plan(m, n, k, split=True), m, n, k, split=True)


def test_encoder_wgrad_splits_the_rows():
    """[512, 1536] has 24 tiles of 128 x 256 for 132 SMs: the 80 000 rows
    are split, each split at least 16 k-tiles long."""
    plan = gemm_plan(_E_ENC, 3 * _E_ENC, 80_000, split=True)
    assert (plan.tiles_m, plan.tiles_n) == (4, 6)
    assert plan.splits > 1 and plan.per_split >= 16
    assert plan.tiles_m * plan.tiles_n * plan.splits <= 2 * H100_SMS


@pytest.mark.parametrize("k", [_E_ENC, _F_ENC // 2])
def test_encoder_n512_wgrad_takes_eight_splits(k):
    """The out-projection and FFN-out weight gradients ([512 or 1024, 512],
    8 or 16 tiles of 128 x 256) over the 80 000 gene-window rows: 8 splits,
    the count the card ran fastest against 4 and 16."""
    plan = gemm_plan(k, _E_ENC, 80_000, split=True)
    assert (plan.tiles_m, plan.tiles_n) == (k // GEMM_BLOCK_M, 2)
    assert plan.splits == 8


def test_gene_qkv_wgrad_is_not_split():
    plan = gemm_plan(_E_MOD, 3 * _E_MOD, ROWS_MOD["serve"], split=True)
    assert plan.tiles_m * plan.tiles_n >= H100_SMS and plan.splits == 1


def _walk(plan, m, n, k):
    """The kernel's walk: block b takes units b, b + blocks, ...; unit u is
    tile u // splits in grouped order (gemm_sm90.cu unit_of), k-tiles
    [split * per_split, min(ktiles, (split + 1) * per_split))."""
    ktiles = _cdiv(k, GEMM_BLOCK_K)
    units = plan.tiles_m * plan.tiles_n * plan.splits
    seen = {}
    for b in range(plan.blocks):
        for u in range(b, units, plan.blocks):
            tile, split = divmod(u, plan.splits)
            group = plan.group_m * plan.tiles_n
            first = tile // group * plan.group_m
            rows = min(plan.tiles_m - first, plan.group_m)
            m0 = (first + tile % group % rows) * GEMM_BLOCK_M
            n0 = tile % group // rows * GEMM_BLOCK_N
            for kt in range(split * plan.per_split, min(ktiles, (split + 1) * plan.per_split)):
                seen[(m0, n0, kt)] = seen.get((m0, n0, kt), 0) + 1
    return seen, ktiles


@pytest.mark.parametrize("m, n, k, split", [
    (333 * 7 + 5, 1536, 512, False),     # ragged M, grouped order with a short last group
    (1000, 264, 72, False),               # ragged N and K
    (333 * 200 + 7, 512, 1024, False),    # dgrad of the encoder's FFN-in, ragged M
    (200, 264, 72, False),                # dgrad unit check: ragged M, N and K
    (136, 776, 64, False),                # dgrad unit check: ragged M and N, one k-tile
    (512, 1536, 80_000, True),            # the encoder's split weight gradient
    (1536, 1536, 21_708, True),           # split, 7 splits over 72 tiles
    (64, 128, 640, True),                 # one tile
])
def test_walk_visits_every_tile_and_ktile_once(m, n, k, split):
    plan = gemm_plan(m, n, k, split=split)
    seen, ktiles = _walk(plan, m, n, k)
    want = {(i * GEMM_BLOCK_M, j * GEMM_BLOCK_N, kt) for i in range(plan.tiles_m)
            for j in range(plan.tiles_n) for kt in range(ktiles)}
    assert set(seen) == want
    assert set(seen.values()) == {1}


# gemm_geglu (layout 3) at [M, K] x [K, F]: the encoder's FFN-in over the
# CRE windows, the gene stack's, the CRE chain's and a ragged encoder batch.
GEGLU = {"encoder cre windows": (ROWS_ENC["cre windows"], _E_ENC, _F_ENC),
         "gene serve": (ROWS_MOD["serve"], _E_MOD, _F_MOD),
         "cre chain": (4 * 384, _E_MOD, _F_MOD),
         "encoder ragged": (ROWS_ENC["ragged"], _E_ENC, _F_ENC)}


def _geglu_col(n0, c, f):
    """The B (and bias) column behind accumulator column c of the tile at n0
    in layout 3 (gemm_sm90.cu b_col): the value half at n0 / 2 + c, the
    gate half at F / 2 + n0 / 2 + c - 128."""
    half = GEMM_BLOCK_N // 2
    return n0 // 2 + c + (0 if c < half else f // 2 - half)


@pytest.mark.parametrize("case", list(GEGLU))
def test_geglu_walk_maps_each_output_tile_to_its_value_and_gate_columns(case):
    """The fused walk visits every output tile of [M, F/2] (128 columns) and
    every k-tile once; output columns [128 n', 128 n' + 128) read value
    columns of the same range and gate columns F/2 + that range, loaded as
    four 64-column boxes, and every column of W is read by one tile."""
    m, k, f = GEGLU[case]
    plan = gemm_plan(m, f, k)
    assert f // 2 % kernels.GEGLU_BLOCK_N == 0 and plan.tiles_n == f // GEMM_BLOCK_N
    seen, ktiles = _walk(plan, m, f, k)
    assert set(seen.values()) == {1}
    out_tiles = {(m0, n0 // 2) for m0, n0, _ in seen}
    assert out_tiles == {(i * GEMM_BLOCK_M, j * kernels.GEGLU_BLOCK_N)
                         for i in range(plan.tiles_m) for j in range(f // 2 // 128)}
    assert len(seen) == len(out_tiles) * ktiles
    read = []
    for o0 in sorted({o0 for _, o0 in out_tiles}):
        cols = [_geglu_col(2 * o0, c, f) for c in range(GEMM_BLOCK_N)]
        assert cols[:128] == list(range(o0, o0 + 128))
        assert cols[128:] == list(range(f // 2 + o0, f // 2 + o0 + 128))
        assert [cols[64 * j] for j in range(4)] == [o0, o0 + 64, f // 2 + o0, f // 2 + o0 + 64]
        read += cols
    assert sorted(read) == list(range(f))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geglu_tiles_emulated_give_the_plain_bits(dtype):
    """Each output tile computed as the kernel does, from the pre-activation
    columns its walk maps it to, gives ``gemm_geglu_plain``'s bits (ragged
    M, two output tile columns)."""
    m, k, f = 200, 72, 512
    rng = np.random.default_rng(5)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(dtype)
    a, w, bias = t(m, k), t(k, f), t(f)
    pre = kernels.gemm_plain(a, w, bias)
    plan = gemm_plan(m, f, k)
    out = torch.full((m, f // 2), float("nan"), dtype=dtype)
    for m0, n0, _ in _walk(plan, m, f, k)[0]:
        cols = [_geglu_col(n0, c, f) for c in range(GEMM_BLOCK_N)]
        rows = slice(m0, min(m, m0 + GEMM_BLOCK_M))
        out[rows, n0 // 2:n0 // 2 + 128] = kernels.geglu_plain(pre[rows][:, cols])
    assert torch.equal(out, kernels.gemm_geglu_plain(a, w, bias))


def _split_order_sum(x, dy, out, plan):
    """out + (p_0 + p_1 + ... + p_{splits-1}): split s's f32 partial X^T dY
    over its rows [s * per_split * 64, (s + 1) * per_split * 64), as each
    split's units write it, then the partials added in split order and
    into ``out``, as the sum pass does."""
    step = plan.per_split * GEMM_BLOCK_K
    parts = [x[s * step:(s + 1) * step].float().t() @ dy[s * step:(s + 1) * step].float()
             for s in range(plan.splits)]
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return out + total


@pytest.mark.parametrize("label, rows, k, n", [
    ("encoder out-proj, N=512", ROWS_ENC["gene windows"], _E_ENC, _E_ENC),
    ("gene out-proj", ROWS_MOD["train"], _E_MOD, _E_MOD),
])
def test_wgrad_split_partials_sum_in_split_order(label, rows, k, n):
    plan = gemm_plan(k, n, rows, split=True)
    assert plan.splits > 1
    rng = np.random.default_rng(4)
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s, dtype=np.float32)).to(torch.bfloat16)
    x, dy = bf(rows, k), bf(rows, n)
    out = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32))
    first = _split_order_sum(x, dy, out.clone(), plan)
    assert torch.equal(first, _split_order_sum(x, dy, out.clone(), plan)), label
    want = kernels.gemm_wgrad_plain(x, dy, out=out.clone())
    torch.testing.assert_close(first, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))

"""The launch plan of the TMA + wgmma GEMM (``ops/kernels.py`` ``gemm_plan``)
at every main-path shape, on the CPU.

The kernel (``csrc/gemm_sm90.cu``) runs only on the card, where
``chip_smoke.py`` holds it against its plain version; the plan it is given
is pure Python and is held here: the tiles cover M and N, every contraction
split is non-empty, the contraction is split only for a weight gradient
whose output has fewer tiles than the card has SMs, and the persistent
blocks' walk over (tile, split) units, as the kernel's ``unit_of`` decodes
it, visits every output tile and k-tile exactly once.
"""

import pytest

from variantformer_tpu_torch.config import ModelConfig
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

"""The launch plan of the TMA + wgmma attention (``ops/kernels.py``
``attention_plan``) and the wrapper's checks on what TMA can take, on the CPU.

The kernel (``csrc/attention_sm90.cu``) runs only on the card, where
``chip_smoke.py`` holds it against its plain version; the plan it is given
and the strides and bases it is handed are held here: the blocks' walk over
(query row, query tile) items, as the kernel decodes it, visits every (row,
head, query tile) exactly once; the rows of a block share one K/V row; the
grid fits the card's limits and fills it at the main-path shapes; K, V and
the Q buffers fit shared memory up to ``ATTN_MAX_KEYS``; and a view whose
stride or base a tensor map cannot take is refused, never passed on.
"""

import numpy as np
import pytest
import torch

from variantformer_tpu_torch.config import ModelConfig
from variantformer_tpu_torch.ops import kernels
from variantformer_tpu_torch.ops.kernels import (
    ATTN_BLOCK_K,
    ATTN_BLOCK_Q,
    ATTN_MAX_KEYS,
    H100_SMS,
    attention_plan,
)

_CFG = ModelConfig()
_WE, _MC = _CFG.window_encoder, _CFG.seq2gene
_T, _G1, _C, _L = 54, 201, 384, 200  # tissues, gene rows, CRE slots, window tokens

# (B, H, Sq, Sk, kv_div) of the three uses on the main paths: vcf2exp (4 genes,
# 4 x 384 CRE windows), training (2 genes, 400 gene windows) and the training
# parity check (1 gene).
MAIN = {
    "encoder self, CRE windows": (4 * 384, _WE.num_heads, _L, _L, 1),
    "encoder self, gene windows": (400, _WE.num_heads, _L, _L, 1),
    "gene self D=4": (4 * _T, _MC.num_heads, _G1, _G1, 1),
    "gene self D=2": (2 * _T, _MC.num_heads, _G1, _G1, 1),
    "gene self D=1": (_T, _MC.num_heads, _G1, _G1, 1),
    "gene cross D=4": (4 * _T, _MC.num_heads, _G1, _C, _T),
    "gene cross D=2": (2 * _T, _MC.num_heads, _G1, _C, _T),
    "gene cross D=1": (_T, _MC.num_heads, _G1, _C, _T),
}
RAGGED = {
    "one query row": (3, 8, 1, 200, 1),
    "one key": (4 * _T, 32, _G1, 1, _T),
    "short gene": (2 * _T, 32, 37, 37, 1),
    "one tile and a row": (5, 4, 65, 65, 1),
    "kv_div 27": (54, 32, _G1, _C, 27),
    "640 keys, four consumers": (6, 8, 130, 640, 3),
    "the most keys": (2, 8, 64, ATTN_MAX_KEYS, 2),
    "one block": (1, 1, 64, 64, 1),
}


def _cdiv(a, b):
    return -(-a // b)


def _walk(plan, b, heads, kv_div):
    """The kernel's decode: block (s, h, r) takes items [s * per_split,
    min(items, (s + 1) * per_split)); consumer c of the block takes its
    items c, c + consumers, ...; item i is row r * kv_div + i // q_tiles,
    query tile i % q_tiles. Returns {(row, head, tile): visits} and the
    blocks' rows."""
    items = kv_div * plan.q_tiles
    seen, block_rows = {}, []
    for r in range(b // kv_div):
        for h in range(heads):
            for s in range(plan.splits):
                first, last = s * plan.per_split, min(items, (s + 1) * plan.per_split)
                rows = set()
                for c in range(plan.consumers):
                    for i in range(first + c, last, plan.consumers):
                        row = r * kv_div + i // plan.q_tiles
                        key = (row, h, i % plan.q_tiles)
                        seen[key] = seen.get(key, 0) + 1
                        rows.add(row)
                block_rows.append((r, rows))
    return seen, block_rows


@pytest.mark.parametrize("case", list(MAIN) + list(RAGGED))
def test_walk_visits_every_row_head_and_query_tile_once(case):
    b, heads, sq, sk, kv_div = {**MAIN, **RAGGED}[case]
    plan = attention_plan(b, heads, sq, sk, kv_div)
    assert plan.q_tiles == _cdiv(sq, ATTN_BLOCK_Q) and plan.kv_tiles == _cdiv(sk, ATTN_BLOCK_K)
    seen, block_rows = _walk(plan, b, heads, kv_div)
    want = {(row, h, t) for row in range(b) for h in range(heads) for t in range(plan.q_tiles)}
    assert set(seen) == want
    assert set(seen.values()) == {1}
    # every block has work, and its rows all read its K/V row
    for r, rows in block_rows:
        assert rows and {row // kv_div for row in rows} == {r}
    assert plan.blocks == plan.groups * plan.splits == len(block_rows)


@pytest.mark.parametrize("case", list(MAIN) + list(RAGGED))
def test_grid_and_shared_memory_fit_the_card(case):
    b, heads, sq, sk, kv_div = {**MAIN, **RAGGED}[case]
    plan = attention_plan(b, heads, sq, sk, kv_div)
    assert max(plan.splits, heads, b // kv_div) <= 65535
    assert plan.consumers in (2, 4)
    # K and V tiles, two 8 KB Q buffers per consumer warpgroup, barriers,
    # alignment: within the 227 KB a block may take (attention_sm90.cu)
    smem = 1024 + (2 * plan.kv_tiles + 2 * plan.consumers) * 8192 + 8 * (12 + 2 * plan.consumers)
    assert smem <= 232_448


@pytest.mark.parametrize("case", list(MAIN))
def test_main_path_grid_fills_the_card(case):
    """At least one block per SM; the self-attentions keep one block per
    (row, head), so each K/V head is read once; the cross-attention splits
    each gene's 54 x 4 items over a few blocks, not one per tissue."""
    b, heads, sq, sk, kv_div = MAIN[case]
    plan = attention_plan(b, heads, sq, sk, kv_div)
    assert plan.blocks >= H100_SMS
    if kv_div == 1:
        assert plan.splits == 1
    else:
        assert 1 < plan.splits <= _cdiv(4 * H100_SMS, plan.groups)
        assert plan.consumers == 4 and plan.per_split >= plan.consumers


@pytest.mark.parametrize("sk", list(range(1, ATTN_MAX_KEYS + 1, 37)) + [256, 257, 640, 641])
def test_consumers_follow_the_key_count(sk):
    """Two warpgroups (two blocks an SM) while K and V fit 64 KB, four up to
    640 keys, then two again up to ATTN_MAX_KEYS."""
    plan = attention_plan(8, 8, 200, sk)
    assert plan.consumers == (4 if 256 < sk <= 640 else 2)


def _qkv(b=2, s=16, heads=4, hd=48, extra=0):
    e = heads * hd
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b, s, 3 * e + extra)).astype(np.float32))
    return x.to(torch.bfloat16), e


def _args(q, k, v, b, heads=4):
    return (q, k, v, torch.full((b,), 16, dtype=torch.int32), None, heads, 1, 1)


def test_check_accepts_the_fused_projection_slices():
    qkv, e = _qkv()
    q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:]
    assert kernels._check_attention(*_args(q, k, v, 2)) == (2, 16, e, 16, 48)


def test_check_refuses_a_row_stride_tma_cannot_take():
    qkv, e = _qkv(extra=4)  # row stride 3E + 4 elements: not a multiple of 16 bytes
    q, k, v = qkv[..., :e], qkv[..., e:2 * e], qkv[..., 2 * e:3 * e]
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        kernels._check_attention(*_args(q, k, v, 2))


def test_check_refuses_a_base_tma_cannot_take():
    qkv, e = _qkv(extra=8)
    # starts one element (2 bytes) past a 16-byte boundary
    q, k, v = qkv[..., 1:e + 1], qkv[..., e:2 * e], qkv[..., 2 * e:3 * e]
    assert q.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="16-byte boundary"):
        kernels._check_attention(*_args(q, k, v, 2))


def test_check_refuses_a_batch_stride_tma_cannot_take():
    x, e = _qkv(b=1, s=33)
    flat = x.reshape(-1)[: 2 * 16 * 3 * e + 4]
    # two batch rows 16 * 3E + 2 elements apart
    q = flat.as_strided((2, 16, e), (16 * 3 * e + 2, 3 * e, 1))
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        kernels._check_attention(*_args(q, q, q, 2))


def test_check_refuses_a_strided_last_dim():
    qkv, e = _qkv()
    q = qkv[..., :e].transpose(1, 2).contiguous().transpose(1, 2)  # last stride 16
    k, v = qkv[..., e:2 * e], qkv[..., 2 * e:]
    with pytest.raises(ValueError, match="unit last stride"):
        kernels._check_attention(*_args(q, k, v, 2))

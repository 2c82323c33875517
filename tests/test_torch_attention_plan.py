"""The launch plan of the TMA + wgmma attention (``ops/kernels.py``
``attention_plan``) and the wrapper's checks on what TMA can take, on the CPU.

The kernel (``csrc/attention_sm90.cu``) runs only on the card, where
``chip_smoke.py`` holds it against its plain version; the plan it is given
and the strides and bases it is handed are held here: the blocks' walk over
(query row, query tile) items, as the kernel decodes it, visits every (row,
head, query tile) exactly once; the rows of a block share one K/V row; the
grid fits the card's limits and fills it at the main-path shapes; K, V and
the Q buffers of a key chunk fit shared memory; past ``ATTN_MAX_KEYS`` keys
the chunk launches, as the kernel decodes them, walk every key tile of a row
once, in order, and an emulation of that walk (the online softmax's state
carried from chunk to chunk) equals the plain version at f32; and a view
whose stride or base a tensor map cannot take is refused, never passed on.
"""

import numpy as np
import pytest
import torch

from variantformer_tpu_torch.ops.alibi import alibi_slopes
from variantformer_tpu_torch.ops.attention import MASK_VALUE
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
    "769 keys, two chunks": (108, 32, _G1, 769, 54),
    "1024 keys": (108, 32, _G1, 1024, 54),
    "2048 keys, self": (2, 4, 2048, 2048, 1),
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
    assert plan.q_tiles == _cdiv(sq, ATTN_BLOCK_Q)
    assert plan.kv_tiles == _cdiv(plan.chunk_keys, ATTN_BLOCK_K)
    assert (plan.chunks - 1) * plan.chunk_keys < sk <= plan.chunks * plan.chunk_keys
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


@pytest.mark.parametrize("sk", list(range(1, 3 * ATTN_MAX_KEYS + 1, 37))
                         + [256, 257, 640, 641, 768, 769, 1280, 1281, 2048])
def test_consumers_follow_the_key_count(sk):
    """Two warpgroups (two blocks an SM) while a chunk's K and V fit 64 KB,
    four up to 640 keys, then two again up to ATTN_MAX_KEYS; past that the
    keys go in chunks of at most ATTN_MAX_KEYS, as few as can be, even to a
    tile."""
    plan = attention_plan(8, 8, 200, sk)
    assert plan.chunks == _cdiv(sk, ATTN_MAX_KEYS)
    assert plan.chunk_keys == (sk if plan.chunks == 1 else
                               ATTN_BLOCK_K * _cdiv(_cdiv(sk, ATTN_BLOCK_K), plan.chunks))
    assert plan.chunk_keys <= ATTN_MAX_KEYS
    assert plan.consumers == (4 if 256 < plan.chunk_keys <= 640 else 2)


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


# ---------------------------------------------------------------------------
# Past ATTN_MAX_KEYS: the key chunks
# ---------------------------------------------------------------------------


def _chunk_walk(plan, sk, nk):
    """The chunk launches' walk for a row attending to ``nk`` keys, as the
    kernel decodes it: launch c (keys from k0 = c * chunk_keys) walks its
    tiles up to the row's last key, skips the row where its keys end before
    the chunk, resumes the state the previous launch left where k0 > 0, and
    writes the output in the chunk that holds the row's last key, the
    state in those before. Returns [(chunk, absolute key tiles, resumes,
    writes: "out" or "state")]."""
    steps = []
    for c in range(plan.chunks):
        k0 = c * plan.chunk_keys
        nt = _cdiv(min(nk - k0, plan.chunk_keys), ATTN_BLOCK_K) if nk > k0 else 0
        if nt <= 0:
            continue
        last = nk <= k0 + plan.chunk_keys
        steps.append((c, [k0 // ATTN_BLOCK_K + j for j in range(nt)], k0 > 0,
                      "out" if last else "state"))
    return steps


@pytest.mark.parametrize("sk", [769, 1024, 2048])
@pytest.mark.parametrize("kv_div", [1, _T])
def test_plans_past_the_cap_walk_every_key_tile_once(sk, kv_div):
    """Sk = 769, 1024 and 2048 are accepted; for every key count a row can
    have (kv_len 0 walks all Sk keys), the launches visit each of its key
    tiles once, in order, each resumed launch follows one that left the
    state, and exactly the last writes the output; a chunk's K, V and Q
    buffers fit shared memory."""
    b = 2 * kv_div
    plan = attention_plan(b, _MC.num_heads, _G1, sk, kv_div)
    assert plan.chunks > 1 and plan.kv_tiles <= ATTN_MAX_KEYS // ATTN_BLOCK_K
    smem = 1024 + (2 * plan.kv_tiles + 2 * plan.consumers) * 8192 + 8 * (12 + 2 * plan.consumers)
    assert smem <= 232_448
    for nk in range(1, sk + 1):
        steps = _chunk_walk(plan, sk, nk)
        tiles = [t for _, ts, _, _ in steps for t in ts]
        assert tiles == list(range(_cdiv(nk, ATTN_BLOCK_K))), nk
        assert [w for *_, w in steps] == ["state"] * (len(steps) - 1) + ["out"]
        assert [c for c, *_ in steps] == list(range(len(steps)))  # no chunk skipped mid-walk
        assert [r for _, _, r, _ in steps] == [False] + [True] * (len(steps) - 1)


def _emulate_chunks(q, k, v, kv_len, slopes, scale, heads, kv_div, len_div, plan):
    """out [B, Sq, H*D] and lse [B, H, Sq] by the chunk launches' walk at f32:
    per row and head, the online softmax over each chunk's keys (ALiBi and
    the masks at the absolute key index; a row with kv_len 0 scores every
    key MASK_VALUE), its state (O, running max, sum) carried from chunk to
    chunk and merged in chunk order, the output written by the chunk that
    holds the row's last key."""
    b, sq, e = q.shape
    hd, sk = e // heads, k.shape[1]
    lens = kv_len.repeat_interleave(len_div)
    out = torch.full_like(q, float("nan"))
    lse = torch.full((b, heads, sq), float("nan"))
    pos = torch.arange(sq, dtype=torch.float32)[:, None]
    for row in range(b):
        n = int(lens[row])
        nk = min(n, sk) if n > 0 else sk
        for h in range(heads):
            cols = slice(h * hd, (h + 1) * hd)
            qh, kh, vh = q[row, :, cols], k[row // kv_div, :, cols], v[row // kv_div, :, cols]
            m = torch.full((sq, 1), -float("inf"))
            l, o = torch.zeros(sq, 1), torch.zeros(sq, hd)
            for c, tiles, resumes, writes in _chunk_walk(plan, sk, nk):
                assert resumes == (c > 0)
                keys = torch.arange(tiles[0] * ATTN_BLOCK_K,
                                    min(sk, (tiles[-1] + 1) * ATTN_BLOCK_K))
                s = qh @ kh[keys].T * scale
                if slopes is not None:
                    s = s - slopes[h] * (pos - keys[None, :].float()).abs()
                s = torch.where(keys[None, :] < nk, s, -float("inf"))
                if n == 0:
                    s = torch.where(keys[None, :] < nk, MASK_VALUE, s)
                m_new = torch.maximum(m, s.max(-1, keepdim=True).values)
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                o = o * alpha + p @ vh[keys]
                m = m_new
                if writes == "out":
                    out[row, :, cols] = o / l
                    lse[row, h] = (m + torch.log(l))[:, 0]
    return out, lse


CHUNKED = {
    # name: (B, Sq, Sk, heads, head_dim, kv_len, ALiBi, kv_div, len_div, max_keys)
    "self, 4 chunks, kv_len 0, 1, at a boundary, mid-chunk, Sk":
        (5, 20, 200, 2, 8, [0, 1, 64, 100, 200], True, 1, 1, 64),
    "self, 3 chunks of 128, kv_len 128 and 300": (2, 9, 300, 2, 8, [128, 300], True, 1, 1, 128),
    "cross, kv_div 54, 3 chunks, at a boundary and 0":
        (108, 7, 130, 2, 8, [128, 0], False, 54, 54, 64),
    "cross, kv_div 54, 1024 keys in 2 chunks of 512":
        (108, 5, 1024, 1, 8, [1024, 700], False, 54, 54, ATTN_MAX_KEYS),
    "self, 2048 keys in 3 chunks of 704, ALiBi": (2, 6, 2048, 1, 8, [2048, 704], True, 1, 1,
                                                  ATTN_MAX_KEYS),
}


@pytest.mark.parametrize("case", list(CHUNKED))
def test_chunk_merge_equals_the_plain_version(case):
    b, sq, sk, heads, hd, lens, alibi, kv_div, len_div, max_keys = CHUNKED[case]
    rng = np.random.default_rng(11)
    rand = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    e = heads * hd
    q, k, v = rand(b, sq, e), rand(b // kv_div, sk, e), rand(b // kv_div, sk, e)
    kv_len = torch.tensor(lens, dtype=torch.int32)
    slopes = torch.from_numpy(alibi_slopes(heads)) if alibi else None
    args = (q, k, v, kv_len, slopes, hd ** -0.5, heads, kv_div, len_div)
    plan = attention_plan(b, heads, sq, sk, kv_div, max_keys=max_keys)
    assert plan.chunks > 1
    out, lse = _emulate_chunks(*args, plan)
    want, want_lse, _ = kernels.attention_plain(*args, for_backward=True)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)

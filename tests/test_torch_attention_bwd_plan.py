"""The launch plans of the attention backward (``ops/kernels.py``
``attention_bwd_plan``), of the one-pass LayerNorm backward
(``layernorm_bwd_plan``) and of the LayerNorm forward (``layernorm_plan``),
on the CPU.

The kernels (``csrc/attention_bwd_sm90.cu``, ``csrc/rowwise.cu``) run only on
the card, where ``chip_smoke.py`` holds them against their plain versions.
Held here: the blocks' walks, as the kernels decode their plans, visit every
(K/V row, head, key tile) and every (query row, query tile) item exactly
once across splits; the grids fit the card and the cross-attention's fills
it; shared memory stays within 227 KB, a dQ key chunk's too, at head dims
up to 64 and at 128 (two 64-column boxes a tile; one dK/dV consumer
warpgroup, ``ATTN_BWD_DQ_CONSUMERS_WIDE`` dQ ones); and a plain
emulation of each walk, with per-split (per-block) f32 partials summed in the
kernels' order and the dQ pass's f32 accumulator carried from key chunk to
key chunk, equals the plain version at f32 (rtol 1e-5), with exact zeros
past kv_len. The LayerNorm backward's plain version is also held against the
JAX package's ``_ln_bwd``; the LayerNorm forward's grid covers every row
once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from variantformer_tpu.ops import fused_encoder as jax_fused_encoder
from variantformer_tpu_torch.config import ModelConfig
from variantformer_tpu_torch.ops import kernels
from variantformer_tpu_torch.ops.alibi import alibi_slopes
from variantformer_tpu_torch.ops.kernels import (
    ATTN_BLOCK_K,
    ATTN_BLOCK_Q,
    ATTN_BWD_DQ_CONSUMERS,
    ATTN_BWD_DQ_CONSUMERS_WIDE,
    ATTN_BWD_MAX_KEYS,
    ATTN_BWD_MAX_KEYS_WIDE,
    H100_SMS,
    LN_WARPS,
    SMEM_LIMIT,
    _attn_bwd_smem,
    attention_bwd_plan,
    layernorm_bwd_plan,
    layernorm_plan,
)

RTOL = 1e-5
_CFG = ModelConfig()
_WE, _MC = _CFG.window_encoder, _CFG.seq2gene
_T, _G1, _C, _L = 54, 201, 384, 200  # tissues, gene rows, CRE slots, window tokens

# (B, H, Sq, Sk, kv_div) of the main paths' backward calls: training at D=2,
# the checks at D=4, the training parity at D=1, the encoder over 400 gene
# windows.
MAIN = {
    "gene self D=4": (4 * _T, _MC.num_heads, _G1, _G1, 1),
    "gene self D=2": (2 * _T, _MC.num_heads, _G1, _G1, 1),
    "gene self D=1": (_T, _MC.num_heads, _G1, _G1, 1),
    "gene cross D=4 C=384": (4 * _T, _MC.num_heads, _G1, _C, _T),
    "gene cross D=2 C=384": (2 * _T, _MC.num_heads, _G1, _C, _T),
    "gene cross D=1 C=384": (_T, _MC.num_heads, _G1, _C, _T),
    "gene cross D=4 C=1": (4 * _T, _MC.num_heads, _G1, 1, _T),
    "gene cross D=2 C=1": (2 * _T, _MC.num_heads, _G1, 1, _T),
    "encoder self N=400": (400, _WE.num_heads, _L, _L, 1),
}
RAGGED = {
    "one query row": (3, 8, 1, 200, 1),
    "Sk=63": (3, 8, 63, 63, 1),
    "Sk=64": (3, 8, 64, 64, 1),
    "Sk=65": (3, 8, 65, 65, 1),
    "short gene": (2 * _T, 32, 37, 37, 1),
    "kv_div 27": (54, 32, _G1, _C, 27),
    "three key tiles": (108, 8, 70, 130, 54),
    "the most keys": (2, 8, 64, ATTN_BWD_MAX_KEYS, 2),
    "one block": (1, 1, 64, 64, 1),
    "577 keys, two dQ chunks": (108, 8, 70, 577, 54),
    "1024 keys": (4 * _T, _MC.num_heads, _G1, 1024, _T),
    "2048 keys, self": (2, 2, 130, 2048, 1),
}
ALL = {**MAIN, **RAGGED}
# Every case again at head dim 128 (encoder heads of 65-128, packed to 128
# lanes).
WIDE = {f"{name}, hd 128": shape for name, shape in ALL.items()}
HEAD_DIM = {**{name: 64 for name in ALL}, **{name: 128 for name in WIDE}}


def _cdiv(a, b):
    return -(-a // b)


def _dkv_walk(plan, b, heads, kv_div):
    """The dK/dV kernel's decode: block (x, h, r), kb = x % key_blocks,
    s = x // key_blocks, consumer c owning key tile kb * consumers + c (when
    inside Sk), items [s * per_split, min(items, (s + 1) * per_split)).
    Returns {(r, h, key tile, query row, query tile): visits}."""
    items = kv_div * plan.q_tiles
    seen = {}
    for x in range(plan.key_blocks * plan.splits):
        kb, s = x % plan.key_blocks, x // plan.key_blocks
        for r in range(b // kv_div):
            for h in range(heads):
                for c in range(plan.consumers):
                    tile = kb * plan.consumers + c
                    if tile >= plan.kv_tiles:
                        continue
                    for i in range(s * plan.per_split, min(items, (s + 1) * plan.per_split)):
                        key = (r, h, tile, r * kv_div + i // plan.q_tiles, i % plan.q_tiles)
                        seen[key] = seen.get(key, 0) + 1
    return seen


def _dq_walk(plan, b, heads, kv_div):
    """The dQ kernel's decode: block (s, h, r), consumer c taking items
    s * dq_per_split + c, + dq_consumers, ... below the split's end. Returns
    {(query row, head, query tile): visits}."""
    items = kv_div * plan.q_tiles
    seen = {}
    for s in range(plan.dq_splits):
        first, last = s * plan.dq_per_split, min(items, (s + 1) * plan.dq_per_split)
        for r in range(b // kv_div):
            for h in range(heads):
                for c in range(plan.dq_consumers):
                    for i in range(first + c, last, plan.dq_consumers):
                        key = (r * kv_div + i // plan.q_tiles, h, i % plan.q_tiles)
                        seen[key] = seen.get(key, 0) + 1
    return seen


@pytest.mark.parametrize("case", list(ALL) + list(WIDE))
def test_dkv_walk_visits_every_key_tile_and_item_once(case):
    b, heads, sq, sk, kv_div = {**ALL, **WIDE}[case]
    hd = HEAD_DIM[case]
    plan = attention_bwd_plan(b, heads, sq, sk, kv_div, head_dim=hd)
    assert plan.q_tiles == _cdiv(sq, ATTN_BLOCK_Q) and plan.kv_tiles == _cdiv(sk, ATTN_BLOCK_K)
    assert plan.consumers == (1 if plan.kv_tiles == 1 or hd > 64 else 2)
    assert plan.key_blocks == _cdiv(plan.kv_tiles, plan.consumers)
    seen = _dkv_walk(plan, b, heads, kv_div)
    want = {(r, h, tile, r * kv_div + j, t)
            for r in range(b // kv_div) for h in range(heads) for tile in range(plan.kv_tiles)
            for j in range(kv_div) for t in range(plan.q_tiles)}
    assert set(seen) == want
    assert set(seen.values()) == {1}
    # every split has work
    assert (plan.splits - 1) * plan.per_split < kv_div * plan.q_tiles
    assert plan.blocks == plan.groups * plan.splits
    assert plan.groups == (b // kv_div) * heads * plan.key_blocks


@pytest.mark.parametrize("case", list(ALL) + list(WIDE))
def test_dq_walk_visits_every_row_head_and_query_tile_once(case):
    b, heads, sq, sk, kv_div = {**ALL, **WIDE}[case]
    plan = attention_bwd_plan(b, heads, sq, sk, kv_div, head_dim=HEAD_DIM[case])
    assert plan.dq_consumers == (ATTN_BWD_DQ_CONSUMERS if HEAD_DIM[case] <= 64
                                 else ATTN_BWD_DQ_CONSUMERS_WIDE)
    seen = _dq_walk(plan, b, heads, kv_div)
    want = {(row, h, t) for row in range(b) for h in range(heads) for t in range(plan.q_tiles)}
    assert set(seen) == want
    assert set(seen.values()) == {1}
    assert (plan.dq_splits - 1) * plan.dq_per_split < kv_div * plan.q_tiles
    assert plan.dq_blocks == (b // kv_div) * heads * plan.dq_splits


@pytest.mark.parametrize("case", list(ALL) + list(WIDE))
def test_grids_and_shared_memory_fit_the_card(case):
    b, heads, sq, sk, kv_div = {**ALL, **WIDE}[case]
    plan = attention_bwd_plan(b, heads, sq, sk, kv_div, head_dim=HEAD_DIM[case])
    assert plan.key_blocks * plan.splits < 2 ** 31 and plan.dq_splits < 2 ** 31
    assert max(heads, b // kv_div) <= 65535
    # the sizes the kernels launch with (and refuse when they differ from
    # their own layout's)
    assert 0 < plan.dkv_smem <= SMEM_LIMIT and 0 < plan.dq_smem <= SMEM_LIMIT


def test_the_key_limit_is_what_the_dq_pass_fits():
    """ATTN_BWD_MAX_KEYS is the most keys a dQ block holds in SMEM_LIMIT, and
    every Sk up to 4096 takes dQ chunks within it, one chunk up to the
    limit."""
    dq_bytes = lambda keys: _attn_bwd_smem(2, _cdiv(keys, ATTN_BLOCK_K))[1]
    assert dq_bytes(ATTN_BWD_MAX_KEYS) <= SMEM_LIMIT < dq_bytes(ATTN_BWD_MAX_KEYS + 1)
    # K and V take two more 8 KB tiles a 64 keys; the rest does not grow
    assert dq_bytes(ATTN_BWD_MAX_KEYS + 1) - dq_bytes(ATTN_BWD_MAX_KEYS) == 2 * 64 * 64 * 2
    for sk in range(1, 4097, 7):
        plan = attention_bwd_plan(2, 8, 64, sk, 2)
        assert plan.dq_chunk_keys <= ATTN_BWD_MAX_KEYS and plan.dq_smem <= SMEM_LIMIT
        assert plan.dq_smem == dq_bytes(plan.dq_chunk_keys)
        assert (plan.dq_chunks == 1) == (sk <= ATTN_BWD_MAX_KEYS)
        assert (plan.dq_chunks - 1) * plan.dq_chunk_keys < sk <= plan.dq_chunks * plan.dq_chunk_keys
    assert attention_bwd_plan(2, 8, 64, 64, 2).dkv_smem < attention_bwd_plan(2, 8, 64, 65, 2).dkv_smem


def test_the_wide_key_limit_is_what_the_dq_pass_fits():
    """At head dim 128 (two 8 KB boxes a tile, ATTN_BWD_DQ_CONSUMERS_WIDE
    dQ warpgroups) ATTN_BWD_MAX_KEYS_WIDE is the most keys a dQ block holds
    in SMEM_LIMIT; every Sk up to 2048 takes dQ chunks within it (the
    encoder's 200 keys one), and a dK/dV block of one warpgroup fits."""
    dq_bytes = lambda keys: _attn_bwd_smem(1, _cdiv(keys, ATTN_BLOCK_K), 128)[1]
    assert dq_bytes(ATTN_BWD_MAX_KEYS_WIDE) <= SMEM_LIMIT < dq_bytes(ATTN_BWD_MAX_KEYS_WIDE + 1)
    assert dq_bytes(ATTN_BWD_MAX_KEYS_WIDE + 1) - dq_bytes(ATTN_BWD_MAX_KEYS_WIDE) == 2 * 2 * 8192
    for sk in range(1, 2049, 7):
        plan = attention_bwd_plan(2, 4, 64, sk, 2, head_dim=128)
        assert plan.dq_chunk_keys <= ATTN_BWD_MAX_KEYS_WIDE and plan.dq_smem <= SMEM_LIMIT
        assert plan.dq_smem == dq_bytes(plan.dq_chunk_keys)
        assert (plan.dq_chunks == 1) == (sk <= ATTN_BWD_MAX_KEYS_WIDE)
        assert plan.consumers == 1 and plan.dkv_smem <= SMEM_LIMIT
    assert attention_bwd_plan(400, 4, _L, _L, head_dim=128).dq_chunks == 1


@pytest.mark.parametrize("case", list(MAIN))
def test_main_path_grids(case):
    """The self-attentions keep one split (the K/V cotangent summed inside a
    block, no partials); the cross-attention splits the tissues so that both
    passes give at least one block per SM."""
    b, heads, sq, sk, kv_div = MAIN[case]
    plan = attention_bwd_plan(b, heads, sq, sk, kv_div)
    assert plan.blocks >= H100_SMS and plan.dq_blocks >= H100_SMS
    if kv_div == 1:
        assert plan.splits == 1 and plan.dq_splits == 1
    else:
        assert plan.splits > 1 and plan.dq_splits > 1


# ---------------------------------------------------------------------------
# The split walks' arithmetic against attention_bwd_plain, at f32
# ---------------------------------------------------------------------------


def _probs(q, k, o, lse, do, v, lens, slopes, scale, heads, kv_div):
    """P and dS [B, H, Sq, Sk] as the kernels rebuild them: P = exp(s -
    lse) on the keys before kv_len (1/Sk for a row with kv_len 0), dS = P
    (dO V^T - rowsum(dO O)) scale, 0 on masked keys and rows with kv_len 0."""
    b, sq, e = q.shape
    hd = e // heads
    sk = k.shape[1]
    split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, hd)
    kr, vr = (split(t).repeat_interleave(kv_div, 0) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", split(q), kr) * scale
    if slopes is not None:
        dist = (torch.arange(sq)[:, None] - torch.arange(sk)[None, :]).abs().float()
        s = s - slopes[None, :, None, None] * dist
    valid = (torch.arange(sk)[None, :] < lens[:, None])[:, None, None, :]
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    p = torch.where((lens == 0)[:, None, None, None], 1.0 / sk, p)
    dp = torch.einsum("bqhd,bkhd->bhqk", split(do), vr)
    delta = (split(do) * split(o)).sum(-1).transpose(1, 2)[..., None]
    ds = torch.where(valid, p * (dp - delta) * scale, 0.0)
    return p, ds


def _emulate(q, k, v, o, lse, do, kv_len, slopes, scale, heads, kv_div, len_div, plan):
    """dq, dk, dv by the kernels' walks: per (K/V row, head, key block,
    split) f32 partials of dK and dV over the split's live items, summed in
    split order; per dQ item the key tiles up to the last valid key."""
    b, sq, e = q.shape
    hd, sk = e // heads, k.shape[1]
    lens = kv_len.repeat_interleave(len_div)
    p, ds = _probs(q, k, o, lse, do, v, lens, slopes, scale, heads, kv_div)
    keys_of = lambda n: min(n, sk) if n > 0 else sk
    items = kv_div * plan.q_tiles
    dk = torch.full((b // kv_div, sk, e), float("nan"))
    dv = torch.full_like(dk, float("nan"))
    for r in range(b // kv_div):
        for h in range(heads):
            cols = slice(h * hd, (h + 1) * hd)
            for kb in range(plan.key_blocks):
                key0 = kb * plan.consumers * ATTN_BLOCK_K
                keys = slice(key0, min(sk, key0 + plan.consumers * ATTN_BLOCK_K))
                n_keys = keys.stop - keys.start
                total_k = total_v = None
                for s in range(plan.splits):
                    part_k, part_v = torch.zeros(n_keys, hd), torch.zeros(n_keys, hd)
                    for i in range(s * plan.per_split, min(items, (s + 1) * plan.per_split)):
                        row, t = r * kv_div + i // plan.q_tiles, i % plan.q_tiles
                        nk = keys_of(int(lens[row]))
                        if key0 >= nk:
                            continue  # the block's keys are all past the row's kv_len
                        qs = slice(t * ATTN_BLOCK_Q, min(sq, (t + 1) * ATTN_BLOCK_Q))
                        for c in range(plan.consumers):
                            t0 = key0 + c * ATTN_BLOCK_K
                            if t0 >= nk:
                                continue
                            kt = slice(t0 - key0, min(sk, t0 + ATTN_BLOCK_K) - key0)
                            ks = slice(t0, min(sk, t0 + ATTN_BLOCK_K))
                            part_k[kt] += ds[row, h, qs, ks].T @ q[row, qs, cols]
                            part_v[kt] += p[row, h, qs, ks].T @ do[row, qs, cols]
                    total_k = part_k if total_k is None else total_k + part_k
                    total_v = part_v if total_v is None else total_v + part_v
                dk[r, keys, cols] = total_k
                dv[r, keys, cols] = total_v
    dq = torch.full_like(q, float("nan"))
    for s in range(plan.dq_splits):
        first, last = s * plan.dq_per_split, min(items, (s + 1) * plan.dq_per_split)
        for r in range(b // kv_div):
            for h in range(heads):
                cols = slice(h * hd, (h + 1) * hd)
                for i in range(first, last):
                    row, t = r * kv_div + i // plan.q_tiles, i % plan.q_tiles
                    n = int(lens[row])
                    nk = min(n, sk) if n > 0 else 0
                    qs = slice(t * ATTN_BLOCK_Q, min(sq, (t + 1) * ATTN_BLOCK_Q))
                    acc = torch.zeros(qs.stop - qs.start, hd)
                    for j in range(max(1, _cdiv(nk, ATTN_BLOCK_K))):
                        ks = slice(j * ATTN_BLOCK_K, min(sk, (j + 1) * ATTN_BLOCK_K))
                        acc += ds[row, h, qs, ks] @ k[r, ks, cols]
                    dq[row, qs, cols] = acc
    return dq, dk, dv


EMULATED = {
    # name: (B, Sq, Sk, heads, head_dim, kv_len, alibi, kv_div, len_div)
    "self, three key tiles, kv_len 0": (3, 130, 130, 2, 8, [130, 70, 0], True, 1, 1),
    "self, one key tile, kv_len 1": (2, 70, 40, 2, 8, [40, 1], True, 1, 1),
    "gene self, len shared by tissues": (6, 65, 65, 2, 8, [65, 2], True, 1, 3),
    "cross, kv_div 54, three key tiles": (108, 70, 130, 2, 8, [130, 1], False, 54, 54),
    "cross, kv_div 54, one key": (108, 70, 1, 2, 8, [1, 1], False, 54, 54),
    "cross, kv_div 54, no valid key": (108, 70, 65, 2, 8, [0, 65], False, 54, 54),
    "self, hd 128, three key tiles, kv_len 0": (2, 70, 130, 1, 128, [130, 0], True, 1, 1),
    "cross, hd 128, kv_div 54, two key tiles": (108, 65, 100, 1, 128, [100, 1], False, 54, 54),
}


def _close(got, want, name=""):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=RTOL * float(want.abs().max()),
                               msg=name)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("case", list(EMULATED))
def test_split_walk_sums_equal_the_plain_version(case, split):
    """At these small shapes the plan splits every group's items over blocks
    (partials summed in split order); the same walk unsplit is held too."""
    b, sq, sk, heads, hd, lens, alibi, kv_div, len_div = EMULATED[case]
    rng = np.random.default_rng(5)
    rand = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    e = heads * hd
    q, k, v, do = rand(b, sq, e), rand(b // kv_div, sk, e), rand(b // kv_div, sk, e), rand(b, sq, e)
    kv_len = torch.tensor(lens, dtype=torch.int32)
    slopes = torch.from_numpy(alibi_slopes(heads)) if alibi else None
    scale = hd ** -0.5
    _, lse, o = kernels.attention_plain(q, k, v, kv_len, slopes, scale, heads, kv_div, len_div,
                                        for_backward=True)
    args = (q, k, v, o, lse, do, kv_len, slopes, scale, heads, kv_div, len_div)
    plan = attention_bwd_plan(b, heads, sq, sk, kv_div, head_dim=hd)
    assert plan.splits > 1
    if not split:
        items = kv_div * plan.q_tiles
        plan = plan._replace(splits=1, per_split=items, blocks=plan.groups, dq_splits=1,
                             dq_per_split=items, dq_blocks=plan.dq_blocks // plan.dq_splits)
    got = _emulate(*args, plan)
    want = kernels.attention_bwd_plain(*args)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close(g, w, f"{case} {name} {plan}")
    # keys past every kv_len of a K/V row's query rows: exactly 0
    row_lens = kv_len.repeat_interleave(len_div).view(b // kv_div, kv_div)
    for r in range(b // kv_div):
        if int(row_lens[r].min()) > 0:
            past = int(row_lens[r].max())
            assert (got[1][r, past:] == 0).all() and (got[2][r, past:] == 0).all()
        elif int(row_lens[r].max()) == 0:
            assert (got[1][r] == 0).all()


def _emulate_dq_chunks(q, k, v, o, lse, do, kv_len, slopes, scale, heads, kv_div, len_div,
                      plan):
    """dq by the chunked dQ pass at f32: per item, launch c (keys from k0 =
    c * dq_chunk_keys) adds dS K over its tiles up to the row's last valid
    key (the first launch walks one tile with dS = 0 where there is none),
    resuming the f32 accumulator the previous launch left; the launch that
    holds the row's last valid key writes dq."""
    b, sq, e = q.shape
    hd, sk = e // heads, k.shape[1]
    lens = kv_len.repeat_interleave(len_div)
    _, ds = _probs(q, k, o, lse, do, v, lens, slopes, scale, heads, kv_div)
    ck = plan.dq_chunk_keys
    dq = torch.full_like(q, float("nan"))
    for row in range(b):
        n = int(lens[row])
        nk = min(n, sk) if n > 0 else 0
        for h in range(heads):
            cols = slice(h * hd, (h + 1) * hd)
            acc, written = None, 0
            for c in range(plan.dq_chunks):
                k0 = c * ck
                nt = max(1 if k0 == 0 else 0, _cdiv(min(nk - k0, ck), ATTN_BLOCK_K))
                if nt <= 0:
                    continue  # the row's keys end before this chunk
                assert (acc is None) == (k0 == 0)  # resumed only what a chunk left
                acc = torch.zeros(sq, hd) if acc is None else acc
                for j in range(nt):
                    ks = slice(k0 + j * ATTN_BLOCK_K, min(sk, k0 + (j + 1) * ATTN_BLOCK_K))
                    acc = acc + ds[row, h, :, ks] @ k[row // kv_div, ks, cols]
                if nk <= k0 + ck:
                    dq[row, :, cols] = acc
                    written += 1
            assert written == 1
    return dq


DQ_CHUNKED = {
    # name: (B, Sq, Sk, heads, head_dim, kv_len, ALiBi, kv_div, len_div, max_keys)
    "self, 4 chunks of 64, kv_len 0, 1, at a boundary, mid-chunk":
        (4, 20, 200, 2, 8, [0, 1, 128, 150], True, 1, 1, 64),
    "cross, kv_div 54, 3 chunks, 0 and at the last boundary":
        (108, 7, 130, 2, 8, [0, 128], False, 54, 54, 64),
    "cross, kv_div 54, 1024 keys in 2 chunks of 512":
        (108, 5, 1024, 1, 8, [1024, 512], False, 54, 54, ATTN_BWD_MAX_KEYS),
    "self, 2048 keys in 4 chunks of 512, ALiBi":
        (2, 6, 2048, 1, 8, [2048, 1500], True, 1, 1, ATTN_BWD_MAX_KEYS),
    "self, hd 128, 400 keys in 2 chunks of 256, ALiBi":
        (2, 6, 400, 1, 128, [400, 256], True, 1, 1, ATTN_BWD_MAX_KEYS),
}


@pytest.mark.parametrize("case", list(DQ_CHUNKED))
def test_chunked_dq_equals_the_plain_version(case):
    b, sq, sk, heads, hd, lens, alibi, kv_div, len_div, max_keys = DQ_CHUNKED[case]
    rng = np.random.default_rng(9)
    rand = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    e = heads * hd
    q, k, v, do = rand(b, sq, e), rand(b // kv_div, sk, e), rand(b // kv_div, sk, e), rand(b, sq, e)
    kv_len = torch.tensor(lens, dtype=torch.int32)
    slopes = torch.from_numpy(alibi_slopes(heads)) if alibi else None
    scale = hd ** -0.5
    _, lse, o = kernels.attention_plain(q, k, v, kv_len, slopes, scale, heads, kv_div, len_div,
                                        for_backward=True)
    args = (q, k, v, o, lse, do, kv_len, slopes, scale, heads, kv_div, len_div)
    plan = attention_bwd_plan(b, heads, sq, sk, kv_div, max_keys=max_keys, head_dim=hd)
    assert plan.dq_chunks > 1
    dq = _emulate_dq_chunks(*args, plan)
    _close(dq, kernels.attention_bwd_plain(*args)[0], f"{case} dq {plan}")


# ---------------------------------------------------------------------------
# layernorm_bwd_plan and the one-pass LayerNorm backward
# ---------------------------------------------------------------------------

LN_SHAPES = [(1, 8), (7, 200), (8, 512), (9, 512), (1000, 1536), (4 * _T * _G1, 1536),
             (2 * _T * _G1, 1536), (400 * _L, 512)]


@pytest.mark.parametrize("rows,e", LN_SHAPES)
def test_layernorm_bwd_spans_cover_every_row_once(rows, e):
    plan = layernorm_bwd_plan(rows, e)
    per_sm = 1 if e > 1024 else 2
    assert 1 <= plan.blocks <= H100_SMS * per_sm
    visits = np.zeros(rows, dtype=np.int64)
    for blk in range(plan.blocks):
        span = range(blk * plan.per_block, min(rows, (blk + 1) * plan.per_block))
        assert len(span) > 0  # every block has rows
        for w in range(LN_WARPS):
            for row in span[w::LN_WARPS]:
                visits[row] += 1
    assert (visits == 1).all()
    if rows >= LN_WARPS * H100_SMS * per_sm:
        assert plan.blocks == H100_SMS * per_sm  # persistent: the whole card


def _ln_inputs(rows, e, seed=3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, e)) * 3 + 0.5).astype(np.float32)
    dy = rng.standard_normal((rows, e)).astype(np.float32)
    scale = (rng.random(e) + 0.5).astype(np.float32)
    return x, dy, scale


@pytest.mark.parametrize("rows,e,sms", [(300, 64, 4), (37, 24, 1), (1000, 256, 132)])
def test_layernorm_bwd_partials_in_kernel_order_equal_the_plain_version(rows, e, sms):
    """dscale and dbias as the kernel sums them: each warp over its rows,
    the block's warps in order, then the blocks' partial rows in order."""
    x, dy, scale = (torch.from_numpy(a) for a in _ln_inputs(rows, e))
    plan = layernorm_bwd_plan(rows, e, sms=sms)
    xhat = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(x.var(-1, unbiased=False, keepdim=True)
                                                        + 1e-5)
    parts_a, parts_b = [], []
    for blk in range(plan.blocks):
        span = range(blk * plan.per_block, min(rows, (blk + 1) * plan.per_block))
        warp_a, warp_b = [], []
        for w in range(LN_WARPS):
            acc_a, acc_b = torch.zeros(e), torch.zeros(e)
            for row in span[w::LN_WARPS]:
                acc_a += dy[row] * xhat[row]
                acc_b += dy[row]
            warp_a.append(acc_a)
            warp_b.append(acc_b)
        parts_a.append(sum(warp_a[1:], warp_a[0]))
        parts_b.append(sum(warp_b[1:], warp_b[0]))
    dscale, dbias = sum(parts_a[1:], parts_a[0]), sum(parts_b[1:], parts_b[0])
    _, want_scale, want_bias = kernels.layernorm_bwd_plain(x, dy, scale)
    _close(dscale, want_scale, "dscale")
    _close(dbias, want_bias, "dbias")


@pytest.mark.parametrize("rows,e", [(16, 64), (33, 512), (5, 1536)])
def test_layernorm_bwd_plain_matches_the_jax_ln_bwd(rows, e):
    """The same seeded inputs through the JAX package's ``_ln_bwd`` (with
    its ``_ln_fwd_vals`` statistics) and ``layernorm_bwd_plain``, at f32."""
    x, dy, scale = _ln_inputs(rows, e, seed=rows)
    _, xhat, rstd = jax_fused_encoder._ln_fwd_vals(jnp.asarray(x), jnp.asarray(scale),
                                                   jnp.zeros(e, jnp.float32))
    jdx, jscale, jbias = (np.array(a) for a in jax_fused_encoder._ln_bwd(
        jnp.asarray(dy), xhat, rstd, jnp.asarray(scale)))
    dx, dscale, dbias = kernels.layernorm_bwd_plain(*(torch.from_numpy(a) for a in (x, dy, scale)))
    for got, want, name in ((dx, jdx, "dx"), (dscale, jscale, "dscale"), (dbias, jbias, "dbias")):
        _close(got, torch.from_numpy(want), name)


# ---------------------------------------------------------------------------
# layernorm_plan: the LayerNorm forward's grid
# ---------------------------------------------------------------------------


def _ln_ring_walk(plan, rows, depth):
    """Rows normalised by each warp of the register-resident LayerNorm, as
    it runs them: slot d of a ring of ``depth`` row buffers is loaded with
    the warp's d-th row, and after a row is normalised its slot is loaded
    with the row depth strides on. Returns the rows in the order warps
    normalise them, checking that each is normalised from the slot that
    loaded it."""
    stride = plan.blocks * LN_WARPS
    done = []
    for blk in range(plan.blocks):
        for w in range(LN_WARPS):
            row0 = blk * LN_WARPS + w
            slot = [row0 + d * stride if row0 + d * stride < rows else None
                    for d in range(depth)]
            for base in range(row0, rows, depth * stride):
                for d in range(depth):
                    row = base + d * stride
                    if row >= rows:
                        break
                    assert slot[d] == row
                    done.append(row)
                    nxt = row + depth * stride
                    slot[d] = nxt if nxt < rows else None
    return done


@pytest.mark.parametrize("e", [512, 1536, 1000, 2048])
@pytest.mark.parametrize("rows", [1, 7, 8, 43416, 307200])
def test_layernorm_rows_cover_every_row_once(rows, e):
    """Warp w of block i takes rows i * LN_WARPS + w + j * blocks *
    LN_WARPS: every row once, from the ring slot that loaded it (rings of 3
    rows up to E = 1536, of 2 at 1792 and of 1 at 2048). E a multiple of 256
    up to 2048 takes the
    register-resident kernel on a persistent grid (the whole card once the
    rows fill it, every block with rows); any other E the general kernel,
    a warp a row."""
    plan = layernorm_plan(rows, e)
    if e % 256:
        assert plan.chunks == 0 and plan.blocks == _cdiv(rows, LN_WARPS)
        depth = 1
    else:
        per_sm = 1 if e > 768 else 2
        assert plan.chunks == e // 256
        assert plan.blocks == min(_cdiv(rows, LN_WARPS), H100_SMS * per_sm)
        depth = 3 if plan.chunks <= 6 else 2 if plan.chunks == 7 else 1
    visits = np.bincount(np.asarray(_ln_ring_walk(plan, rows, depth), dtype=np.int64),
                         minlength=rows)
    assert len(visits) == rows and (visits == 1).all()

// attention_sm90: masked softmax attention with optional symmetric ALiBi,
// written for Hopper (TMA, mbarriers, wgmma).
//
// Replaces the per-head attention loops inside the Pallas kernels
// (variantformer_tpu/ops/fused_encoder.py:_kernel l.131-159;
// variantformer_tpu/ops/fused_modulator.py:_kernel l.180-215 self- and
// l.225-247 cross-attention). For query row b, head h, position i and key
// j < Sk:
//   s_ij = (q_i . k_j) * scale - slope_h * |i - j|   if j < kv_len
//        = MASK_VALUE (finite, -0.7 * FLT_MAX)        otherwise
//   out_i = softmax_j(s_ij) @ v
// Query row b reads K/V row b / kv_div (the gene stack's donor-shared CRE
// K/V) and kv_len[b / len_div]. A row with kv_len = 0 averages V over all
// Sk keys, as the plain version does; otherwise keys at or past kv_len
// weigh exactly 0, so the walk stops at the last valid key's tile. Softmax
// statistics are f32; the weights are rounded to bf16 before P V. For the
// backward (csrc/attention_bwd_sm90.cu) it optionally also writes each row's
// log-sum-exp m + log(l) to an f32 [B, H, Sq] buffer, and to an f32 buffer
// laid out like `out` the output with the bf16-rounded weights renormalised
// by their own running sum lb (an exact weighted average of V, from which
// the backward's delta = rowsum(dO * O) is taken). The serving path passes
// null for both.
//
// What bounds it on the H100. Reading q, k, v and writing out once takes
// 0.08-0.38 ms at the main-path shapes (S <= 384; head dim 48 or 64, and 128
// for encoder heads of 65-128, zero-padded to 128 lanes in the packs), the
// tensor-core work 0.03-0.10 ms: by those two the self-attentions are bound
// by bytes and the gene cross-attention (54 tissues' queries on one gene's
// K/V) by operations. Above both sits the softmax: one ex2 per score on the
// SM's 16-a-clock MUFU pipe, ~0.18 ms for the gene cross-attention's 680 M
// padded scores, so at head dims 48 and 64 each score has to cost the
// softmax as few instructions as it can, and the tensor cores have to run
// beside it, not between its tiles. The kernel it replaces (wmma, scores
// and the output accumulator round-tripping through shared memory, a
// per-row warp softmax) ran at 17-30x the bytes' bound and re-read each
// K/V head once per 64-query tile, and for the cross-attention once per
// tissue too. Design:
//   - One block per (K/V row, head, split): thread 0 TMA-loads that head's
//     K and V once, in 64-key tiles of [64 keys][64 columns] (128-byte
//     swizzle; a 3-D map [batch][rows][H * head_dim] picks the head by its
//     column, zero-fills past Sk and never reads the next batch row), each
//     tile on its own mbarrier, up to the longest key count of the block's
//     rows. The block's work items are (query row sharing that K/V row,
//     64-query tile); the launch plan (ops/kernels.py attention_plan)
//     splits a group's items over blocks only where the groups alone would
//     not fill the card (the cross-attention: 54 tissues x 4 tiles per
//     gene and head).
//   - Two consumer warpgroups (four where K and V take more than 64 KB,
//     the cross-attention's 384 keys: one block then fills an SM) take
//     alternate items. Each double-buffers its Q tiles (TMA, prefetched one
//     item ahead) and walks the key tiles: S = Q K^T as wgmma m64n64k16 from
//     shared memory (K-major both; head dim 48 is three k16 steps over the
//     64-wide box, 64 is four), the online softmax in registers on the
//     accumulator layout (base 2; a row's max and sums over the 4 lanes of
//     a quad; the masks only on a row's last tiles), then O += P V as wgmma
//     with P as the A fragment in registers (the f32 weights pack pairwise
//     into it) and V as an MN-major B. O stays in registers; the epilogue
//     writes bf16 out (and out32, lse) straight from them. P V runs 64
//     columns wide: at head dim 48 the last 16 are the next head's (or
//     zero-filled) and are dropped.
//   - The tensor cores run beside the softmax (FlashAttention-3's order
//     within a warpgroup): for key tile j the loop issues S_j, rescales O
//     while S_j runs, issues O += P_{j-1} V_{j-1}, waits for S_j alone
//     (wgmma_wait<1>), takes the softmax of S_j while P V still runs, and
//     then waits for P V and packs P_j. One score buffer does: s[32],
//     p[16] and o[32] take 80 of a thread's 128 registers (a second P
//     buffer, to pack P_j without waiting, made ptxas serialise the wgmma
//     for want of registers, C7511). ptxas places the wait for P V ahead
//     of the ex2 (it interleaves the pack into P's registers with them), so
//     the scaling, masks and max run beside this warpgroup's P V and the
//     ex2 beside the other warpgroups' products. The full key tiles and a
//     row's masked last tiles run in loops of their own: a branch between
//     the two waits made ptxas wait for P V where the paths join. Every
//     branch around a wgmma is one ptxas can see all four warps take: the
//     warpgroup's index and each item's key count are broadcast from lane 0
//     (__shfl_sync), and nothing else writes a wgmma's registers under a
//     branch. Without that ptxas serialised every wgmma (C7520: "program
//     dependence on compiler-inserted WG.AR in divergent path"), waiting on
//     each before the next instruction.
//   - The softmax does only the call's work (template arguments the launch
//     picks from the call: ALIBI where slopes are given, STATS where lse
//     and out32 are wanted). ALiBi's distance |row - key| is taken from
//     float(row - first key of the tile), converted once a tile per row,
//     minus the element's key offset, a constant: the same float as
//     converting row - key, with no conversion per score. Without ALiBi no
//     bias term is computed. Without STATS no renormalised sum of the
//     bf16 weights is kept, and where ALiBi is off too the scale is folded
//     into the exponent (the max taken on the raw scores, each weight one
//     FFMA and one ex2); a row with no valid key then scores its keys 0
//     instead of MASK_VALUE, the same uniform weights. With STATS each
//     score is scaled, biased and offset by the max in separate steps (the
//     hoisted distance and a dropped zero-slope term change no float), so
//     out, lse and out32 do not depend on the variant: the training
//     forward's bits are those of the unvaried walk.
// 64-key tiles keep one instruction shape for the three uses, so two blocks
// of two warpgroups share an SM where K and V fit in 64 KB (Sk <= 256).
//
// Head dim 128 (HEAD_BOXES = 2): a head's 64-row tile is two 64-column boxes,
// each its own TMA box (the 128-byte swizzle holds 64 bf16 columns), side by
// side in shared memory; S = Q K^T takes eight k16 steps over both, and O is
// two 64-column accumulators (64 registers a thread), each its own P V
// product against one V box. Every tile is twice the bytes, so a block of two
// consumer warpgroups holds up to 5 key tiles (320 keys; the plan's
// ATTN_MAX_KEYS_WIDE) and one block fills an SM, which lets its threads take
// up to 255 registers (__launch_bounds__ with one block an SM).
//
// Past MAX_KV_TILES * 64 = 768 keys (a gene with more CREs; the JAX package
// takes any count) K and V no longer fit: the launch plan cuts the keys into
// chunks of at most 768 and the kernel runs once per chunk, in key order
// (the CHUNKED instantiation, one per head dim and block shape: STATS
// arithmetic, the ALiBi term with a zero slope where none is given, lse and
// out32 written where asked for). A launch loads only its chunk's tiles
// (the tensor map's row coordinate offset by k0), takes ALiBi and the masks
// at the absolute key index, and for each item resumes the online softmax
// from the state the previous chunk left: the f32 O in out's layout, and
// per row and lane of a quad the running max and the two sums (float4). An
// item whose valid keys end before the chunk is skipped; the chunk holding
// its last valid key writes out, out32 and lse as the one-chunk kernel
// does, the others write the state. Carried in f32, the state makes the
// chunked walk the same arithmetic as one walk over all keys with STATS:
// the same bits. Off the main path, the chunked instantiation keeps the
// state's pointers and the runtime slope in registers: at head dim 48
// ptxas serialises its wgmma for want of registers (C7511) and, with two
// consumer warpgroups, spills.

#include <type_traits>

#include "attention_tiles.cuh"

namespace {

using namespace vf::attn;

// K tiles, V tiles, two Q buffers per consumer warpgroup (each tile `boxes`
// 64-column boxes), then the barriers.
constexpr int smem_bytes(int kv_tiles, int consumers, int boxes) {
  return 1024 + (2 * kv_tiles + 2 * consumers) * boxes * TILE_BYTES +
         8 * (MAX_KV_TILES + 2 * consumers);
}

// Accumulator i of a consumer thread (warp w of its warpgroup, lane l), for
// the scores and for O alike: row 16 w + l / 4 + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (l % 4) + (i & 1). The wgmma A fragment of k16 step kk
// holds, in register r, columns 16 kk + 8 (r >> 1) + 2 (l % 4) + {0, 1} of
// row 16 w + l / 4 + 8 (r & 1): the score pair (8 kk + 2 r, 8 kk + 2 r + 1).
//
// The softmax runs in base 2: the scores are scaled by scale * log2(e) and
// the ALiBi slope by log2(e), so each weight is one ex2; m is kept in that
// base (in the raw scores' units where the scale is folded into the
// exponent) and converted back for the log-sum-exp.
//
// k0 and ck: the chunk's first key and its key count (a multiple of KT; the
// one-chunk launch passes 0 and Sk). o_state and st_state: the walk's state
// between chunks (CHUNKED only).
template <int HD, int NC, bool CHUNKED, bool ALIBI, bool STATS>
__global__ void __launch_bounds__(128 * NC, HD > 64 ? 1 : 4 / NC)
attention_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, vf::bf16* __restrict__ out,
                      long long o_bs, long long o_rs, int Sq, int Sk,
                      const int* __restrict__ kv_len, int len_div, int kv_div,
                      const float* __restrict__ slopes, float scale, float* __restrict__ lse,
                      float* __restrict__ out32, int per_split, int k0, int ck,
                      float* __restrict__ o_state, float4* __restrict__ st_state) {
  static_assert(!CHUNKED || (ALIBI && STATS), "the chunked walk takes the STATS arithmetic");
  constexpr bool FOLD = !ALIBI && !STATS;  // the scale folded into the exponent
  constexpr int HB = head_boxes(HD), HT = HB * TILE_ELEMS;  // a head tile's boxes, elements
  extern __shared__ unsigned char raw[];
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  const int kv_tiles = (ck + KT - 1) / KT;
  vf::bf16* Ks = reinterpret_cast<vf::bf16*>(base);
  vf::bf16* Vs = Ks + kv_tiles * HT;
  vf::bf16* Qs = Vs + kv_tiles * HT;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Qs + 2 * NC * HT);
  uint64_t* q_full = kv_full + MAX_KV_TILES;

  const int tid = threadIdx.x, t = tid % 128, warp = t / 32, lane = tid % 32;
  // Broadcast from lane 0, so that ptxas knows every thread of a warp holds
  // it: the item loop and the key walk branch on it.
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int h = blockIdx.y, r = blockIdx.z, H = gridDim.y;
  const int col0 = h * HD;
  const int q_tiles = (Sq + BQ - 1) / BQ;
  const int first = blockIdx.x * per_split;
  const int last = min(kv_div * q_tiles, first + per_split);

  // The keys of the chunk this block's rows need: the longest of their key
  // counts (none where every row's keys end before the chunk).
  int need = 0;
  for (int b = r * kv_div + first / q_tiles; b <= r * kv_div + (last - 1) / q_tiles; ++b)
    need = max(need, min(keys_of(kv_len[b / len_div], Sk) - k0, ck));
  const int tiles = (need + KT - 1) / KT;

  if (tid == 0) {
    for (int j = 0; j < MAX_KV_TILES; ++j) mbar_init(&kv_full[j], 1);
    for (int i = 0; i < 2 * NC; ++i) mbar_init(&q_full[i], 1);
    mbar_fence_init();
  }
  __syncthreads();

  vf::bf16* Qw = Qs + wg * 2 * HT;
  uint64_t* qf = q_full + 2 * wg;
  auto load_q = [&](int item, int buf) {
    const int b = r * kv_div + item / q_tiles;
    mbar_arrive_tx(&qf[buf], HB * TILE_BYTES);
    for (int hb = 0; hb < HB; ++hb)
      tma_load_3d(Qw + buf * HT + hb * TILE_ELEMS, &map_q, &qf[buf], col0 + 64 * hb,
                  (item % q_tiles) * BQ, b);
  };
  if (tid == 0) {
    for (int j = 0; j < tiles; ++j) {
      mbar_arrive_tx(&kv_full[j], 2 * HB * TILE_BYTES);
      for (int hb = 0; hb < HB; ++hb) {
        tma_load_3d(Ks + j * HT + hb * TILE_ELEMS, &map_k, &kv_full[j], col0 + 64 * hb,
                    k0 + j * KT, r);
        tma_load_3d(Vs + j * HT + hb * TILE_ELEMS, &map_v, &kv_full[j], col0 + 64 * hb,
                    k0 + j * KT, r);
      }
    }
  }
  if (t == 0) {
    for (int n = 0; n < 2; ++n)
      if (first + wg + n * NC < last) load_q(first + wg + n * NC, n);
  }

  const float s2 = scale * LOG2E;                                   // score scale, base 2
  const float a2 = ALIBI && slopes ? slopes[h] * LOG2E : 0.0f;      // ALiBi slope, base 2
  // What a row with no valid key scores its keys (all alike: uniform weights).
  constexpr float MASKED = FOLD ? 0.0f : MASK_VALUE;
  int n = 0;
  for (int item = first + wg; item < last; item += NC, ++n) {
    const int buf = n & 1;
    const int b = r * kv_div + item / q_tiles;
    const int q0 = (item % q_tiles) * BQ;
    const int len = __shfl_sync(0xffffffffu, kv_len[b / len_div], 0);  // uniform, as wg
    const int nk = keys_of(len, Sk);
    const int nt = (min(nk - k0, ck) + KT - 1) / KT;       // the chunk's tiles of the walk
    const int full_tiles = len > 0 ? nk / KT - k0 / KT : 0;  // of those, tiles with every key valid
    const bool work = !CHUNKED || nt > 0;
    const bool last_chunk = !CHUNKED || nk <= k0 + ck;
    const int row[2] = {q0 + 16 * warp + (lane >> 2), q0 + 16 * warp + (lane >> 2) + 8};
    const vf::bf16* qs = Qw + buf * HT;
    const long long st_row = ((long long)b * H + h) * Sq;  // this row's (max, sums) per quad lane

    float s[32], o[HB][32];
    uint32_t p[16];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, lb[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hb = 0; hb < HB; ++hb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[hb][i] = 0.0f;
    if constexpr (CHUNKED) {
      if (work && k0 > 0) {  // resume the walk where the previous chunk left it
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          // Rows past Sq (the ragged last tile) read row Sq - 1's state and
          // are never stored: no branch writes O.
          const int qi = min(row[hr], Sq - 1);
          const float4 st = st_state[(st_row + qi) * 4 + (lane & 3)];
          m[hr] = st.x;
          l[hr] = st.y;
          lb[hr] = st.z;
          const float* os = o_state + (long long)b * o_bs + (long long)qi * o_rs + col0 +
                            2 * (lane & 3);
#pragma unroll
          for (int c = 0; c < HD / 8; ++c) {
            const float2 v = *reinterpret_cast<const float2*>(os + 8 * c);
            VF_ACC(o, c, hr, 0) = v.x;
            VF_ACC(o, c, hr, 1) = v.y;
          }
        }
      }
    }

    // The softmax of key tile j's scores S_j (done): each score scaled,
    // biased and masked (MASKED: the row's last tiles), the rows' new max,
    // alpha = how far their old max fell, l rescaled and summed, and each
    // weight 2^(x - m) left in s.
    auto softmax = [&](int j, float (&alpha)[2], auto masked) {
      const int kb = k0 + j * KT + 2 * (lane & 3);  // the key of s[0]
      [[maybe_unused]] float d[2] = {0.0f, 0.0f};   // row - kb, exact (ALiBi)
      if constexpr (ALIBI) {
        d[0] = static_cast<float>(row[0] - kb);
        d[1] = static_cast<float>(row[1] - kb);
      }
      // Element i's key is kb + off(i); its score in the softmax's domain.
      auto off = [](int i) { return 8 * (i >> 2) + (i & 1); };
      auto score = [&](float x, int i) {
        if constexpr (FOLD) return x;
        else if constexpr (ALIBI)
          return x * s2 - a2 * fabsf(d[(i >> 1) & 1] - static_cast<float>(off(i)));
        else return x * s2;
      };
      if constexpr (!decltype(masked)::value) {
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = score(s[i], i);
      } else {
        const int nk_left = nk - kb, len_left = len - kb;  // keys past kb: walked, valid
#pragma unroll
        for (int i = 0; i < 32; ++i)  // past the walk's keys: weight exactly 0
          s[i] = off(i) >= nk_left ? -INFINITY : off(i) >= len_left ? MASKED : score(s[i], i);
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float ms[2];  // the max in the exponent's units
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        const float m_new = fmaxf(m[hr], mx[hr]);  // finite: key j * KT < nk
        if constexpr (FOLD) {
          alpha[hr] = ex2((m[hr] - m_new) * s2);
          ms[hr] = m_new * s2;
        } else {
          alpha[hr] = ex2(m[hr] - m_new);
          ms[hr] = m_new;
        }
        m[hr] = m_new;
        l[hr] *= alpha[hr];  // this thread's share of the row; summed over the quad at the end
        if constexpr (STATS) lb[hr] *= alpha[hr];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hr = (i >> 1) & 1;
        s[i] = ex2(FOLD ? fmaf(s[i], s2, -ms[hr]) : s[i] - ms[hr]);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) l[i & 1] += s[2 * i] + s[2 * i + 1];
    };
    // O rescaled by how far the rows' max rose (before the tile's P V).
    auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int hb = 0; hb < HB; ++hb)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[hb][i] *= alpha[(i >> 1) & 1];
    };
    // Once P V of the previous tile is done: the weights rounded to bf16 and
    // packed as the A fragment of the next P V.
    auto pack = [&] {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const __nv_bfloat162 pk = __floats2bfloat162_rn(s[2 * i], s[2 * i + 1]);
        if constexpr (STATS) {
          const float2 pr = __bfloat1622float2(pk);
          lb[i & 1] += pr.x + pr.y;
        }
        p[i] = *reinterpret_cast<const uint32_t*>(&pk);
      }
    };

    mbar_wait(&qf[buf], (n >> 1) & 1);
    if (work) {
      float alpha[2];
      mbar_wait(&kv_full[0], 0);
      wgmma_fence();
      issue_scores<HD>(s, qs, Ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      if (full_tiles > 0)  // nothing in flight: the branch costs the pipeline nothing
        softmax(0, alpha, std::false_type{});
      else
        softmax(0, alpha, std::true_type{});
      pack();
      // Key tile j: S_j and P_{j-1} V_{j-1} in flight, the softmax of S_j
      // beside P V. The full tiles and the masked ones run in loops of their
      // own: a branch between the two waits makes ptxas wait for P V where
      // the paths join.
      auto step = [&](int j, auto masked) {
        mbar_wait(&kv_full[j], 0);
        wgmma_fence();
        issue_scores<HD>(s, qs, Ks + j * HT);  // S_j
        wgmma_commit();
        fence_acc(o);  // O's rescale runs beside S_j
        rescale(alpha);
        wgmma_fence();
        issue_reg_times_head(o, p, Vs + (j - 1) * HT);  // O += P_{j-1} V_{j-1}
        wgmma_commit();
        wgmma_wait<1>();  // S_j; P V runs on beside the softmax
        fence_regs(s);
        softmax(j, alpha, masked);
        wgmma_wait<0>();
        fence_acc(o);
        fence_regs(p);
        pack();
      };
      const int split = max(1, min(full_tiles, nt));  // tiles [1, split) full, [split, nt) masked
      for (int j = 1; j < split; ++j) step(j, std::false_type{});
      for (int j = split; j < nt; ++j) step(j, std::true_type{});
      rescale(alpha);
      wgmma_fence();
      issue_reg_times_head(o, p, Vs + (nt - 1) * HT);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      fence_regs(p);
    }

    // Every product that read this Q buffer is done in all four warps:
    // refill it with the warpgroup's item after next.
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (t == 0 && item + 2 * NC < last) load_q(item + 2 * NC, buf);
    if (!work) continue;
    if constexpr (CHUNKED) {
      if (!last_chunk) {  // the walk goes on in the next chunk: leave it the state
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int qi = row[hr];
          if (qi >= Sq) continue;
          st_state[(st_row + qi) * 4 + (lane & 3)] = make_float4(m[hr], l[hr], lb[hr], 0.0f);
          float* os = o_state + (long long)b * o_bs + (long long)qi * o_rs + col0 + 2 * (lane & 3);
#pragma unroll
          for (int c = 0; c < HD / 8; ++c)
            *reinterpret_cast<float2*>(os + 8 * c) =
                make_float2(VF_ACC(o, c, hr, 0), VF_ACC(o, c, hr, 1));
        }
        continue;
      }
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
      if constexpr (STATS) {
        lb[hr] += __shfl_xor_sync(0xffffffffu, lb[hr], 1);
        lb[hr] += __shfl_xor_sync(0xffffffffu, lb[hr], 2);
      }
      const int qi = row[hr];
      if (qi >= Sq) continue;  // the ragged last tile: zero-filled Q, not stored
      const float inv = 1.0f / l[hr];
      const long long off =
          (long long)b * o_bs + (long long)qi * o_rs + col0 + 2 * (lane & 3);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        const float v0 = VF_ACC(o, c, hr, 0), v1 = VF_ACC(o, c, hr, 1);
        *reinterpret_cast<__nv_bfloat162*>(out + off + 8 * c) =
            __floats2bfloat162_rn(v0 * inv, v1 * inv);
        if (STATS && out32)
          *reinterpret_cast<float2*>(out32 + off + 8 * c) = make_float2(v0 / lb[hr], v1 / lb[hr]);
      }
      // A row with no valid key has m = MASK_VALUE, not a base-2 score.
      if (STATS && lse && (lane & 3) == 0)
        lse[((long long)b * H + h) * Sq + qi] =
            (m[hr] == MASK_VALUE ? m[hr] : m[hr] * LN2) + logf(l[hr]);
    }
  }

  // No TMA load may still be landing in shared memory when the block ends.
  if (tid == 0)
    for (int j = 0; j < tiles; ++j) mbar_wait(&kv_full[j], 0);
}

struct Args {
  CUtensorMap mq, mk, mv;
  vf::bf16* out;
  long long o_bs, o_rs;
  int B, H, Sq, Sk;
  const int* kv_len;
  int len_div, kv_div;
  const float* slopes;
  float scale;
  float *lse, *out32;
  int splits, per_split, chunks, chunk_keys;
  float* o_state;
  float4* st_state;
};

template <int HD, int NC, bool CHUNKED, bool ALIBI, bool STATS>
int launch(const Args& a, int k0, cudaStream_t stream) {
  const int bytes = smem_bytes((a.chunk_keys + KT - 1) / KT, NC, head_boxes(HD));
  static int configured = 0;  // the dynamic shared memory this instantiation may take
  if (configured < bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_sm90_kernel<HD, NC, CHUNKED, ALIBI, STATS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = bytes;
  }
  const dim3 grid(a.splits, a.H, a.B / a.kv_div);
  attention_sm90_kernel<HD, NC, CHUNKED, ALIBI, STATS><<<grid, 128 * NC, bytes, stream>>>(
      a.mq, a.mk, a.mv, a.out, a.o_bs, a.o_rs, a.Sq, a.Sk, a.kv_len, a.len_div, a.kv_div,
      a.slopes, a.scale, a.lse, a.out32, a.per_split, k0, a.chunk_keys, a.o_state, a.st_state);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the call's variant (ALiBi where slopes are given, the
// statistics where lse and out32 are wanted), or one chunked launch a key
// chunk in key order.
template <int HD, int NC>
int launch_chunks(const Args& a, cudaStream_t stream) {
  if (a.chunks == 1) {
    if (a.slopes)
      return a.lse ? launch<HD, NC, false, true, true>(a, 0, stream)
                   : launch<HD, NC, false, true, false>(a, 0, stream);
    return a.lse ? launch<HD, NC, false, false, true>(a, 0, stream)
                 : launch<HD, NC, false, false, false>(a, 0, stream);
  }
  for (int c = 0; c < a.chunks; ++c)
    if (int err = launch<HD, NC, true, true, true>(a, c * a.chunk_keys, stream)) return err;
  return 0;
}

// Head dim 128 runs two consumer warpgroups only (four would leave no room
// for K and V).
template <int HD>
int launch_hd(int consumers, const Args& a, cudaStream_t stream) {
  if constexpr (HD <= 64)
    if (consumers == 4) return launch_chunks<HD, 4>(a, stream);
  return launch_chunks<HD, 2>(a, stream);
}

}  // namespace

// q [B, Sq, H*hd], k and v [B / kv_div, Sk, H*hd] with the strides given (in
// elements; multiples of 8, bases 16-byte aligned), out [B, Sq, H*hd] bf16.
// lse: null, or [B, H, Sq] f32 receiving each row's log-sum-exp of its
// (scaled, biased, masked) scores; out32: null, or the f32 output with the
// rounded weights renormalised, with out's strides. Both for the backward
// (csrc/attention_bwd_sm90.cu): both null (serving) or both given (the
// statistics variant). splits, per_split, consumers (blocks per K/V
// row and head, work items of a block, consumer warpgroups of a block: 2 or
// 4, 2 at head dim 128), chunks and chunk_keys (launches along the keys, keys of each: Sk for
// one, else a multiple of 64 whose tiles fit MAX_KV_TILES) come from the
// launch plan. With chunks > 1, o_state (f32, out's shape and strides) and
// st_state ([B, H, Sq, 4, 4] f32) carry the walk from chunk to chunk.
// Returns cudaErrorInvalidValue when a tensor map cannot be made or the
// shape or the plan is not one the kernel takes.
extern "C" int vf_attention(const void* q, const void* k, const void* v, void* out,
                            long long q_bs, long long q_rs, long long kv_bs, long long kv_rs,
                            long long o_bs, long long o_rs, int B, int H, int Sq, int Sk,
                            int head_dim, const void* kv_len, int len_div, int kv_div,
                            const void* slopes, float scale, void* lse, void* out32,
                            int splits, int per_split, int consumers, int chunks,
                            int chunk_keys, void* o_state, void* st_state, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long items = static_cast<long long>(kv_div) * ((Sq + BQ - 1) / BQ);
  const int width = H * head_dim;
  const bool chunks_ok =
      chunks == 1 ? chunk_keys == Sk
                  : chunk_keys % KT == 0 && o_state && st_state &&
                        static_cast<long long>(chunks - 1) * chunk_keys < Sk &&
                        static_cast<long long>(chunks) * chunk_keys >= Sk;
  Args a;
  const bool ok =
      (head_dim == 48 || head_dim == 64 || head_dim == 128) &&
      (consumers == 2 || (consumers == 4 && head_dim <= 64)) && Sk >= 1 && !lse == !out32 &&
      chunks >= 1 && chunk_keys >= 1 && chunks_ok && chunk_keys <= MAX_KV_TILES * KT &&
      smem_bytes((chunk_keys + KT - 1) / KT, consumers, head_boxes(head_dim)) <= 232448 &&
      kv_div >= 1 && B % kv_div == 0 && splits >= 1 && per_split >= 1 &&
      static_cast<long long>(splits - 1) * per_split < items &&
      static_cast<long long>(splits) * per_split >= items &&
      make_map_rows_sw128(&a.mq, q, B, Sq, width, q_rs, q_bs) &&
      make_map_rows_sw128(&a.mk, k, B / kv_div, Sk, width, kv_rs, kv_bs) &&
      make_map_rows_sw128(&a.mv, v, B / kv_div, Sk, width, kv_rs, kv_bs);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  a.out = static_cast<vf::bf16*>(out);
  a.o_bs = o_bs;
  a.o_rs = o_rs;
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.kv_len = static_cast<const int*>(kv_len);
  a.len_div = len_div;
  a.kv_div = kv_div;
  a.slopes = static_cast<const float*>(slopes);
  a.scale = scale;
  a.lse = static_cast<float*>(lse);
  a.out32 = static_cast<float*>(out32);
  a.splits = splits;
  a.per_split = per_split;
  a.chunks = chunks;
  a.chunk_keys = chunk_keys;
  a.o_state = static_cast<float*>(o_state);
  a.st_state = static_cast<float4*>(st_state);
  if (head_dim == 128) return launch_hd<128>(consumers, a, s);
  if (head_dim == 64) return launch_hd<64>(consumers, a, s);
  return launch_hd<48>(consumers, a, s);
}

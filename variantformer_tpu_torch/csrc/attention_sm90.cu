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
// Bound on the H100 by bytes at every main-path shape (S <= 384, head_dim
// 48 or 64: ~0.03 ms of tensor-core work against 0.08-0.28 ms to read q,
// k, v and write out once). The kernel it replaces (wmma, scores and the
// output accumulator round-tripping through shared memory, a per-row warp
// softmax) ran at 17-30x that bound and re-read each K/V head once per
// 64-query tile, and for the cross-attention once per tissue too. Design:
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
//     item ahead) and runs, per key tile, S = Q K^T as wgmma m64n64k16 from
//     shared memory (K-major both; head dim 48 is three k16 steps over the
//     64-wide box, 64 is four), the online softmax in registers on the
//     accumulator layout (base 2; a row's max and sums over the 4 lanes of
//     a quad; ALiBi and the masks from each element's row and key index,
//     the masks only on a row's last tiles), then O += P V as wgmma with P
//     as the A fragment in registers (the f32 scores pack pairwise into it)
//     and V as an MN-major B. The score product of the next key tile is
//     issued behind P V; the last tile is peeled off the loop, so no wgmma
//     sits behind a branch. O stays in registers; the epilogue writes bf16
//     out (and out32, lse) straight from them. P V runs 64 columns wide: at
//     head dim 48 the last 16 are the next head's (or zero-filled) and are
//     dropped.
// 64-key tiles keep one instruction shape for the three uses and 32 score
// registers a thread (128 registers, no spills), so two blocks of two
// warpgroups share an SM where K and V fit in 64 KB (Sk <= 256).
//
// Past MAX_KV_TILES * 64 = 768 keys (a gene with more CREs; the JAX package
// takes any count) K and V no longer fit: the launch plan cuts the keys into
// chunks of at most 768 and the kernel runs once per chunk, in key order
// (the CHUNKED instantiation). A launch loads only its chunk's tiles (the
// tensor map's row coordinate offset by k0), takes ALiBi and the masks at the
// absolute key index, and for each item resumes the online softmax from the
// state the previous chunk left: the f32 O in out's layout, and per row and
// lane of a quad the running max and the two sums (float4). An item whose
// valid keys end before the chunk is skipped; the chunk holding its last
// valid key writes out, out32 and lse as the one-chunk kernel does, the
// others write the state. Carried in f32, the state makes the chunked walk
// the same arithmetic as one walk over all keys: the same bits.

#include "attention_tiles.cuh"

namespace {

using namespace vf::attn;

// K tiles, V tiles, two Q buffers per consumer warpgroup, then the barriers.
constexpr int smem_bytes(int kv_tiles, int consumers) {
  return 1024 + (2 * kv_tiles + 2 * consumers) * TILE_BYTES + 8 * (MAX_KV_TILES + 2 * consumers);
}

// Accumulator i of a consumer thread (warp w of its warpgroup, lane l), for
// the scores and for O alike: row 16 w + l / 4 + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (l % 4) + (i & 1). The wgmma A fragment of k16 step kk
// holds, in register r, columns 16 kk + 8 (r >> 1) + 2 (l % 4) + {0, 1} of
// row 16 w + l / 4 + 8 (r & 1): the score pair (8 kk + 2 r, 8 kk + 2 r + 1).
//
// The softmax runs in base 2: the scores are scaled by scale * log2(e) and
// the ALiBi slope by log2(e), so each weight is one ex2; m is kept in that
// base and converted back for the log-sum-exp.
//
// k0 and ck: the chunk's first key and its key count (a multiple of KT; the
// one-chunk launch passes 0 and Sk). o_state and st_state: the walk's state
// between chunks (CHUNKED only).
template <int HD, int NC, bool CHUNKED>
__global__ void __launch_bounds__(128 * NC, 4 / NC)
attention_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, vf::bf16* __restrict__ out,
                      long long o_bs, long long o_rs, int Sq, int Sk,
                      const int* __restrict__ kv_len, int len_div, int kv_div,
                      const float* __restrict__ slopes, float scale, float* __restrict__ lse,
                      float* __restrict__ out32, int per_split, int k0, int ck,
                      float* __restrict__ o_state, float4* __restrict__ st_state) {
  extern __shared__ unsigned char raw[];
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  const int kv_tiles = (ck + KT - 1) / KT;
  vf::bf16* Ks = reinterpret_cast<vf::bf16*>(base);
  vf::bf16* Vs = Ks + kv_tiles * TILE_ELEMS;
  vf::bf16* Qs = Vs + kv_tiles * TILE_ELEMS;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Qs + 2 * NC * TILE_ELEMS);
  uint64_t* q_full = kv_full + MAX_KV_TILES;

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128, warp = t / 32, lane = tid % 32;
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

  vf::bf16* Qw = Qs + wg * 2 * TILE_ELEMS;
  uint64_t* qf = q_full + 2 * wg;
  auto load_q = [&](int item, int buf) {
    const int b = r * kv_div + item / q_tiles;
    mbar_arrive_tx(&qf[buf], TILE_BYTES);
    tma_load_3d(Qw + buf * TILE_ELEMS, &map_q, &qf[buf], col0, (item % q_tiles) * BQ, b);
  };
  if (tid == 0) {
    for (int j = 0; j < tiles; ++j) {
      mbar_arrive_tx(&kv_full[j], 2 * TILE_BYTES);
      tma_load_3d(Ks + j * TILE_ELEMS, &map_k, &kv_full[j], col0, k0 + j * KT, r);
      tma_load_3d(Vs + j * TILE_ELEMS, &map_v, &kv_full[j], col0, k0 + j * KT, r);
    }
  }
  if (t == 0) {
    for (int n = 0; n < 2; ++n)
      if (first + wg + n * NC < last) load_q(first + wg + n * NC, n);
  }

  const float s2 = scale * LOG2E;                          // score scale, base 2
  const float a2 = (slopes ? slopes[h] : 0.0f) * LOG2E;    // ALiBi slope, base 2
  int n = 0;
  for (int item = first + wg; item < last; item += NC, ++n) {
    const int buf = n & 1;
    const int b = r * kv_div + item / q_tiles;
    const int q0 = (item % q_tiles) * BQ;
    const int len = kv_len[b / len_div];
    const int nk = keys_of(len, Sk);
    const int nt = (min(nk - k0, ck) + KT - 1) / KT;       // the chunk's tiles of the walk
    const int full_tiles = len > 0 ? nk / KT - k0 / KT : 0;  // of those, tiles with every key valid
    const bool work = !CHUNKED || nt > 0;                  // uniform over the warpgroup
    const bool last_chunk = !CHUNKED || nk <= k0 + ck;
    const int row[2] = {q0 + 16 * warp + (lane >> 2), q0 + 16 * warp + (lane >> 2) + 8};
    const vf::bf16* qs = Qw + buf * TILE_ELEMS;
    const long long st_row = ((long long)b * H + h) * Sq;  // this row's (max, sums) per quad lane

    float s[32], o[32];
    uint32_t p[16];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, lb[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    if constexpr (CHUNKED) {
      if (work && k0 > 0) {  // resume the walk where the previous chunk left it
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int qi = row[hr];
          if (qi >= Sq) continue;
          const float4 st = st_state[(st_row + qi) * 4 + (lane & 3)];
          m[hr] = st.x;
          l[hr] = st.y;
          lb[hr] = st.z;
          const float* os = o_state + (long long)b * o_bs + (long long)qi * o_rs + col0 +
                            2 * (lane & 3);
#pragma unroll
          for (int c = 0; c < HD / 8; ++c) {
            const float2 v = *reinterpret_cast<const float2*>(os + 8 * c);
            o[4 * c + 2 * hr] = v.x;
            o[4 * c + 2 * hr + 1] = v.y;
          }
        }
      }
    }

    // One key tile: the softmax of its scores S_j (issued before), then
    // O += P V_j (issued, not waited for).
    auto softmax_pv = [&](int j) {
      wgmma_wait<0>();  // S_j, and P V of the previous tile
      fence_regs(s);
      fence_regs(o);
      fence_regs(p);
      // Scale, bias and mask the tile's scores; the rows' running max.
      const int kb = k0 + j * KT + 2 * (lane & 3);
      float mx[2] = {-INFINITY, -INFINITY};
      if (j < full_tiles) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hr = (i >> 1) & 1;
          const int key = kb + 8 * (i >> 2) + (i & 1);
          s[i] = s[i] * s2 - a2 * fabsf(static_cast<float>(row[hr] - key));
          mx[hr] = fmaxf(mx[hr], s[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int hr = (i >> 1) & 1;
          const int key = kb + 8 * (i >> 2) + (i & 1);
          // past the walk's keys: weight exactly 0
          const float x = key >= nk    ? -INFINITY
                          : key >= len ? MASK_VALUE
                                       : s[i] * s2 - a2 * fabsf(static_cast<float>(row[hr] - key));
          s[i] = x;
          mx[hr] = fmaxf(mx[hr], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
        mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
        const float m_new = fmaxf(m[hr], mx[hr]);  // finite: key j * KT < nk
        alpha[hr] = ex2(m[hr] - m_new);
        m[hr] = m_new;
        l[hr] *= alpha[hr];  // this thread's share of the row; summed over the quad at the end
        lb[hr] *= alpha[hr];
      }
      // P = 2^(s - m), rounded to bf16 and packed as the A fragment.
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int hr = i & 1;
        const float p0 = ex2(s[2 * i] - m[hr]), p1 = ex2(s[2 * i + 1] - m[hr]);
        const __nv_bfloat162 pk = __floats2bfloat162_rn(p0, p1);
        const float2 pr = __bfloat1622float2(pk);
        l[hr] += p0 + p1;
        lb[hr] += pr.x + pr.y;
        p[i] = *reinterpret_cast<const uint32_t*>(&pk);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];

      wgmma_fence();
      issue_reg_times_box(o, p, Vs + j * TILE_ELEMS);
      wgmma_commit();
    };

    mbar_wait(&qf[buf], (n >> 1) & 1);
    if (work) {
      mbar_wait(&kv_full[0], 0);
      wgmma_fence();
      issue_scores<HD>(s, qs, Ks);
      wgmma_commit();
      // The last tile is peeled off, so that every wgmma is issued on a path
      // all four warps take (ptxas serialises wgmma behind a branch).
      for (int j = 0; j + 1 < nt; ++j) {
        softmax_pv(j);
        mbar_wait(&kv_full[j + 1], 0);
        issue_scores<HD>(s, qs, Ks + (j + 1) * TILE_ELEMS);  // behind P V_j
        wgmma_commit();
      }
      softmax_pv(nt - 1);
      wgmma_wait<0>();
      fence_regs(o);
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
                make_float2(o[4 * c + 2 * hr], o[4 * c + 2 * hr + 1]);
        }
        continue;
      }
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
      l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
      lb[hr] += __shfl_xor_sync(0xffffffffu, lb[hr], 1);
      lb[hr] += __shfl_xor_sync(0xffffffffu, lb[hr], 2);
      const int qi = row[hr];
      if (qi >= Sq) continue;  // the ragged last tile: zero-filled Q, not stored
      const float inv = 1.0f / l[hr];
      const long long off =
          (long long)b * o_bs + (long long)qi * o_rs + col0 + 2 * (lane & 3);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        const float v0 = o[4 * c + 2 * hr], v1 = o[4 * c + 2 * hr + 1];
        *reinterpret_cast<__nv_bfloat162*>(out + off + 8 * c) =
            __floats2bfloat162_rn(v0 * inv, v1 * inv);
        if (out32)
          *reinterpret_cast<float2*>(out32 + off + 8 * c) = make_float2(v0 / lb[hr], v1 / lb[hr]);
      }
      // A row with no valid key has m = MASK_VALUE, not a base-2 score.
      if (lse && (lane & 3) == 0)
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

template <int HD, int NC, bool CHUNKED>
int launch(const Args& a, int k0, cudaStream_t stream) {
  const int bytes = smem_bytes((a.chunk_keys + KT - 1) / KT, NC);
  static int configured = 0;  // the dynamic shared memory this instantiation may take
  if (configured < bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        attention_sm90_kernel<HD, NC, CHUNKED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = bytes;
  }
  const dim3 grid(a.splits, a.H, a.B / a.kv_div);
  attention_sm90_kernel<HD, NC, CHUNKED><<<grid, 128 * NC, bytes, stream>>>(
      a.mq, a.mk, a.mv, a.out, a.o_bs, a.o_rs, a.Sq, a.Sk, a.kv_len, a.len_div, a.kv_div,
      a.slopes, a.scale, a.lse, a.out32, a.per_split, k0, a.chunk_keys, a.o_state, a.st_state);
  return static_cast<int>(cudaGetLastError());
}

// One launch, or one a key chunk in key order.
template <int HD, int NC>
int launch_chunks(const Args& a, cudaStream_t stream) {
  if (a.chunks == 1) return launch<HD, NC, false>(a, 0, stream);
  for (int c = 0; c < a.chunks; ++c)
    if (int err = launch<HD, NC, true>(a, c * a.chunk_keys, stream)) return err;
  return 0;
}

template <int HD>
int launch_hd(int consumers, const Args& a, cudaStream_t stream) {
  if (consumers == 4) return launch_chunks<HD, 4>(a, stream);
  return launch_chunks<HD, 2>(a, stream);
}

}  // namespace

// q [B, Sq, H*hd], k and v [B / kv_div, Sk, H*hd] with the strides given (in
// elements; multiples of 8, bases 16-byte aligned), out [B, Sq, H*hd] bf16.
// lse: null, or [B, H, Sq] f32 receiving each row's log-sum-exp of its
// (scaled, biased, masked) scores; out32: null, or the f32 output with the
// rounded weights renormalised, with out's strides. Both for the backward
// (csrc/attention_bwd_sm90.cu). splits, per_split, consumers (blocks per K/V
// row and head, work items of a block, consumer warpgroups of a block: 2 or
// 4), chunks and chunk_keys (launches along the keys, keys of each: Sk for
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
      (head_dim == 48 || head_dim == 64) && (consumers == 2 || consumers == 4) && Sk >= 1 &&
      chunks >= 1 && chunk_keys >= 1 && chunks_ok && chunk_keys <= MAX_KV_TILES * KT &&
      smem_bytes((chunk_keys + KT - 1) / KT, consumers) <= 232448 &&
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
  if (head_dim == 64) return launch_hd<64>(consumers, a, s);
  return launch_hd<48>(consumers, a, s);
}

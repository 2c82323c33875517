// attention_bwd_sm90: backward of the masked (ALiBi) softmax attention of
// attention_sm90.cu, written for Hopper (TMA, mbarriers, wgmma), with the
// forward's conventions: query row b reads K/V row b / kv_div and
// kv_len[b / len_div]; keys at or past kv_len weigh 0 and get exactly 0; a
// row with kv_len = 0 averages V over all Sk keys, so its probabilities are
// 1/Sk and its score gradient is 0; the K/V cotangent of a K/V row is summed
// over the kv_div query rows that share it.
//
// Replaces the attention backward inside the Pallas recompute kernels
// (variantformer_tpu/ops/fused_encoder.py:_bwd_kernel, the per-head loop;
// variantformer_tpu/ops/fused_modulator.py:_bwd1_kernel l.769-803, the
// cross-attention, and the self-attention loop of _bwd0_kernel). With
// P = exp(s - lse) rebuilt from the forward's log-sum-exp, dO the output
// cotangent and delta_i = sum_d dO_id O_id:
//   dV = P^T dO,  dS = bf16(P * (dO V^T - delta) * scale),
//   dQ = dS K,    dK = dS^T Q.
// delta is taken from the forward's f32 output with its bf16 weights
// renormalised (out32): where the weights are nearly uniform dP - delta is
// a small difference of large terms, which a bf16 O would swamp.
//
// Bound on the H100 by bytes at every main-path shape (gene self-attention:
// 7.15e10 operations, 0.072 ms at the bf16 peak, against ~1 GB read and
// written once, 0.32 ms). The wmma kernel this replaces ran at 11-40x that
// bound: 16x16 wmma tiles whose scores, dP and dS round-tripped through
// shared memory, hand-loaded tiles without prefetch, and the cross-
// attention's dK/dV walked by one block per (64 keys, head, gene): 54
// tissues x 4 query tiles in series on 64-384 blocks. Four launches, all
// deterministic (no atomics; every sum in a fixed order):
//   prep   delta from out32 and dO (coalesced reads of whole rows, per-head
//          sums through shared memory), and the log-sum-exp in base 2, into
//          `lse_delta` [B, H, q_tiles, 2, 64] f32 (0 past Sq), so that one
//          512-byte bulk copy brings a query tile's lse and delta into
//          shared memory.
//   dK/dV  keys as the wgmma M (the FlashAttention-3 backward's layout). One
//          block per (K/V row r, head h, 64 * NC keys, split): thread 0 of
//          a producer warp TMA-loads the block's K and V tiles once, then
//          streams the block's (query row, query tile) items through a
//          3-stage ring (Q and dO boxes and the lse_delta chunk on one mbarrier
//          a stage, freed by an mbarrier the consumer warps arrive on). NC
//          consumer warpgroups (2; 1 when Sk <= 64), one 64-key tile each,
//          run per item S^T = K Q^T and dP^T = V dO^T (K-major x K-major,
//          the forward's score form), rebuild P^T and dS^T in registers on
//          the accumulator layout (lse and delta per column, read from the
//          stage's lse_delta; ALiBi and the masks from each element's key row
//          and query column), pack them into A fragments and run dV += P^T
//          dO and dK += dS^T Q (register A x MN-major B, the forward's P V
//          form). dK and dV stay in registers and are written once, in bf16
//          or f32, or, where the launch plan splits a group's items over
//          blocks (ops/kernels.py attention_bwd_plan: the cross-attention,
//          whose 54 tissues x 4 query tiles per gene and head would
//          otherwise run in series on a few hundred blocks), as f32 partials
//          [splits, B / kv_div, Sk, 2 H hd] that
//   sum    adds in split order into dk and dv.
//   dQ     queries as M, the forward's structure with two score products.
//          One block per (K/V row, head, split) holds that head's K and V
//          whole (one mbarrier a tile); two consumer warpgroups take
//          alternate items, each double-buffering its Q, dO and lse_delta (TMA,
//          prefetched one item ahead), and walk the key tiles up to the
//          last valid key with S = Q K^T and dP = dO V^T on wgmma, dS in
//          registers and dQ += dS K (dS as the A fragment, K as an MN-major
//          B), the next tile's products issued behind it and the last tile
//          peeled off the loop; dQ is written in bf16 from the registers.
//          Launch plan: attention_plan's splitting with two consumers.
//          K, V and four Q/dO buffers fit 227 KB up to 576 keys; past that
//          (a gene with more CREs) the plan cuts the keys into chunks of at
//          most 576 and the pass runs once per chunk, in key order (the
//          CHUNKED instantiation): each launch loads its chunk's K and V,
//          takes ALiBi and the masks at the absolute key index, and resumes
//          an item's f32 dQ from the state the previous chunk left in
//          `dq_state`; the chunk holding the item's last valid key writes dq
//          in bf16. The f32 accumulator carried through memory makes the
//          chunked pass the same sum, in the same order, as one walk.
// At head dim 48 the boxes are 64 wide and the last 16 columns of every
// MN-major product are dropped, as in the forward. The dK/dV pass holds at
// most two key tiles a block and takes any Sk.
// Head dim 128 (encoder heads of 65-128, zero-padded to 128 lanes): every
// head tile is two 64-column TMA boxes side by side, the K-major products
// walk both (eight k16 steps) and each MN-major product is one a box into
// its own 64-column accumulator, as in the forward. dK and dV take 128 f32
// registers a thread: with two consumer warpgroups and the producer warp
// (288 threads) ptxas gives 168 registers and spills ~1 KB, so a dK/dV block
// takes one consumer warpgroup there (231 registers, no spill). A dQ
// block's Q/dO buffers are twice the bytes, so it takes
// VF_ATTN_BWD_DQ_CONSUMERS_WIDE warpgroups (its K and V then fit up to 320
// keys, the plan's ATTN_BWD_MAX_KEYS_WIDE).

#include "attention_tiles.cuh"

// The ring depth and the dQ pass's warpgroups come from ops/kernels.py,
// whose launch plan reads the same values (ATTN_BWD_STAGES,
// ATTN_BWD_DQ_CONSUMERS, ATTN_BWD_DQ_CONSUMERS_WIDE).
#if !defined(VF_ATTN_BWD_STAGES) || !defined(VF_ATTN_BWD_DQ_CONSUMERS) || \
    !defined(VF_ATTN_BWD_DQ_CONSUMERS_WIDE)
#error "build through ops/kernels.py, which defines VF_ATTN_BWD_STAGES and VF_ATTN_BWD_DQ_CONSUMERS(_WIDE)"
#endif

namespace {

using namespace vf::attn;

constexpr int STAGES = VF_ATTN_BWD_STAGES;  // dK/dV pass: items in flight
constexpr int STAT_FLOATS = 2 * BQ;        // a query tile's lse (base 2), then delta
constexpr int STAT_BYTES = 4 * STAT_FLOATS;
// An item's Q and dO head tiles (`boxes` boxes each) and its lse_delta chunk.
__host__ __device__ constexpr int item_bytes(int boxes) {
  return 2 * boxes * TILE_BYTES + STAT_BYTES;
}
// Consumer warpgroups of a dQ block: head dims up to 64, and 128.
__host__ __device__ constexpr int dq_consumers(int hd) {
  return hd > 64 ? VF_ATTN_BWD_DQ_CONSUMERS_WIDE : VF_ATTN_BWD_DQ_CONSUMERS;
}
constexpr int SMEM_LIMIT = 232448;
constexpr int PREP_ROWS = 32;     // queries of a prep block
constexpr int PREP_THREADS = 256;
constexpr int PREP_UNROLL = 4;    // 16-byte chunks of O and dO in flight a thread

constexpr int prep_smem_bytes(int width) { return 4 * PREP_ROWS * (width / 8 + 1); }

constexpr int dkv_smem_bytes(int nc, int boxes) {
  return 1024 + (2 * nc + 2 * STAGES) * boxes * TILE_BYTES + STAGES * STAT_BYTES +
         8 * (1 + 2 * STAGES);
}

constexpr int dq_smem_bytes(int kv_tiles, int nc, int boxes) {
  return 1024 + (2 * kv_tiles + 4 * nc) * boxes * TILE_BYTES + 2 * nc * STAT_BYTES +
         8 * (MAX_KV_TILES + 2 * nc);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(vf::bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(vf::bf16* p, float a) { *p = __float2bfloat16_rn(a); }

// lse_delta[((b * H + h) * q_tiles + t) * 128 + c]: for c < 64 the log-sum-exp
// (times log2 e) of query t * 64 + c, for c >= 64 its delta; 0 past Sq. A
// block takes PREP_ROWS queries of one row b. First its threads walk those
// queries' O (f32) and dO rows in 8-element chunks, consecutive threads on
// consecutive chunks (coalesced 16-byte loads, PREP_UNROLL chunks in flight a
// thread), and leave each chunk's dot product in shared memory (rows padded
// by one float, so the second phase reads without bank conflicts). Then one
// thread per (head, query), the query fastest, adds its head's chunks, so
// that a warp's reads of lse and writes of lse_delta are contiguous.
template <int HD>
__global__ void __launch_bounds__(PREP_THREADS)
attn_bwd_prep_kernel(const float* __restrict__ o, const vf::bf16* __restrict__ d_o,
                     const float* __restrict__ lse, float* __restrict__ lse_delta, long long o_bs,
                     long long o_rs, long long do_bs, long long do_rs, int H, int Sq,
                     int q_tiles) {
  extern __shared__ float dots[];  // [PREP_ROWS][H * HD / 8 + 1]
  const int chunks = H * HD / 8, pitch = chunks + 1;
  const int per_row = q_tiles * (BQ / PREP_ROWS);
  const int b = blockIdx.x / per_row;
  const int q0 = (blockIdx.x % per_row) * PREP_ROWS;
  const int rows = max(0, min(PREP_ROWS, Sq - q0));
  const int n = rows * chunks;
  const float* ob = o + b * o_bs + q0 * o_rs;
  const vf::bf16* db = d_o + b * do_bs + q0 * do_rs;
  for (int i0 = threadIdx.x; i0 < n; i0 += PREP_UNROLL * PREP_THREADS) {
    float4 x[PREP_UNROLL][2];
    uint4 g[PREP_UNROLL];
#pragma unroll
    for (int u = 0; u < PREP_UNROLL; ++u) {
      const int i = i0 + u * PREP_THREADS;
      if (i < n) {
        const int r = i / chunks, c = i - r * chunks;
        const float4* op = reinterpret_cast<const float4*>(ob + r * o_rs + 8 * c);
        x[u][0] = op[0];
        x[u][1] = op[1];
        g[u] = *reinterpret_cast<const uint4*>(db + r * do_rs + 8 * c);
      }
    }
#pragma unroll
    for (int u = 0; u < PREP_UNROLL; ++u) {
      const int i = i0 + u * PREP_THREADS;
      if (i < n) {
        const int r = i / chunks, c = i - r * chunks;
        float y[8];
        vf::unpack8(g[u], y);
        const float4 x0 = x[u][0], x1 = x[u][1];
        dots[r * pitch + c] = x0.x * y[0] + x0.y * y[1] + x0.z * y[2] + x0.w * y[3] +
                              x1.x * y[4] + x1.y * y[5] + x1.z * y[6] + x1.w * y[7];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < H * PREP_ROWS; i += PREP_THREADS) {
    const int h = i / PREP_ROWS, r = i % PREP_ROWS, qi = q0 + r;
    float acc = 0.0f, l2 = 0.0f;
    if (r < rows) {
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) acc += dots[r * pitch + h * (HD / 8) + c];
      l2 = lse[((long long)b * H + h) * Sq + qi] * LOG2E;
    }
    float* st = lse_delta + (((long long)b * H + h) * q_tiles + qi / BQ) * STAT_FLOATS + qi % BQ;
    st[0] = l2;
    st[BQ] = acc;
  }
}

template <int HD, int NC, typename TKV>
__global__ void __launch_bounds__(128 * NC + 32, 1)
attn_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse_delta,
                    float* __restrict__ part, TKV* __restrict__ dk, TKV* __restrict__ dv,
                    long long dkv_bs, long long dkv_rs, int Sq, int Sk,
                    const int* __restrict__ kv_len, int len_div, int kv_div,
                    const float* __restrict__ slopes, float scale, int key_blocks,
                    int per_split) {
  constexpr int HB = head_boxes(HD), HT = HB * TILE_ELEMS;  // a head tile's boxes, elements
  extern __shared__ unsigned char raw[];
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  vf::bf16* Ks = reinterpret_cast<vf::bf16*>(base);
  vf::bf16* Vs = Ks + NC * HT;
  vf::bf16* Qs = Vs + NC * HT;
  vf::bf16* Ds = Qs + STAGES * HT;
  float* St = reinterpret_cast<float*>(Ds + STAGES * HT);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(St + STAGES * STAT_FLOATS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128, warp = t / 32, lane = tid % 32;
  const int kb = blockIdx.x % key_blocks, split = blockIdx.x / key_blocks;
  const int h = blockIdx.y, r = blockIdx.z, H = gridDim.y, R = gridDim.z;
  const int col0 = h * HD;
  const int q_tiles = (Sq + BQ - 1) / BQ;
  const int first = split * per_split;
  const int last = min(kv_div * q_tiles, first + per_split);
  const int key0 = kb * NC * KT;                             // the block's first key
  const int kv_tiles = min(NC, (Sk - key0 + KT - 1) / KT);  // its tiles inside Sk

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == NC) {  // the producer warp
    if (lane == 0) {
      mbar_arrive_tx(kv_full, 2 * kv_tiles * HB * TILE_BYTES);
      for (int c = 0; c < kv_tiles; ++c)
        for (int hb = 0; hb < HB; ++hb) {
          tma_load_3d(Ks + c * HT + hb * TILE_ELEMS, &map_k, kv_full, col0 + 64 * hb,
                      key0 + c * KT, r);
          tma_load_3d(Vs + c * HT + hb * TILE_ELEMS, &map_v, kv_full, col0 + 64 * hb,
                      key0 + c * KT, r);
        }
      int n = 0;
      for (int item = first; item < last; ++item) {
        const int b = r * kv_div + item / q_tiles, qt = item % q_tiles;
        if (key0 >= keys_of(kv_len[b / len_div], Sk)) continue;  // no key of the block is read
        const int s = n % STAGES;
        if (n >= STAGES) mbar_wait(&empty[s], ((n / STAGES) - 1) & 1);
        mbar_arrive_tx(&full[s], item_bytes(HB));
        for (int hb = 0; hb < HB; ++hb) {
          tma_load_3d(Qs + s * HT + hb * TILE_ELEMS, &map_q, &full[s], col0 + 64 * hb, qt * BQ,
                      b);
          tma_load_3d(Ds + s * HT + hb * TILE_ELEMS, &map_do, &full[s], col0 + 64 * hb, qt * BQ,
                      b);
        }
        bulk_load(St + s * STAT_FLOATS,
                  lse_delta + (((long long)b * H + h) * q_tiles + qt) * STAT_FLOATS, STAT_BYTES,
                  &full[s]);
        ++n;
      }
    }
    return;
  }

  const int tile0 = key0 + wg * KT;  // this warpgroup's first key
  const bool has_tile = wg < kv_tiles;
  const vf::bf16* Kw = Ks + wg * HT;
  const vf::bf16* Vw = Vs + wg * HT;
  const float s2 = scale * LOG2E;                        // score scale, base 2
  const float a2 = (slopes ? slopes[h] : 0.0f) * LOG2E;  // ALiBi slope, base 2
  const float inv_sk = 1.0f / static_cast<float>(Sk);
  const int key[2] = {tile0 + 16 * warp + (lane >> 2), tile0 + 16 * warp + (lane >> 2) + 8};
  const int qb = 2 * (lane & 3);

  float dk_acc[HB][32], dv_acc[HB][32];
#pragma unroll
  for (int hb = 0; hb < HB; ++hb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[hb][i] = dv_acc[hb][i] = 0.0f;

  mbar_wait(kv_full, 0);
  int n = 0;
  for (int item = first; item < last; ++item) {
    const int b = r * kv_div + item / q_tiles;
    const int len = kv_len[b / len_div];
    const int nk = keys_of(len, Sk);
    if (key0 >= nk) continue;  // the producer skips it too
    const int s = n % STAGES;
    mbar_wait(&full[s], (n / STAGES) & 1);
    if (has_tile && tile0 < nk) {  // uniform over the warpgroup
      const vf::bf16* qs = Qs + s * HT;
      const vf::bf16* dos = Ds + s * HT;
      const float* st = St + s * STAT_FLOATS;
      const int q0 = (item % q_tiles) * BQ;
      float sc[32], dp[32];
      uint32_t pa[16], da[16];
      wgmma_fence();
      issue_scores<HD>(sc, Kw, qs);   // S^T: 64 keys x 64 queries
      issue_scores<HD>(dp, Vw, dos);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      fence_acc(dk_acc);
      fence_acc(dv_acc);
      // P^T and dS^T, pair i = accumulators (2 i, 2 i + 1): key row key[i & 1],
      // query columns qc and qc + 1.
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int kj = key[i & 1];
        const int qc = 8 * (i >> 1) + qb;
        const bool q_ok0 = q0 + qc < Sq, q_ok1 = q0 + qc + 1 < Sq;
        float p0 = 0.0f, p1 = 0.0f, d0 = 0.0f, d1 = 0.0f;
        if (len == 0) {  // uniform: every query of the item averages V
          p0 = kj < Sk && q_ok0 ? inv_sk : 0.0f;
          p1 = kj < Sk && q_ok1 ? inv_sk : 0.0f;
        } else if (kj < nk) {
          const float2 l2 = *reinterpret_cast<const float2*>(st + qc);
          const float2 dl = *reinterpret_cast<const float2*>(st + BQ + qc);
          const float x0 = sc[2 * i] * s2 - a2 * fabsf(static_cast<float>(q0 + qc - kj)) - l2.x;
          const float x1 =
              sc[2 * i + 1] * s2 - a2 * fabsf(static_cast<float>(q0 + qc + 1 - kj)) - l2.y;
          p0 = q_ok0 ? ex2(x0) : 0.0f;
          p1 = q_ok1 ? ex2(x1) : 0.0f;
          d0 = p0 * (dp[2 * i] - dl.x) * scale;
          d1 = p1 * (dp[2 * i + 1] - dl.y) * scale;
        }
        pa[i] = pack_bf16(p0, p1);
        da[i] = pack_bf16(d0, d1);
      }
      wgmma_fence();
      issue_reg_times_head(dv_acc, pa, dos);  // dV += P^T dO
      issue_reg_times_head(dk_acc, da, qs);   // dK += dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(dk_acc);
      fence_acc(dv_acc);
      fence_regs(pa);
      fence_regs(da);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the warp is done with the stage
    ++n;
  }

  if (!has_tile) return;
  const int E = H * HD;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kj = key[hr];
    if (kj >= Sk) continue;  // zero-filled rows of the last tile: stored nowhere
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const int col = col0 + 8 * c + qb;
      const float k0 = VF_ACC(dk_acc, c, hr, 0), k1 = VF_ACC(dk_acc, c, hr, 1);
      const float v0 = VF_ACC(dv_acc, c, hr, 0), v1 = VF_ACC(dv_acc, c, hr, 1);
      if (part) {
        float* pr = part + (((long long)split * R + r) * Sk + kj) * (2LL * E) + col;
        store2(pr, k0, k1);
        store2(pr + E, v0, v1);
      } else {
        const long long off = (long long)r * dkv_bs + (long long)kj * dkv_rs + col;
        store2(dk + off, k0, k1);
        store2(dv + off, v0, v1);
      }
    }
  }
}

// dk, dv = the split partials summed in split order.
template <typename TKV>
__global__ void attn_bwd_dkv_sum_kernel(const float* __restrict__ part, int splits, int R, int Sk,
                                        int E, TKV* __restrict__ dk, TKV* __restrict__ dv,
                                        long long dkv_bs, long long dkv_rs) {
  const long long n = (long long)R * Sk * 2 * E;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int sp = 0; sp < splits; ++sp) s += part[sp * n + i];
    const int col = static_cast<int>(i % (2 * E));
    const long long row = i / (2 * E);
    const long long off = (row / Sk) * dkv_bs + (row % Sk) * dkv_rs + col % E;
    store1((col < E ? dk : dv) + off, s);
  }
}

// k0 and ck: the chunk's first key and its key count (a multiple of KT; the
// one-chunk launch passes 0 and Sk); dq_state [B, Sq, H * HD] f32: an
// item's dQ between chunks (CHUNKED only).
template <int HD, bool CHUNKED>
__global__ void __launch_bounds__(128 * dq_consumers(HD), 1)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse_delta,
                   vf::bf16* __restrict__ dq, long long dq_bs, long long dq_rs, int Sq, int Sk,
                   const int* __restrict__ kv_len, int len_div, int kv_div,
                   const float* __restrict__ slopes, float scale, int per_split, int k0, int ck,
                   float* __restrict__ dq_state) {
  constexpr int NC = dq_consumers(HD);
  constexpr int HB = head_boxes(HD), HT = HB * TILE_ELEMS;  // a head tile's boxes, elements
  extern __shared__ unsigned char raw[];
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  const int kv_tiles = (ck + KT - 1) / KT;
  vf::bf16* Ks = reinterpret_cast<vf::bf16*>(base);
  vf::bf16* Vs = Ks + kv_tiles * HT;
  vf::bf16* Qs = Vs + kv_tiles * HT;  // two per consumer warpgroup
  vf::bf16* Ds = Qs + 2 * NC * HT;    // the same for dO
  float* St = reinterpret_cast<float*>(Ds + 2 * NC * HT);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(St + 2 * NC * STAT_FLOATS);
  uint64_t* q_full = kv_full + MAX_KV_TILES;

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128, warp = t / 32, lane = tid % 32;
  const int h = blockIdx.y, r = blockIdx.z, H = gridDim.y;
  const int col0 = h * HD;
  const int q_tiles = (Sq + BQ - 1) / BQ;
  const int first = blockIdx.x * per_split;
  const int last = min(kv_div * q_tiles, first + per_split);

  // The keys of the chunk this block's rows need: up to their last valid
  // key; a row with none walks the first tile with dS = 0 (in the first
  // chunk).
  int need = k0 == 0 ? 1 : 0;
  for (int b = r * kv_div + first / q_tiles; b <= r * kv_div + (last - 1) / q_tiles; ++b) {
    const int len = kv_len[b / len_div];
    if (len > 0) need = max(need, min(min(len, Sk) - k0, ck));
  }
  const int tiles = (need + KT - 1) / KT;

  if (tid == 0) {
    for (int j = 0; j < MAX_KV_TILES; ++j) mbar_init(&kv_full[j], 1);
    for (int i = 0; i < 2 * NC; ++i) mbar_init(&q_full[i], 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int slot0 = 2 * wg;  // this warpgroup's two buffers
  uint64_t* qf = q_full + slot0;
  auto load_item = [&](int item, int buf) {
    const int b = r * kv_div + item / q_tiles, qt = item % q_tiles;
    const int slot = slot0 + buf;
    mbar_arrive_tx(&qf[buf], item_bytes(HB));
    for (int hb = 0; hb < HB; ++hb) {
      tma_load_3d(Qs + slot * HT + hb * TILE_ELEMS, &map_q, &qf[buf], col0 + 64 * hb, qt * BQ, b);
      tma_load_3d(Ds + slot * HT + hb * TILE_ELEMS, &map_do, &qf[buf], col0 + 64 * hb, qt * BQ,
                  b);
    }
    bulk_load(St + slot * STAT_FLOATS,
              lse_delta + (((long long)b * H + h) * q_tiles + qt) * STAT_FLOATS, STAT_BYTES, &qf[buf]);
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
      if (first + wg + n * NC < last) load_item(first + wg + n * NC, n);
  }

  const float s2 = scale * LOG2E;
  const float a2 = (slopes ? slopes[h] : 0.0f) * LOG2E;
  const int rl[2] = {16 * warp + (lane >> 2), 16 * warp + (lane >> 2) + 8};  // rows in the tile
  int n = 0;
  for (int item = first + wg; item < last; item += NC, ++n) {
    const int buf = n & 1, slot = slot0 + buf;
    const int b = r * kv_div + item / q_tiles;
    const int q0 = (item % q_tiles) * BQ;
    const int len = kv_len[b / len_div];
    const int nk = len > 0 ? min(len, Sk) : 0;  // valid keys; 0: dS = 0 throughout
    // the chunk's tiles of the walk (the first chunk walks one at least)
    const int nt = max(k0 == 0 ? 1 : 0, (min(nk - k0, ck) + KT - 1) / KT);
    const bool work = !CHUNKED || nt > 0;  // uniform over the warpgroup
    const bool last_chunk = !CHUNKED || nk <= k0 + ck;
    const int row[2] = {q0 + rl[0], q0 + rl[1]};
    const vf::bf16* qs = Qs + slot * HT;
    const vf::bf16* dos = Ds + slot * HT;
    const float* st = St + slot * STAT_FLOATS;
    const int E = gridDim.y * HD;

    float sc[32], dp[32], dq_acc[HB][32];
    uint32_t da[16];
#pragma unroll
    for (int hb = 0; hb < HB; ++hb)
#pragma unroll
      for (int i = 0; i < 32; ++i) dq_acc[hb][i] = 0.0f;
    if constexpr (CHUNKED) {
      if (work && k0 > 0) {  // resume the item's dQ where the previous chunk left it
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if (row[hr] >= Sq) continue;
          const float* ds = dq_state + ((long long)b * Sq + row[hr]) * E + col0 + 2 * (lane & 3);
#pragma unroll
          for (int c = 0; c < HD / 8; ++c) {
            const float2 v = *reinterpret_cast<const float2*>(ds + 8 * c);
            VF_ACC(dq_acc, c, hr, 0) = v.x;
            VF_ACC(dq_acc, c, hr, 1) = v.y;
          }
        }
      }
    }

    mbar_wait(&qf[buf], (n >> 1) & 1);
    const float l2[2] = {st[rl[0]], st[rl[1]]};
    const float dl[2] = {st[BQ + rl[0]], st[BQ + rl[1]]};

    // One key tile: dS from its products S_j, dP_j (issued before), then
    // dQ += dS K_j (issued, not waited for).
    auto ds_step = [&](int j) {
      wgmma_wait<0>();  // S_j, dP_j and the previous tile's dQ product
      fence_regs(sc);
      fence_regs(dp);
      fence_acc(dq_acc);
      fence_regs(da);
      const int kb = k0 + j * KT + 2 * (lane & 3);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int hr = i & 1;
        const int kj = kb + 8 * (i >> 1);
        float d0 = 0.0f, d1 = 0.0f;
        if (kj < nk) {
          const float p = ex2(sc[2 * i] * s2 - a2 * fabsf(static_cast<float>(row[hr] - kj)) - l2[hr]);
          d0 = p * (dp[2 * i] - dl[hr]) * scale;
        }
        if (kj + 1 < nk) {
          const float p =
              ex2(sc[2 * i + 1] * s2 - a2 * fabsf(static_cast<float>(row[hr] - kj - 1)) - l2[hr]);
          d1 = p * (dp[2 * i + 1] - dl[hr]) * scale;
        }
        da[i] = pack_bf16(d0, d1);
      }
      wgmma_fence();
      issue_reg_times_head(dq_acc, da, Ks + j * HT);
      wgmma_commit();
    };

    if (work) {
      mbar_wait(&kv_full[0], 0);
      wgmma_fence();
      issue_scores<HD>(sc, qs, Ks);
      issue_scores<HD>(dp, dos, Vs);
      wgmma_commit();
      // The last tile is peeled off, so that every wgmma is issued on a path
      // all four warps take.
      for (int j = 0; j + 1 < nt; ++j) {
        ds_step(j);
        mbar_wait(&kv_full[j + 1], 0);
        issue_scores<HD>(sc, qs, Ks + (j + 1) * HT);  // behind dQ_j
        issue_scores<HD>(dp, dos, Vs + (j + 1) * HT);
        wgmma_commit();
      }
      ds_step(nt - 1);
      wgmma_wait<0>();
      fence_acc(dq_acc);
      fence_regs(da);
    }

    // Every product that read this buffer is done in all four warps:
    // refill it with the warpgroup's item after next.
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    if (t == 0 && item + 2 * NC < last) load_item(item + 2 * NC, buf);
    if (!work) continue;
    if constexpr (CHUNKED) {
      if (!last_chunk) {  // the walk goes on in the next chunk: leave it the f32 dQ
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          if (row[hr] >= Sq) continue;
          float* ds = dq_state + ((long long)b * Sq + row[hr]) * E + col0 + 2 * (lane & 3);
#pragma unroll
          for (int c = 0; c < HD / 8; ++c)
            store2(ds + 8 * c, VF_ACC(dq_acc, c, hr, 0), VF_ACC(dq_acc, c, hr, 1));
        }
        continue;
      }
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int qi = row[hr];
      if (qi >= Sq) continue;  // the ragged last tile: zero-filled Q, not stored
      const long long off = (long long)b * dq_bs + (long long)qi * dq_rs + col0 + 2 * (lane & 3);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        store2(dq + off + 8 * c, VF_ACC(dq_acc, c, hr, 0), VF_ACC(dq_acc, c, hr, 1));
    }
  }

  // No TMA load may still be landing in shared memory when the block ends.
  if (tid == 0)
    for (int j = 0; j < tiles; ++j) mbar_wait(&kv_full[j], 0);
}

struct Args {
  CUtensorMap mq, mk, mv, mdo;
  const float* lse_delta;
  float* part;
  void *dq, *dk, *dv;
  long long dq_bs, dq_rs, dkv_bs, dkv_rs;
  int B, H, Sq, Sk;
  const int* kv_len;
  int len_div, kv_div;
  const float* slopes;
  float scale;
  int key_blocks, splits, per_split, dq_splits, dq_per_split, dq_chunks, dq_chunk_keys;
  float* dq_state;
};

template <typename K>
int allow_smem(K kernel, int bytes, int& configured) {
  if (configured >= bytes) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  configured = bytes;
  return 0;
}

template <int HD, int NC, typename TKV>
int launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr int bytes = dkv_smem_bytes(NC, head_boxes(HD));
  static int configured = 0;
  if (int err = allow_smem(attn_bwd_dkv_kernel<HD, NC, TKV>, bytes, configured)) return err;
  const dim3 grid(a.key_blocks * a.splits, a.H, a.B / a.kv_div);
  attn_bwd_dkv_kernel<HD, NC, TKV><<<grid, 128 * NC + 32, bytes, stream>>>(
      a.mq, a.mk, a.mv, a.mdo, a.lse_delta, a.splits > 1 ? a.part : nullptr,
      static_cast<TKV*>(a.dk), static_cast<TKV*>(a.dv), a.dkv_bs, a.dkv_rs, a.Sq, a.Sk,
      a.kv_len, a.len_div, a.kv_div, a.slopes, a.scale, a.key_blocks, a.per_split);
  int err = static_cast<int>(cudaGetLastError());
  if (err || a.splits == 1) return err;
  const long long n = (long long)(a.B / a.kv_div) * a.Sk * 2 * a.H * HD;
  const long long want = (n + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  attn_bwd_dkv_sum_kernel<TKV><<<blocks, 256, 0, stream>>>(
      a.part, a.splits, a.B / a.kv_div, a.Sk, a.H * HD, static_cast<TKV*>(a.dk),
      static_cast<TKV*>(a.dv), a.dkv_bs, a.dkv_rs);
  return static_cast<int>(cudaGetLastError());
}

template <int HD, bool CHUNKED>
int launch_dq(const Args& a, int k0, cudaStream_t stream) {
  const int bytes =
      dq_smem_bytes((a.dq_chunk_keys + KT - 1) / KT, dq_consumers(HD), head_boxes(HD));
  static int configured = 0;
  if (int err = allow_smem(attn_bwd_dq_kernel<HD, CHUNKED>, bytes, configured)) return err;
  const dim3 grid(a.dq_splits, a.H, a.B / a.kv_div);
  attn_bwd_dq_kernel<HD, CHUNKED><<<grid, 128 * dq_consumers(HD), bytes, stream>>>(
      a.mq, a.mk, a.mv, a.mdo, a.lse_delta, static_cast<vf::bf16*>(a.dq), a.dq_bs, a.dq_rs, a.Sq,
      a.Sk, a.kv_len, a.len_div, a.kv_div, a.slopes, a.scale, a.dq_per_split, k0,
      a.dq_chunk_keys, a.dq_state);
  return static_cast<int>(cudaGetLastError());
}

// The dQ pass: one launch, or one a key chunk in key order.
template <int HD>
int launch_dq_chunks(const Args& a, cudaStream_t stream) {
  if (a.dq_chunks == 1) return launch_dq<HD, false>(a, 0, stream);
  for (int c = 0; c < a.dq_chunks; ++c)
    if (int err = launch_dq<HD, true>(a, c * a.dq_chunk_keys, stream)) return err;
  return 0;
}

template <int HD>
int launch_passes(const Args& a, int consumers, int dkv_f32, cudaStream_t stream) {
  int err;
  if constexpr (HD > 64)  // one consumer warpgroup (two spill)
    err = dkv_f32 ? launch_dkv<HD, 1, float>(a, stream) : launch_dkv<HD, 1, vf::bf16>(a, stream);
  else if (consumers == 2)
    err = dkv_f32 ? launch_dkv<HD, 2, float>(a, stream) : launch_dkv<HD, 2, vf::bf16>(a, stream);
  else
    err = dkv_f32 ? launch_dkv<HD, 1, float>(a, stream) : launch_dkv<HD, 1, vf::bf16>(a, stream);
  if (err) return err;
  return launch_dq_chunks<HD>(a, stream);
}

// The prep pass. Its dot products take 4 * PREP_ROWS * (H * HD / 8 + 1)
// bytes of shared memory: past the 48 KB a launch gets by default (from
// H * HD = 3072 on, e.g. 48 heads padded to 64 lanes) the kernel opts in.
template <int HD>
int launch_prep(const float* o, const vf::bf16* d_o, const float* lse, float* lse_delta,
                long long o_bs, long long o_rs, long long do_bs, long long do_rs, int B, int H,
                int Sq, int q_tiles, cudaStream_t stream) {
  const int bytes = prep_smem_bytes(H * HD);
  static int configured = 48 * 1024;
  if (int err = allow_smem(attn_bwd_prep_kernel<HD>, bytes, configured)) return err;
  const unsigned blocks = static_cast<unsigned>(B) * q_tiles * (BQ / PREP_ROWS);
  attn_bwd_prep_kernel<HD><<<blocks, PREP_THREADS, bytes, stream>>>(
      o, d_o, lse, lse_delta, o_bs, o_rs, do_bs, do_rs, H, Sq, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dq: [B, Sq, H*hd]; k, v, dk, dv: [B / kv_div, Sk, H*hd]; o: the
// forward's f32 output (out32), d_o: its bf16 cotangent, [B, Sq, H*hd];
// lse: [B, H, Sq] f32 from the forward. Strides in elements: those of q, k/v
// and d_o multiples of 8 with 16-byte aligned bases (TMA), o's multiples of
// 4, dq's and dk/dv's even (dk and dv share theirs); every last dim unit
// stride. dk and dv are bf16, or f32 when dkv_f32 is set. Scratch: lse_delta
// [B, H, ceil(Sq / 64), 128] f32; part [splits, B / kv_div, Sk, 2 H hd] f32
// when splits > 1, else unused; dq_state [B, Sq, H hd] f32 when dq_chunks > 1,
// else unused. consumers, key_blocks, splits, per_split (the dK/dV pass),
// dq_splits, dq_per_split, dq_chunks, dq_chunk_keys (the dQ pass: launches
// along the keys and keys of each, Sk for one, else a multiple of 64) and the
// two passes' shared memory bytes come from the launch plan (ops/kernels.py
// attention_bwd_plan). Returns cudaErrorInvalidValue when a tensor map
// cannot be made, or the shape or the plan is not one the kernels take
// (shared memory sizes other than this file's layout included).
extern "C" int vf_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                const void* d_o, const void* lse, void* lse_delta, void* part,
                                void* dq, void* dk, void* dv, long long q_bs, long long q_rs,
                                long long kv_bs, long long kv_rs, long long o_bs, long long o_rs,
                                long long do_bs, long long do_rs, long long dq_bs,
                                long long dq_rs, long long dkv_bs, long long dkv_rs, int B, int H,
                                int Sq, int Sk, int head_dim, const void* kv_len, int len_div,
                                int kv_div, const void* slopes, float scale, int dkv_f32,
                                int consumers, int key_blocks, int splits, int per_split,
                                int dq_splits, int dq_per_split, int dkv_smem, int dq_smem,
                                int dq_chunks, int dq_chunk_keys, void* dq_state,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int q_tiles = (Sq + BQ - 1) / BQ;
  const long long items = static_cast<long long>(kv_div) * q_tiles;
  const int width = H * head_dim;
  const auto covers = [&](int n_splits, int per) {
    return n_splits >= 1 && per >= 1 && static_cast<long long>(n_splits - 1) * per < items &&
           static_cast<long long>(n_splits) * per >= items;
  };
  const int dq_tiles = (dq_chunk_keys + KT - 1) / KT;
  const int boxes = head_boxes(head_dim);
  const int dq_nc = dq_consumers(head_dim);
  const bool chunks_ok =
      dq_chunks == 1 ? dq_chunk_keys == Sk
                     : dq_chunks > 1 && dq_chunk_keys % KT == 0 && dq_state &&
                           static_cast<long long>(dq_chunks - 1) * dq_chunk_keys < Sk &&
                           static_cast<long long>(dq_chunks) * dq_chunk_keys >= Sk;
  Args a;
  const bool ok =
      (head_dim == 48 || head_dim == 64 || head_dim == 128) &&
      (consumers == 1 || (consumers == 2 && head_dim <= 64)) && B >= 1 &&
      Sq >= 1 && Sk >= 1 && kv_div >= 1 && B % kv_div == 0 && chunks_ok && dq_tiles >= 1 &&
      key_blocks == (Sk + consumers * KT - 1) / (consumers * KT) &&
      dkv_smem == dkv_smem_bytes(consumers, boxes) &&
      dq_smem == dq_smem_bytes(dq_tiles, dq_nc, boxes) && dq_smem <= SMEM_LIMIT &&
      dkv_smem <= SMEM_LIMIT && dq_tiles <= MAX_KV_TILES &&
      covers(splits, per_split) && covers(dq_splits, dq_per_split) && (splits == 1 || part) &&
      prep_smem_bytes(width) <= SMEM_LIMIT &&
      make_map_rows_sw128(&a.mq, q, B, Sq, width, q_rs, q_bs) &&
      make_map_rows_sw128(&a.mdo, d_o, B, Sq, width, do_rs, do_bs) &&
      make_map_rows_sw128(&a.mk, k, B / kv_div, Sk, width, kv_rs, kv_bs) &&
      make_map_rows_sw128(&a.mv, v, B / kv_div, Sk, width, kv_rs, kv_bs);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  a.lse_delta = static_cast<const float*>(lse_delta);
  a.part = static_cast<float*>(part);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dq_bs = dq_bs;
  a.dq_rs = dq_rs;
  a.dkv_bs = dkv_bs;
  a.dkv_rs = dkv_rs;
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.kv_len = static_cast<const int*>(kv_len);
  a.len_div = len_div;
  a.kv_div = kv_div;
  a.slopes = static_cast<const float*>(slopes);
  a.scale = scale;
  a.key_blocks = key_blocks;
  a.splits = splits;
  a.per_split = per_split;
  a.dq_splits = dq_splits;
  a.dq_per_split = dq_per_split;
  a.dq_chunks = dq_chunks;
  a.dq_chunk_keys = dq_chunk_keys;
  a.dq_state = static_cast<float*>(dq_state);

  const float* o32 = static_cast<const float*>(o);
  const vf::bf16* dop = static_cast<const vf::bf16*>(d_o);
  const float* lsep = static_cast<const float*>(lse);
  float* ld = static_cast<float*>(lse_delta);
  const auto prep = head_dim == 128 ? &launch_prep<128>
                    : head_dim == 64  ? &launch_prep<64>
                                      : &launch_prep<48>;
  if (int err = prep(o32, dop, lsep, ld, o_bs, o_rs, do_bs, do_rs, B, H, Sq, q_tiles, s))
    return err;
  if (head_dim == 128) return launch_passes<128>(a, consumers, dkv_f32, s);
  if (head_dim == 64) return launch_passes<64>(a, consumers, dkv_f32, s);
  return launch_passes<48>(a, consumers, dkv_f32, s);
}

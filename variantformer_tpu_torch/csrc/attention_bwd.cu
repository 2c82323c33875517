// attention_bwd: backward of the masked (ALiBi) softmax attention of
// csrc/attention.cu, with the same conventions: query row b reads K/V row
// b / kv_div and kv_len[b / len_div]; keys at or past kv_len weigh 0; a row
// with kv_len = 0 averages V over all Sk keys (the finite MASK_VALUE of the
// forward), so its probabilities are 1/Sk and its score gradient is 0.
//
// Replaces the attention backward inside the Pallas recompute kernels
// (variantformer_tpu/ops/fused_encoder.py:_bwd_kernel l.664-711;
// variantformer_tpu/ops/fused_modulator.py:_bwd1_kernel l.769-803 and
// _bwd0_kernel l.912-958). With P = exp(s - lse) rebuilt from the forward's
// log-sum-exp, dO the output cotangent and delta_i = sum_d dO_id O_id:
//   dV = P^T dO,  dS = P * (dO V^T - delta) * scale (rounded to bf16),
//   dQ = dS K,    dK = dS^T Q.
//
// Two passes, deterministic and without atomics (the flash-attention-2
// form):
//   delta  one thread per (row, head): rowsum(dO * O) in f32, from the
//          forward's f32 output (its rounded weights renormalised).
//   dK/dV  one block per (64 keys, head, K/V row r); it walks every query
//          row that reads K/V row r (kv_div batch rows x Sq queries), so the
//          gene stack's cross-attention sums its T tissues inside the block;
//          dK, dV stay in wmma accumulators and are written once, in bf16 or
//          f32.
//   dQ     one block per (64 queries, head, b); it walks the keys up to the
//          last valid one.
// Each of 4 warps owns 16 rows of the block's tile; the 16x64 score, dP and
// dS tiles go through shared memory (wmma fragments are opaque). Bound by
// tensor-core operations on paper at the main-path shapes; in practice by
// the f32 elementwise pass between the products, as in the forward.

#include <float.h>
#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TILE = 64, WARPS = 4, THREADS = WARPS * 32, WR = 16;

template <int HD>
struct Layout {
  static constexpr int LD = HD + 8;    // bf16 tiles of Q, dO, K, V
  static constexpr int SLD = TILE + 4;  // f32 16x64 per warp
  static constexpr int PLD = TILE + 8;  // bf16 16x64 per warp
  static constexpr int TILE_BYTES = TILE * LD * 2;
  static constexpr int F_BYTES = WARPS * WR * SLD * 4;
  static constexpr int B_BYTES = WARPS * WR * PLD * 2;
  static constexpr int SMEM = 4 * TILE_BYTES + 2 * F_BYTES + 2 * B_BYTES + 2 * TILE * 4;
};

// Shared-memory carve-up common to both passes.
template <int HD>
struct Smem {
  vf::bf16 *q, *d_o, *k, *v;  // 64-row tiles
  float *s, *dp;              // per-warp 16x64 f32
  vf::bf16 *p, *ds;           // per-warp 16x64 bf16
  float *lse, *delta;         // 64 query rows
  __device__ Smem(unsigned char* base, int warp) {
    using L = Layout<HD>;
    q = reinterpret_cast<vf::bf16*>(base);
    d_o = reinterpret_cast<vf::bf16*>(base + L::TILE_BYTES);
    k = reinterpret_cast<vf::bf16*>(base + 2 * L::TILE_BYTES);
    v = reinterpret_cast<vf::bf16*>(base + 3 * L::TILE_BYTES);
    unsigned char* f = base + 4 * L::TILE_BYTES;
    s = reinterpret_cast<float*>(f) + warp * WR * L::SLD;
    dp = reinterpret_cast<float*>(f + L::F_BYTES) + warp * WR * L::SLD;
    unsigned char* b = f + 2 * L::F_BYTES;
    p = reinterpret_cast<vf::bf16*>(b) + warp * WR * L::PLD;
    ds = reinterpret_cast<vf::bf16*>(b + L::B_BYTES) + warp * WR * L::PLD;
    lse = reinterpret_cast<float*>(b + 2 * L::B_BYTES);
    delta = lse + TILE;
  }
};

// out (16 x 64, f32, ld SLD) = A_w (16 rows of a, row-major) @ B^T, where
// B is a 64-row tile (row j = column j of the product): scores and dP.
template <int HD>
__device__ __forceinline__ void rows_by_tile_t(float* out, const vf::bf16* a,
                                               const vf::bf16* b) {
  using L = Layout<HD>;
#pragma unroll
  for (int nb = 0; nb < TILE / 16; ++nb) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, vf::bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, vf::bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, a + kk, L::LD);
      wmma::load_matrix_sync(fb, b + (nb * 16) * L::LD + kk, L::LD);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + nb * 16, acc, L::SLD, wmma::mem_row_major);
  }
}

// acc[HD/16] (16 x HD) += P_w (16 x 64 bf16, ld PLD) @ tile (64 x HD).
template <int HD>
__device__ __forceinline__ void accumulate_p_tile(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, const vf::bf16* p,
    const vf::bf16* tile) {
  using L = Layout<HD>;
#pragma unroll
  for (int nb = 0; nb < HD / 16; ++nb) {
#pragma unroll
    for (int kk = 0; kk < TILE; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, vf::bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, vf::bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, p + kk, L::PLD);
      wmma::load_matrix_sync(fb, tile + kk * L::LD + nb * 16, L::LD);
      wmma::mma_sync(acc[nb], fa, fb, acc[nb]);
    }
  }
}

// Write a warp's 16 x HD accumulator rows (row0 + r < nrows) through the
// f32 staging tile.
template <int HD, typename T>
__device__ __forceinline__ void store_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float>* acc, float* stage, T* dst,
    long long row_stride, int row0, int nrows, int lane) {
  using L = Layout<HD>;
#pragma unroll
  for (int nb = 0; nb < HD / 16; ++nb)
    wmma::store_matrix_sync(stage + nb * 16, acc[nb], L::SLD, wmma::mem_row_major);
  __syncwarp();
  for (int i = lane; i < WR * HD; i += 32) {
    const int r = i / HD, c = i % HD;
    if (row0 + r < nrows) {
      const float val = stage[r * L::SLD + c];
      if constexpr (sizeof(T) == 4)
        dst[(long long)(row0 + r) * row_stride + c] = val;
      else
        dst[(long long)(row0 + r) * row_stride + c] = __float2bfloat16_rn(val);
    }
  }
  __syncwarp();
}

// delta = rowsum(dO * O) with O the forward's f32 output whose bf16 weights
// are renormalised to sum to 1 (csrc/attention.cu). Where the probabilities
// are nearly uniform, dP - delta is a small difference of large terms: the
// rounding of a bf16 O, or weights that do not sum to 1, would swamp it.
__global__ void delta_kernel(const float* __restrict__ o, const vf::bf16* __restrict__ d_o,
                             float* __restrict__ delta, long long o_bs, long long o_rs,
                             long long do_bs, long long do_rs, int B, int H, int Sq, int hd) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= (long long)B * Sq * H) return;
  const int h = static_cast<int>(i % H);
  const long long row = i / H;
  const int qi = static_cast<int>(row % Sq), b = static_cast<int>(row / Sq);
  const float* op = o + b * o_bs + qi * o_rs + h * hd;
  const vf::bf16* dp = d_o + b * do_bs + qi * do_rs + h * hd;
  float acc = 0.0f, y[8];
  for (int d = 0; d < hd; d += 8) {
    const float4 x0 = *reinterpret_cast<const float4*>(op + d);
    const float4 x1 = *reinterpret_cast<const float4*>(op + d + 4);
    vf::load8(dp + d, y);
    acc += x0.x * y[0] + x0.y * y[1] + x0.z * y[2] + x0.w * y[3];
    acc += x1.x * y[4] + x1.y * y[5] + x1.z * y[6] + x1.w * y[7];
  }
  delta[((long long)b * H + h) * Sq + qi] = acc;
}

template <int HD, typename TKV>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const vf::bf16* __restrict__ q, const vf::bf16* __restrict__ k,
           const vf::bf16* __restrict__ v, const vf::bf16* __restrict__ d_o,
           const float* __restrict__ lse, const float* __restrict__ delta, TKV* __restrict__ dk,
           TKV* __restrict__ dv, long long q_bs, long long q_rs, long long kv_bs,
           long long kv_rs, long long do_bs, long long do_rs, long long dkv_bs,
           long long dkv_rs, int Sq, int Sk, const int* __restrict__ kv_len, int len_div,
           int kv_div, const float* __restrict__ slopes, float scale) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Smem<HD> sm(smem, warp);
  const int t0 = blockIdx.x * TILE, h = blockIdx.y, r = blockIdx.z, H = gridDim.y;
  const float slope = slopes ? slopes[h] : 0.0f;

  vf::load_rows64<HD, L::LD, THREADS>(sm.k, k + r * kv_bs + h * HD, kv_rs, t0, Sk, tid);
  vf::load_rows64<HD, L::LD, THREADS>(sm.v, v + r * kv_bs + h * HD, kv_rs, t0, Sk, tid);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_k[HD / 16], acc_v[HD / 16];
#pragma unroll
  for (int nb = 0; nb < HD / 16; ++nb) {
    wmma::fill_fragment(acc_k[nb], 0.0f);
    wmma::fill_fragment(acc_v[nb], 0.0f);
  }
  const vf::bf16* k_w = sm.k + warp * WR * L::LD;
  const vf::bf16* v_w = sm.v + warp * WR * L::LD;

  for (int b = r * kv_div; b < (r + 1) * kv_div; ++b) {
    const int len = kv_len[b / len_div];
    if (len > 0 && t0 >= len) continue;  // every key of the tile weighs 0 for b
    const float* lse_b = lse + ((long long)b * H + h) * Sq;
    const float* delta_b = delta + ((long long)b * H + h) * Sq;
    for (int q0 = 0; q0 < Sq; q0 += TILE) {
      __syncthreads();  // every warp is done with the previous Q / dO tile
      vf::load_rows64<HD, L::LD, THREADS>(sm.q, q + b * q_bs + h * HD, q_rs, q0, Sq, tid);
      vf::load_rows64<HD, L::LD, THREADS>(sm.d_o, d_o + b * do_bs + h * HD, do_rs, q0, Sq,
                                          tid);
      if (tid < TILE) {
        const bool ok = q0 + tid < Sq;
        sm.lse[tid] = ok ? lse_b[q0 + tid] : 0.0f;
        sm.delta[tid] = ok ? delta_b[q0 + tid] : 0.0f;
      }
      __syncthreads();

      rows_by_tile_t<HD>(sm.s, k_w, sm.q);     // S^T: 16 keys x 64 queries
      rows_by_tile_t<HD>(sm.dp, v_w, sm.d_o);  // dP^T = V dO^T
      __syncwarp();
      for (int i = lane; i < WR * TILE; i += 32) {
        const int kr = i / TILE, qc = i % TILE;
        const int kj = t0 + warp * WR + kr, qi = q0 + qc;
        float p = 0.0f, ds = 0.0f;
        if (qi < Sq && kj < Sk) {
          if (len == 0) {
            p = 1.0f / static_cast<float>(Sk);
          } else if (kj < len) {
            const float s = sm.s[kr * L::SLD + qc] * scale - slope * fabsf(static_cast<float>(qi - kj));
            p = __expf(s - sm.lse[qc]);
            ds = p * (sm.dp[kr * L::SLD + qc] - sm.delta[qc]) * scale;
          }
        }
        sm.p[kr * L::PLD + qc] = __float2bfloat16_rn(p);
        sm.ds[kr * L::PLD + qc] = __float2bfloat16_rn(ds);
      }
      __syncwarp();
      accumulate_p_tile<HD>(acc_v, sm.p, sm.d_o);  // dV += P^T dO
      accumulate_p_tile<HD>(acc_k, sm.ds, sm.q);   // dK += dS^T Q
    }
  }
  TKV* dk_r = dk + r * dkv_bs + h * HD;
  TKV* dv_r = dv + r * dkv_bs + h * HD;
  store_rows<HD, TKV>(acc_k, sm.s, dk_r, dkv_rs, t0 + warp * WR, Sk, lane);
  store_rows<HD, TKV>(acc_v, sm.s, dv_r, dkv_rs, t0 + warp * WR, Sk, lane);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const vf::bf16* __restrict__ q, const vf::bf16* __restrict__ k,
          const vf::bf16* __restrict__ v, const vf::bf16* __restrict__ d_o,
          const float* __restrict__ lse, const float* __restrict__ delta,
          vf::bf16* __restrict__ dq, long long q_bs, long long q_rs, long long kv_bs,
          long long kv_rs, long long do_bs, long long do_rs, long long dq_bs, long long dq_rs,
          int Sq, int Sk, const int* __restrict__ kv_len, int len_div, int kv_div,
          const float* __restrict__ slopes, float scale) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  Smem<HD> sm(smem, warp);
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int len = kv_len[b / len_div];
  const int n_keys = len > 0 ? min(len, Sk) : 0;  // kv_len = 0: dS = 0, dQ = 0
  const float slope = slopes ? slopes[h] : 0.0f;
  const float* lse_b = lse + ((long long)b * H + h) * Sq;
  const float* delta_b = delta + ((long long)b * H + h) * Sq;
  const vf::bf16* kb = k + (long long)(b / kv_div) * kv_bs + h * HD;
  const vf::bf16* vb = v + (long long)(b / kv_div) * kv_bs + h * HD;

  vf::load_rows64<HD, L::LD, THREADS>(sm.q, q + b * q_bs + h * HD, q_rs, q0, Sq, tid);
  vf::load_rows64<HD, L::LD, THREADS>(sm.d_o, d_o + b * do_bs + h * HD, do_rs, q0, Sq, tid);
  if (tid < TILE) {
    const bool ok = q0 + tid < Sq;
    sm.lse[tid] = ok ? lse_b[q0 + tid] : 0.0f;
    sm.delta[tid] = ok ? delta_b[q0 + tid] : 0.0f;
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[HD / 16];
#pragma unroll
  for (int nb = 0; nb < HD / 16; ++nb) wmma::fill_fragment(acc[nb], 0.0f);
  const vf::bf16* q_w = sm.q + warp * WR * L::LD;
  const vf::bf16* do_w = sm.d_o + warp * WR * L::LD;

  for (int t0 = 0; t0 < n_keys; t0 += TILE) {
    __syncthreads();  // every warp is done with the previous K / V tile
    vf::load_rows64<HD, L::LD, THREADS>(sm.k, kb, kv_rs, t0, Sk, tid);
    vf::load_rows64<HD, L::LD, THREADS>(sm.v, vb, kv_rs, t0, Sk, tid);
    __syncthreads();

    rows_by_tile_t<HD>(sm.s, q_w, sm.k);    // S: 16 queries x 64 keys
    rows_by_tile_t<HD>(sm.dp, do_w, sm.v);  // dP = dO V^T
    __syncwarp();
    for (int i = lane; i < WR * TILE; i += 32) {
      const int qr = i / TILE, kc = i % TILE;
      const int qi = q0 + warp * WR + qr, kj = t0 + kc;
      float ds = 0.0f;
      if (qi < Sq && kj < n_keys) {
        const float s = sm.s[qr * L::SLD + kc] * scale - slope * fabsf(static_cast<float>(qi - kj));
        const float p = __expf(s - sm.lse[warp * WR + qr]);
        ds = p * (sm.dp[qr * L::SLD + kc] - sm.delta[warp * WR + qr]) * scale;
      }
      sm.ds[qr * L::PLD + kc] = __float2bfloat16_rn(ds);
    }
    __syncwarp();
    accumulate_p_tile<HD>(acc, sm.ds, sm.k);  // dQ += dS K
  }
  store_rows<HD, vf::bf16>(acc, sm.s, dq + b * dq_bs + h * HD, dq_rs, q0 + warp * WR, Sq,
                           lane);
}

template <int HD, typename TKV>
int launch(const void* q, const void* k, const void* v, const void* o, const void* d_o,
           const void* lse, void* delta, void* dq, void* dk, void* dv, long long q_bs,
           long long q_rs, long long kv_bs, long long kv_rs, long long o_bs, long long o_rs,
           long long do_bs, long long do_rs, long long dq_bs, long long dq_rs, long long dkv_bs,
           long long dkv_rs, int B, int H, int Sq, int Sk, const void* kv_len, int len_div,
           int kv_div, const void* slopes, float scale, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(dkv_kernel<HD, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Layout<HD>::SMEM);
    cudaFuncSetAttribute(dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Layout<HD>::SMEM);
    configured = true;
  }
  const vf::bf16* qp = static_cast<const vf::bf16*>(q);
  const vf::bf16* kp = static_cast<const vf::bf16*>(k);
  const vf::bf16* vp = static_cast<const vf::bf16*>(v);
  const vf::bf16* dop = static_cast<const vf::bf16*>(d_o);
  const float* lsep = static_cast<const float*>(lse);
  float* deltap = static_cast<float*>(delta);
  const int* lens = static_cast<const int*>(kv_len);
  const float* sl = static_cast<const float*>(slopes);

  const long long rows = (long long)B * Sq * H;
  delta_kernel<<<static_cast<unsigned>((rows + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(o), dop, deltap, o_bs, o_rs, do_bs, do_rs, B, H, Sq, HD);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dim3 grid_kv((Sk + TILE - 1) / TILE, H, B / kv_div);
  dkv_kernel<HD, TKV><<<grid_kv, THREADS, Layout<HD>::SMEM, stream>>>(
      qp, kp, vp, dop, lsep, deltap, static_cast<TKV*>(dk), static_cast<TKV*>(dv), q_bs, q_rs,
      kv_bs, kv_rs, do_bs, do_rs, dkv_bs, dkv_rs, Sq, Sk, lens, len_div, kv_div, sl, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dim3 grid_q((Sq + TILE - 1) / TILE, H, B);
  dq_kernel<HD><<<grid_q, THREADS, Layout<HD>::SMEM, stream>>>(
      qp, kp, vp, dop, lsep, deltap, static_cast<vf::bf16*>(dq), q_bs, q_rs, kv_bs, kv_rs,
      do_bs, do_rs, dq_bs, dq_rs, Sq, Sk, lens, len_div, kv_div, sl, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dq: [B, Sq, H*HD]; k, v, dk, dv: [B / kv_div, Sk, H*HD]; o: the
// forward's f32 output, d_o: its bf16 cotangent, [B, Sq, H*HD]; lse, delta:
// [B, H, Sq] f32 (delta is scratch). dk and dv share strides and are bf16, or
// f32 when dkv_f32 is set. All rows have unit stride in the last dim.
extern "C" int vf_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                const void* d_o, const void* lse, void* delta, void* dq,
                                void* dk, void* dv, long long q_bs, long long q_rs,
                                long long kv_bs, long long kv_rs, long long o_bs,
                                long long o_rs, long long do_bs, long long do_rs,
                                long long dq_bs, long long dq_rs, long long dkv_bs,
                                long long dkv_rs, int B, int H, int Sq, int Sk, int head_dim,
                                const void* kv_len, int len_div, int kv_div,
                                const void* slopes, float scale, int dkv_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define VF_ATTN_BWD(HD, T)                                                                   \
  return launch<HD, T>(q, k, v, o, d_o, lse, delta, dq, dk, dv, q_bs, q_rs, kv_bs, kv_rs,   \
                       o_bs, o_rs, do_bs, do_rs, dq_bs, dq_rs, dkv_bs, dkv_rs, B, H, Sq, Sk, \
                       kv_len, len_div, kv_div, slopes, scale, s)
  if (head_dim == 64 && dkv_f32) VF_ATTN_BWD(64, float);
  if (head_dim == 64) VF_ATTN_BWD(64, vf::bf16);
  if (head_dim == 48 && dkv_f32) VF_ATTN_BWD(48, float);
  if (head_dim == 48) VF_ATTN_BWD(48, vf::bf16);
#undef VF_ATTN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

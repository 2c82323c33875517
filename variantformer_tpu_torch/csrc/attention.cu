// attention: masked softmax attention with optional symmetric ALiBi.
//
// Replaces the per-head attention loops inside the Pallas kernels
// (variantformer_tpu/ops/fused_encoder.py:_kernel l.131-159;
// variantformer_tpu/ops/fused_modulator.py:_kernel l.189-247). For query
// row b, head h, position i and key j < Sk:
//   s_ij = (q_i . k_j) * scale - slope_h * |i - j|   if j < kv_len
//        = MASK_VALUE (finite, -0.7 * FLT_MAX)        otherwise
//   out_i = softmax_j(s_ij) @ v
// Query row b reads K/V row b / kv_div (the gene stack's donor-shared CRE
// K/V) and kv_len[b / len_div]. A row with kv_len = 0 averages V over all
// Sk keys, as the plain version does; otherwise keys at or past kv_len
// weigh exactly 0, so the loop stops at the last valid key's tile.
//
// Design: one block of 4 warps per (64 queries, head, b); each warp owns
// 16 query rows. Keys are walked in tiles of 64 with an online softmax:
// S = Q K^T on the tensor cores (wmma bf16, f32 accumulate) into shared
// memory, f32 max/exp/sum per row by the whole warp, P rounded to bf16,
// O = O * alpha + P V again on the tensor cores with O kept in shared
// memory (wmma fragments are opaque, so the per-row rescale happens there).
// head_dim is a template parameter (48 or 64: 3 or 4 k-steps of 16).
// For the backward (csrc/attention_bwd.cu) it optionally also writes each
// row's log-sum-exp m + log(l) to an f32 [B, H, Sq] buffer, and to an f32
// buffer laid out like `out` the output with the bf16-rounded weights
// renormalised to sum to 1 (their own running sum lb): an exact weighted
// average of V, so the backward's rowsum(dO * O) misses sum_j P_j dP_j only
// by the weights' rounding times the spread of dP, not times dP itself. The
// serving path passes null for both.

#include <float.h>
#include <math.h>
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BQ = 64, KT = 64, WARPS = 4, THREADS = WARPS * 32, WQ = 16;
constexpr float MASK_VALUE = -0.7f * FLT_MAX;

template <int HD>
struct Layout {
  static constexpr int QLD = HD + 8;   // bf16 rows of Q, K, V tiles
  static constexpr int SLD = KT + 4;   // f32 scores
  static constexpr int PLD = KT + 8;   // bf16 probabilities
  static constexpr int OLD = HD + 4;   // f32 output accumulator
  static constexpr int Q_BYTES = BQ * QLD * 2;
  static constexpr int KV_BYTES = KT * QLD * 2;
  static constexpr int S_BYTES = WARPS * WQ * SLD * 4;
  static constexpr int P_BYTES = WARPS * WQ * PLD * 2;
  static constexpr int O_BYTES = WARPS * WQ * OLD * 4;
  static constexpr int SMEM = Q_BYTES + 2 * KV_BYTES + S_BYTES + P_BYTES + O_BYTES;
};

template <int HD>
__device__ __forceinline__ void load_rows(vf::bf16* dst, const vf::bf16* src, long long row_stride,
                                          int row0, int nrows, int tid) {
  vf::load_rows64<HD, Layout<HD>::QLD, THREADS>(dst, src, row_stride, row0, nrows, tid);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const vf::bf16* __restrict__ q, const vf::bf16* __restrict__ k,
                 const vf::bf16* __restrict__ v, vf::bf16* __restrict__ out,
                 long long q_bs, long long q_rs, long long kv_bs, long long kv_rs,
                 long long o_bs, long long o_rs, int Sq, int Sk,
                 const int* __restrict__ kv_len, int len_div, int kv_div,
                 const float* __restrict__ slopes, float scale, float* __restrict__ lse,
                 float* __restrict__ out32) {
  using L = Layout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  vf::bf16* Qs = reinterpret_cast<vf::bf16*>(smem);
  vf::bf16* Ks = reinterpret_cast<vf::bf16*>(smem + L::Q_BYTES);
  vf::bf16* Vs = reinterpret_cast<vf::bf16*>(smem + L::Q_BYTES + L::KV_BYTES);
  float* Ss = reinterpret_cast<float*>(smem + L::Q_BYTES + 2 * L::KV_BYTES);
  vf::bf16* Ps = reinterpret_cast<vf::bf16*>(smem + L::Q_BYTES + 2 * L::KV_BYTES + L::S_BYTES);
  float* Os = reinterpret_cast<float*>(smem + L::Q_BYTES + 2 * L::KV_BYTES + L::S_BYTES +
                                       L::P_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int len = kv_len[b / len_div];
  const int n_keys = len > 0 ? min(len, Sk) : Sk;
  const float slope = slopes ? slopes[h] : 0.0f;

  const vf::bf16* qb = q + (long long)b * q_bs + h * HD;
  const vf::bf16* kb = k + (long long)(b / kv_div) * kv_bs + h * HD;
  const vf::bf16* vb = v + (long long)(b / kv_div) * kv_bs + h * HD;

  float* Sw = Ss + warp * WQ * L::SLD;
  vf::bf16* Pw = Ps + warp * WQ * L::PLD;
  float* Ow = Os + warp * WQ * L::OLD;

  load_rows<HD>(Qs, qb, q_rs, q0, Sq, tid);
  for (int i = lane; i < WQ * L::OLD; i += 32) Ow[i] = 0.0f;

  float m[WQ], l[WQ], lb[WQ], alpha[WQ];
#pragma unroll
  for (int r = 0; r < WQ; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
    lb[r] = 0.0f;
  }

  for (int t0 = 0; t0 < n_keys; t0 += KT) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<HD>(Ks, kb, kv_rs, t0, Sk, tid);
    load_rows<HD>(Vs, vb, kv_rs, t0, Sk, tid);
    __syncthreads();

    // S = Q_w K^T  (16 x 64)
#pragma unroll
    for (int nb = 0; nb < KT / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, vf::bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, vf::bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + (warp * WQ) * L::QLD + kk, L::QLD);
        wmma::load_matrix_sync(fb, Ks + (nb * 16) * L::QLD + kk, L::QLD);
        wmma::mma_sync(s, fa, fb, s);
      }
      wmma::store_matrix_sync(Sw + nb * 16, s, L::SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time across the warp (2 keys per lane)
#pragma unroll
    for (int r = 0; r < WQ; ++r) {
      const int qi = q0 + warp * WQ + r;
      float x[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int jj = lane + 32 * c, j = t0 + jj;
        float s = Sw[r * L::SLD + jj];
        if (j >= n_keys)
          s = -INFINITY;  // past the loop's keys: weight exactly 0
        else if (j >= len)
          s = MASK_VALUE;
        else
          s = s * scale - slope * fabsf(static_cast<float>(qi - j));
        x[c] = s;
      }
      const float m_new = fmaxf(m[r], vf::warp_max(fmaxf(x[0], x[1])));
      const float p0 = __expf(x[0] - m_new), p1 = __expf(x[1] - m_new);
      alpha[r] = __expf(m[r] - m_new);
      l[r] = l[r] * alpha[r] + vf::warp_sum(p0 + p1);
      m[r] = m_new;
      const vf::bf16 b0 = __float2bfloat16_rn(p0), b1 = __float2bfloat16_rn(p1);
      if (out32)
        lb[r] = lb[r] * alpha[r] + vf::warp_sum(__bfloat162float(b0) + __bfloat162float(b1));
      Pw[r * L::PLD + lane] = b0;
      Pw[r * L::PLD + lane + 32] = b1;
    }
    __syncwarp();

    // O = O * alpha + P V
#pragma unroll
    for (int r = 0; r < WQ; ++r)
      for (int c = lane; c < HD; c += 32) Ow[r * L::OLD + c] *= alpha[r];
    __syncwarp();
#pragma unroll
    for (int nb = 0; nb < HD / 16; ++nb) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, Ow + nb * 16, L::OLD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, vf::bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, vf::bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, Pw + kk, L::PLD);
        wmma::load_matrix_sync(fb, Vs + kk * L::QLD + nb * 16, L::QLD);
        wmma::mma_sync(o, fa, fb, o);
      }
      wmma::store_matrix_sync(Ow + nb * 16, o, L::OLD, wmma::mem_row_major);
    }
    __syncwarp();
  }

  vf::bf16* ob = out + (long long)b * o_bs + h * HD;
  float* lse_bh = lse ? lse + ((long long)b * gridDim.y + h) * Sq : nullptr;
#pragma unroll
  for (int r = 0; r < WQ; ++r) {
    const int qi = q0 + warp * WQ + r;
    if (qi >= Sq) continue;
    const float inv = 1.0f / l[r];
    for (int c = lane; c < HD; c += 32) {
      const float acc = Ow[r * L::OLD + c];
      ob[(long long)qi * o_rs + c] = __float2bfloat16_rn(acc * inv);
      if (out32) out32[(long long)b * o_bs + (long long)qi * o_rs + h * HD + c] = acc / lb[r];
    }
    if (lse_bh && lane == 0) lse_bh[qi] = m[r] + logf(l[r]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, long long q_bs,
           long long q_rs, long long kv_bs, long long kv_rs, long long o_bs, long long o_rs,
           int B, int H, int Sq, int Sk, const void* kv_len, int len_div, int kv_div,
           const void* slopes, float scale, void* lse, void* out32, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Layout<HD>::SMEM);
    configured = true;
  }
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  attention_kernel<HD><<<grid, THREADS, Layout<HD>::SMEM, stream>>>(
      static_cast<const vf::bf16*>(q), static_cast<const vf::bf16*>(k),
      static_cast<const vf::bf16*>(v), static_cast<vf::bf16*>(out), q_bs, q_rs, kv_bs, kv_rs,
      o_bs, o_rs, Sq, Sk, static_cast<const int*>(kv_len), len_div, kv_div,
      static_cast<const float*>(slopes), scale, static_cast<float*>(lse),
      static_cast<float*>(out32));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// lse: null, or [B, H, Sq] f32 receiving each row's log-sum-exp of its
// (scaled, biased, masked) scores; out32: null, or the f32 output with the
// rounded weights renormalised, with out's strides. Both for the backward
// (csrc/attention_bwd.cu).
extern "C" int vf_attention(const void* q, const void* k, const void* v, void* out,
                            long long q_bs, long long q_rs, long long kv_bs, long long kv_rs,
                            long long o_bs, long long o_rs, int B, int H, int Sq, int Sk,
                            int head_dim, const void* kv_len, int len_div, int kv_div,
                            const void* slopes, float scale, void* lse, void* out32,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    return launch<64>(q, k, v, out, q_bs, q_rs, kv_bs, kv_rs, o_bs, o_rs, B, H, Sq, Sk, kv_len,
                      len_div, kv_div, slopes, scale, lse, out32, s);
  if (head_dim == 48)
    return launch<48>(q, k, v, out, q_bs, q_rs, kv_bs, kv_rs, o_bs, o_rs, B, H, Sq, Sk, kv_len,
                      len_div, kv_div, slopes, scale, lse, out32, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

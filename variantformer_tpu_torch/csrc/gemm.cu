// gemm: the bf16 tensor-core GEMM of the forward and backward chains, in
// three layouts of one kernel template.
//
//   forward  out[M, N] bf16 = round(round(round(A @ B) + bias) + residual)
//            A [M, K] row-major, B [K, N] row-major (weights [in, out]).
//   dgrad    out[M, N] bf16 = round(A @ B^T) (+ residual, then rounded)
//            A = dY [M, K], B = W stored [N, K] (the forward weight read
//            transposed): dX = dY W^T without materialising W^T.
//   wgrad    out[M, N] f32 += A^T @ B
//            A = X stored [K, M], B = dY [K, N]: dW = X^T dY, contracting
//            the row axis (up to ~80 000 rows), accumulated in f32 into an
//            existing buffer.
//
// Replaces the projections inside the Pallas kernels of
// variantformer_tpu/ops/fused_encoder.py (_kernel, _bwd_kernel) and
// variantformer_tpu/ops/fused_modulator.py (_kernel, _bwd1_kernel,
// _bwd0_kernel). The Pallas backward kernels carry each weight gradient in a
// VMEM accumulator across a sequential grid; Hopper blocks run in no order,
// so here dW is one GEMM over all rows, split along the rows (split-K) when
// the output alone has too few tiles to fill the card, with the splits'
// partial sums added by f32 atomics.
//
// Bound by tensor-core operations at the main-path shapes. Design: 128x128
// output tile per block of 8 warps (2 x 4, 64x32 per warp, 4x2 wmma 16x16
// accumulators); K in steps of 32 through a 3-stage cp.async ring in
// shared memory, so the next tiles load while the current one multiplies.
// A transposed operand is staged in shared memory as stored and read with a
// col_major wmma fragment. Rows and chunks beyond the edges are zero-filled
// on load and skipped on store. The dimension read in 16-byte chunks must be
// a multiple of 8: K for a row-major A or a transposed B, M for a
// transposed A, N for B and the output.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int PAD = 8;                 // padded rows: conflict-free fragment loads
constexpr int A_LD = BK + PAD;         // A as [m][k]
constexpr int AT_LD = BM + PAD;        // A^T as stored, [k][m]
constexpr int B_LD = BN + PAD;         // B as [k][n]
constexpr int BT_LD = BK + PAD;        // B^T as stored, [n][k]
constexpr int STAGE_ELEMS = BM * A_LD;  // = BN * BT_LD, >= BK * AT_LD, BK * B_LD
constexpr int SMEM_BYTES = STAGES * 2 * STAGE_ELEMS * 2;
constexpr int EPI_LD = 16;             // per-warp 16x16 f32 staging in the epilogue

template <bool TA, bool TB>
__device__ __forceinline__ void load_tile(vf::bf16* As, vf::bf16* Bs, const vf::bf16* A,
                                          const vf::bf16* B, int M, int N, int K, int m0,
                                          int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    if (!TA) {  // 128 rows (m) x 4 chunks (k)
      const int row = c >> 2, col = (c & 3) * 8;
      const int gr = m0 + row, gc = k0 + col;
      const bool ok = gr < M && gc < K;
      vf::cp_async16(As + row * A_LD + col, ok ? A + (size_t)gr * K + gc : A, ok);
    } else {    // 32 rows (k) x 16 chunks (m)
      const int row = c >> 4, col = (c & 15) * 8;
      const int gr = k0 + row, gc = m0 + col;
      const bool ok = gr < K && gc < M;
      vf::cp_async16(As + row * AT_LD + col, ok ? A + (size_t)gr * M + gc : A, ok);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = tid + i * THREADS;
    if (!TB) {  // 32 rows (k) x 16 chunks (n)
      const int row = c >> 4, col = (c & 15) * 8;
      const int gr = k0 + row, gc = n0 + col;
      const bool ok = gr < K && gc < N;
      vf::cp_async16(Bs + row * B_LD + col, ok ? B + (size_t)gr * N + gc : B, ok);
    } else {    // 128 rows (n) x 4 chunks (k)
      const int row = c >> 2, col = (c & 3) * 8;
      const int gr = n0 + row, gc = k0 + col;
      const bool ok = gr < N && gc < K;
      vf::cp_async16(Bs + row * BT_LD + col, ok ? B + (size_t)gr * K + gc : B, ok);
    }
  }
}

template <bool TA, bool TB, bool F32OUT>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const vf::bf16* __restrict__ A, const vf::bf16* __restrict__ B,
            const vf::bf16* __restrict__ bias, const vf::bf16* __restrict__ res,
            void* __restrict__ out_ptr, int M, int N, int K, int ktiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  vf::bf16* As = reinterpret_cast<vf::bf16*>(smem);
  vf::bf16* Bs = As + STAGES * STAGE_ELEMS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;
  const int kt_begin = blockIdx.z * ktiles_per_split;
  const int kt_end = min(ktiles, kt_begin + ktiles_per_split);
  const int nkt = max(kt_end - kt_begin, 0);

  using ALayout = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
  using BLayout = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt)
      load_tile<TA, TB>(As + s * STAGE_ELEMS, Bs + s * STAGE_ELEMS, A, B, M, N, K, m0, n0,
                        (kt_begin + s) * BK, tid);
    vf::cp_async_commit();
  }

  for (int kt = 0; kt < nkt; ++kt) {
    vf::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt-1
    const int nt = kt + STAGES - 1;
    if (nt < nkt) {
      const int s = nt % STAGES;
      load_tile<TA, TB>(As + s * STAGE_ELEMS, Bs + s * STAGE_ELEMS, A, B, M, N, K, m0, n0,
                        (kt_begin + nt) * BK, tid);
    }
    vf::cp_async_commit();

    const vf::bf16* a_s = As + (kt % STAGES) * STAGE_ELEMS;
    const vf::bf16* b_s = Bs + (kt % STAGES) * STAGE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, vf::bf16, ALayout> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, vf::bf16, BLayout> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int mr = wm * 64 + i * 16;
        if (TA)
          wmma::load_matrix_sync(fa[i], a_s + kk * AT_LD + mr, AT_LD);
        else
          wmma::load_matrix_sync(fa[i], a_s + mr * A_LD + kk, A_LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nc = wn * 32 + j * 16;
        if (TB)
          wmma::load_matrix_sync(fb[j], b_s + nc * BT_LD + kk, BT_LD);
        else
          wmma::load_matrix_sync(fb[j], b_s + kk * B_LD + nc, B_LD);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  vf::cp_async_wait<0>();
  __syncthreads();  // the ring is free: reuse it for the epilogue staging

  float* stage = reinterpret_cast<float*>(smem) + warp * 16 * EPI_LD;
  const int r = lane >> 1, c8 = (lane & 1) * 8;
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], EPI_LD, wmma::mem_row_major);
      __syncwarp();
      const int row = m0 + wm * 64 + i * 16 + r;
      const int col = n0 + wn * 32 + j * 16 + c8;
      if (row < M && col < N) {
        float v[8], t[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = stage[r * EPI_LD + c8 + e];
        if (F32OUT) {
          float* o = static_cast<float*>(out_ptr) + (size_t)row * N + col;
          if (split) {
#pragma unroll
            for (int e = 0; e < 8; ++e) atomicAdd(o + e, v[e]);
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) o[e] += v[e];
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = vf::round_bf16(v[e]);
          if (bias) {
            vf::load8(bias + col, t);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = vf::round_bf16(v[e] + t[e]);
          }
          if (res) {
            vf::load8(res + (size_t)row * N + col, t);
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] += t[e];
          }
          vf::store8(static_cast<vf::bf16*>(out_ptr) + (size_t)row * N + col, v);
        }
      }
      __syncwarp();
    }
  }
}

template <bool TA, bool TB, bool F32OUT>
int launch(const void* a, const void* b, const void* bias, const void* res, void* out, int M,
           int N, int K, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(gemm_kernel<TA, TB, F32OUT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    configured = true;
  }
  const int ktiles = (K + BK - 1) / BK;
  const int tiles = ((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  int splits = 1;
  if (F32OUT) {
    // Two waves of blocks on 132 SMs, each split at least 16 k-tiles long.
    const int want = (2 * 132 + tiles - 1) / tiles;
    splits = max(1, min(want, ktiles / 16));
  }
  const int per_split = max(1, (ktiles + splits - 1) / splits);
  splits = (ktiles + per_split - 1) / per_split;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, max(splits, 1));
  gemm_kernel<TA, TB, F32OUT><<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const vf::bf16*>(a), static_cast<const vf::bf16*>(b),
      static_cast<const vf::bf16*>(bias), static_cast<const vf::bf16*>(res), out, M, N, K,
      per_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// layout 0: forward (A [M,K], B [K,N], bf16 out with bias and residual);
// layout 1: dgrad (B stored [N,K], bf16 out with residual);
// layout 2: wgrad (A stored [K,M], f32 out accumulated into).
extern "C" int vf_gemm(const void* a, const void* b, const void* bias, const void* res,
                       void* out, int M, int N, int K, int layout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == 0) return launch<false, false, false>(a, b, bias, res, out, M, N, K, s);
  if (layout == 1) return launch<false, true, false>(a, b, bias, res, out, M, N, K, s);
  if (layout == 2) return launch<true, false, true>(a, b, nullptr, nullptr, out, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

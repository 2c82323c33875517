// gemm_dgrad: the input cotangent of a projection on the tensor cores
// (nvcuda::wmma), dX = dY W^T (+ residual).
//
//   out[M, N] bf16 = round(A @ B^T) (+ residual, then rounded)
//   A = dY [M, K] row-major, B = W stored [N, K] (the forward weight [in,
//   out] read transposed): dX = dY W^T without materialising W^T.
//
// Replaces the ``matmul_t`` products of the Pallas backward kernels of
// variantformer_tpu/ops/fused_encoder.py (_bwd_kernel) and
// variantformer_tpu/ops/fused_modulator.py (_bwd1_kernel, _bwd0_kernel).
// The forward GEMM and the weight gradients run on the TMA + wgmma kernel
// of gemm_sm90.cu.
//
// Bound by tensor-core operations at the main-path shapes. Design: 128x128
// output tile per block of 8 warps (2 x 4, 64x32 per warp, 4x2 wmma 16x16
// accumulators); K in steps of 32 through a 3-stage cp.async ring in
// shared memory, so the next tiles load while the current one multiplies.
// W is staged in shared memory as stored and read with a col_major wmma
// fragment. Rows and chunks beyond the edges are zero-filled on load and
// skipped on store. K and N must be multiples of 8.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int PAD = 8;                 // padded rows: conflict-free fragment loads
constexpr int A_LD = BK + PAD;         // A as [m][k]
constexpr int BT_LD = BK + PAD;        // B^T as stored, [n][k]
constexpr int STAGE_ELEMS = BM * A_LD;  // = BN * BT_LD
constexpr int SMEM_BYTES = STAGES * 2 * STAGE_ELEMS * 2;
constexpr int EPI_LD = 16;             // per-warp 16x16 f32 staging in the epilogue

__device__ __forceinline__ void load_tile(vf::bf16* As, vf::bf16* Bs, const vf::bf16* A,
                                          const vf::bf16* B, int M, int N, int K, int m0,
                                          int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // 128 rows x 4 chunks of each operand
    const int c = tid + i * THREADS;
    const int row = c >> 2, col = (c & 3) * 8;
    const int gc = k0 + col;
    const bool a_ok = m0 + row < M && gc < K;
    vf::cp_async16(As + row * A_LD + col, a_ok ? A + (size_t)(m0 + row) * K + gc : A, a_ok);
    const bool b_ok = n0 + row < N && gc < K;
    vf::cp_async16(Bs + row * BT_LD + col, b_ok ? B + (size_t)(n0 + row) * K + gc : B, b_ok);
  }
}

__global__ void __launch_bounds__(THREADS)
dgrad_kernel(const vf::bf16* __restrict__ A, const vf::bf16* __restrict__ B,
             const vf::bf16* __restrict__ res, vf::bf16* __restrict__ out, int M, int N,
             int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  vf::bf16* As = reinterpret_cast<vf::bf16*>(smem);
  vf::bf16* Bs = As + STAGES * STAGE_ELEMS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nkt = (K + BK - 1) / BK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkt)
      load_tile(As + s * STAGE_ELEMS, Bs + s * STAGE_ELEMS, A, B, M, N, K, m0, n0, s * BK, tid);
    vf::cp_async_commit();
  }

  for (int kt = 0; kt < nkt; ++kt) {
    vf::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt-1
    const int nt = kt + STAGES - 1;
    if (nt < nkt) {
      const int s = nt % STAGES;
      load_tile(As + s * STAGE_ELEMS, Bs + s * STAGE_ELEMS, A, B, M, N, K, m0, n0, nt * BK,
                tid);
    }
    vf::cp_async_commit();

    const vf::bf16* a_s = As + (kt % STAGES) * STAGE_ELEMS;
    const vf::bf16* b_s = Bs + (kt % STAGES) * STAGE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, vf::bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, vf::bf16, wmma::col_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], a_s + (wm * 64 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b_s + (wn * 32 + j * 16) * BT_LD + kk, BT_LD);
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
        for (int e = 0; e < 8; ++e) v[e] = vf::round_bf16(stage[r * EPI_LD + c8 + e]);
        if (res) {
          vf::load8(res + (size_t)row * N + col, t);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += t[e];
        }
        vf::store8(out + (size_t)row * N + col, v);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// out [M, N] = a [M, K] @ (b stored [N, K])^T (+ res [M, N]), bf16.
extern "C" int vf_gemm_dgrad(const void* a, const void* b, const void* res, void* out, int M,
                             int N, int K, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(dgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    configured = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dgrad_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const vf::bf16*>(a), static_cast<const vf::bf16*>(b),
      static_cast<const vf::bf16*>(res), static_cast<vf::bf16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

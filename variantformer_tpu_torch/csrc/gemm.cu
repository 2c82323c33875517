// gemm_bf16: out[M, N] = round(round(round(A @ B) + bias) + residual), bf16.
//
// Replaces the projections inside the Pallas kernels of
// variantformer_tpu/ops/fused_encoder.py:_kernel and
// variantformer_tpu/ops/fused_modulator.py:_kernel. A is [M, K] row-major,
// B is [K, N] row-major (the JAX layout, weights [in, out]); both bf16,
// accumulation f32. bias [N] and residual [M, N] are optional (null).
//
// Bound by tensor-core operations at the main-path shapes. Design: 128x128
// output tile per block of 8 warps (2 x 4, 64x32 per warp, 4x2 wmma 16x16
// accumulators); K in steps of 32 through a 3-stage cp.async ring in
// shared memory, so the next tiles load while the current one multiplies.
// Rows beyond M and chunks beyond K or N are zero-filled on load and
// skipped on store. K and N must be multiples of 8 (16-byte chunks).

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int A_LD = BK + 8;  // padded rows: conflict-free fragment loads
constexpr int B_LD = BN + 8;
constexpr int A_STAGE = BM * A_LD;
constexpr int B_STAGE = BK * B_LD;
constexpr int SMEM_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
constexpr int EPI_LD = 16;  // per-warp 16x16 f32 staging in the epilogue

__device__ __forceinline__ void load_tile(vf::bf16* As, vf::bf16* Bs, const vf::bf16* A,
                                          const vf::bf16* B, int M, int N, int K, int m0,
                                          int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // A: 128 rows x 4 chunks
    int c = tid + i * THREADS;
    int row = c >> 2, col = (c & 3) * 8;
    int gr = m0 + row, gc = k0 + col;
    bool ok = gr < M && gc < K;
    const vf::bf16* src = ok ? A + (size_t)gr * K + gc : A;
    vf::cp_async16(As + row * A_LD + col, src, ok);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {  // B: 32 rows x 16 chunks
    int c = tid + i * THREADS;
    int row = c >> 4, col = (c & 15) * 8;
    int gr = k0 + row, gc = n0 + col;
    bool ok = gr < K && gc < N;
    const vf::bf16* src = ok ? B + (size_t)gr * N + gc : B;
    vf::cp_async16(Bs + row * B_LD + col, src, ok);
  }
}

__global__ void __launch_bounds__(THREADS)
gemm_bf16_kernel(const vf::bf16* __restrict__ A, const vf::bf16* __restrict__ B,
                 const vf::bf16* __restrict__ bias, const vf::bf16* __restrict__ res,
                 vf::bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  vf::bf16* As = reinterpret_cast<vf::bf16*>(smem);
  vf::bf16* Bs = As + STAGES * A_STAGE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int ktiles = (K + BK - 1) / BK;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ktiles)
      load_tile(As + s * A_STAGE, Bs + s * B_STAGE, A, B, M, N, K, m0, n0, s * BK, tid);
    vf::cp_async_commit();
  }

  for (int kt = 0; kt < ktiles; ++kt) {
    vf::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt-1
    int nt = kt + STAGES - 1;
    if (nt < ktiles) {
      int s = nt % STAGES;
      load_tile(As + s * A_STAGE, Bs + s * B_STAGE, A, B, M, N, K, m0, n0, nt * BK, tid);
    }
    vf::cp_async_commit();

    const vf::bf16* a_s = As + (kt % STAGES) * A_STAGE;
    const vf::bf16* b_s = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, vf::bf16, wmma::row_major> fa[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, vf::bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(fa[i], a_s + (wm * 64 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], b_s + kk * B_LD + wn * 32 + j * 16, B_LD);
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
      int row = m0 + wm * 64 + i * 16 + r;
      int col = n0 + wn * 32 + j * 16 + c8;
      if (row < M && col < N) {
        float v[8], t[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = vf::round_bf16(stage[r * EPI_LD + c8 + e]);
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
        vf::store8(out + (size_t)row * N + col, v);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" int vf_gemm_bf16(const void* a, const void* b, const void* bias, const void* res,
                            void* out, int M, int N, int K, void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         SMEM_BYTES);
    configured = true;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const vf::bf16*>(a), static_cast<const vf::bf16*>(b),
      static_cast<const vf::bf16*>(bias), static_cast<const vf::bf16*>(res),
      static_cast<vf::bf16*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

// Row-wise kernels of the encoder and modulator chains: layernorm, geglu,
// masked_mean_pool. All three are bound by bytes (one read of their input,
// one write of their output, a handful of flops per element) and move
// 16 bytes per thread per access.
//
// layernorm         replaces layer_norm inside the Pallas kernels
//                   (variantformer_tpu/ops/fused_encoder.py:_kernel l.107,
//                   fused_modulator.py:_kernel l.135): f32 mean and variance,
//                   (x - mean) * rsqrt(var + eps) * scale + bias, bf16 out.
//                   One warp per row; the row is read three times (mean,
//                   variance, output), the last two from L1.
// geglu             replaces the GeGLU gate (fused_encoder.py l.179-183,
//                   fused_modulator.py l.256-260): value * gelu(gate) over the
//                   [:half] | [half:] split, exact erf GELU (the Pallas kernels
//                   use tanh only because Mosaic has no erf). gelu(gate) is
//                   rounded to bf16 before the product, as in the plain version.
// masked_mean_pool  replaces the pool of fused_encoder.py:_kernel l.191-201:
//                   f32 sum of the first len rows / max(len, 1), bf16 out.
//                   Rows past len are never read, so a pad window is 0.

#include "common.cuh"

namespace {

constexpr int LN_WARPS = 8;

__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_kernel(const vf::bf16* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, vf::bf16* __restrict__ out, int rows, int E,
                 float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_WARPS + warp;
  if (row >= rows) return;
  const vf::bf16* xr = x + (size_t)row * E;
  vf::bf16* orow = out + (size_t)row * E;
  float v[8];

  float s = 0.0f;
  for (int c = lane * 8; c < E; c += 256) {
    vf::load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) s += v[e];
  }
  const float mean = vf::warp_sum(s) / E;

  float ss = 0.0f;
  for (int c = lane * 8; c < E; c += 256) {
    vf::load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float d = v[e] - mean;
      ss += d * d;
    }
  }
  const float rstd = rsqrtf(vf::warp_sum(ss) / E + eps);

  for (int c = lane * 8; c < E; c += 256) {
    vf::load8(xr + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = (v[e] - mean) * rstd * scale[c + e] + bias[c + e];
    vf::store8(orow + c, v);
  }
}

__global__ void geglu_kernel(const vf::bf16* __restrict__ f, vf::bf16* __restrict__ out,
                             int rows, int half) {
  const int chunks = half / 8;
  const long long total = (long long)rows * chunks;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / chunks;
    const int c = static_cast<int>(i % chunks) * 8;
    float val[8], gate[8];
    vf::load8(f + row * 2 * half + c, val);
    vf::load8(f + row * 2 * half + half + c, gate);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float g = gate[e];
      const float gelu = vf::round_bf16(0.5f * g * (1.0f + erff(g * 0.70710678118654752f)));
      val[e] = val[e] * gelu;
    }
    vf::store8(out + row * half + c, val);
  }
}

__global__ void masked_mean_pool_kernel(const vf::bf16* __restrict__ x,
                                        const int* __restrict__ tok_len,
                                        vf::bf16* __restrict__ out, int L, int E) {
  const int n = blockIdx.x;
  const int len = min(max(tok_len[n], 0), L);
  const float denom = static_cast<float>(max(tok_len[n], 1));
  const vf::bf16* xn = x + (size_t)n * L * E;
  for (int c = threadIdx.x * 8; c < E; c += blockDim.x * 8) {
    float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0}, v[8];
    for (int r = 0; r < len; ++r) {
      vf::load8(xn + (size_t)r * E + c, v);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += v[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] /= denom;
    vf::store8(out + (size_t)n * E + c, acc);
  }
}

}  // namespace

extern "C" int vf_layernorm(const void* x, const void* scale, const void* bias, void* out,
                            int rows, int E, float eps, void* stream) {
  dim3 grid((rows + LN_WARPS - 1) / LN_WARPS);
  layernorm_kernel<<<grid, LN_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const vf::bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<vf::bf16*>(out), rows, E, eps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vf_geglu(const void* f, void* out, int rows, int half, void* stream) {
  const long long total = (long long)rows * (half / 8);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  const int grid = static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
  geglu_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const vf::bf16*>(f), static_cast<vf::bf16*>(out), rows, half);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vf_masked_mean_pool(const void* x, const void* tok_len, void* out, int N, int L,
                                   int E, void* stream) {
  const int threads = E / 8 < 256 ? ((E / 8 + 31) / 32) * 32 : 256;
  masked_mean_pool_kernel<<<N, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const vf::bf16*>(x), static_cast<const int*>(tok_len),
      static_cast<vf::bf16*>(out), L, E);
  return static_cast<int>(cudaGetLastError());
}

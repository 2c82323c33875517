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
//
// The backward kernels of the recompute chains (fused_encoder.py
// _bwd_kernel, fused_modulator.py _bwd1_kernel / _bwd0_kernel):
//
// layernorm_bwd     dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat *
//                   xhat)), dxhat = dy * scale, statistics recomputed from x
//                   (one warp per row), plus up to two residual cotangents
//                   added in f32 before the single rounding; dscale =
//                   sum_rows(dy * xhat), dbias = sum_rows(dy) through
//                   per-block column partials and a second reduction pass
//                   (deterministic). The Pallas kernels carry these sums in
//                   VMEM across a sequential grid; blocks here run in no
//                   order.
// geglu_bwd         d(value) = dm * gelu(gate) (rounded as in the forward),
//                   d(gate) = dm * value * gelu'(gate) with the exact erf
//                   derivative Phi(g) + g * phi(g).
// masked_mean_pool_bwd  dx = dpool / max(len, 1) on the first len rows of a
//                   window and exactly 0 elsewhere.
// colsum            f32 column sums of a [rows, N] bf16 or f32 matrix (the
//                   bias gradients), by the same two passes.

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

__global__ void __launch_bounds__(LN_WARPS * 32)
layernorm_bwd_kernel(const vf::bf16* __restrict__ x, const vf::bf16* __restrict__ dy,
                     const float* __restrict__ scale, const vf::bf16* __restrict__ res_a,
                     const vf::bf16* __restrict__ res_b, vf::bf16* __restrict__ dx,
                     float* __restrict__ stats, int rows, int E, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * LN_WARPS + warp;
  if (row >= rows) return;
  const vf::bf16* xr = x + (size_t)row * E;
  const vf::bf16* dyr = dy + (size_t)row * E;
  float v[8], g[8], t[8];

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

  float m1 = 0.0f, m2 = 0.0f;  // mean(dxhat), mean(dxhat * xhat)
  for (int c = lane * 8; c < E; c += 256) {
    vf::load8(xr + c, v);
    vf::load8(dyr + c, g);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float dxh = g[e] * scale[c + e];
      m1 += dxh;
      m2 += dxh * (v[e] - mean) * rstd;
    }
  }
  m1 = vf::warp_sum(m1) / E;
  m2 = vf::warp_sum(m2) / E;

  for (int c = lane * 8; c < E; c += 256) {
    vf::load8(xr + c, v);
    vf::load8(dyr + c, g);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float xh = (v[e] - mean) * rstd;
      v[e] = rstd * (g[e] * scale[c + e] - m1 - xh * m2);
    }
    if (res_a) {
      vf::load8(res_a + (size_t)row * E + c, t);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += t[e];
    }
    if (res_b) {
      vf::load8(res_b + (size_t)row * E + c, t);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += t[e];
    }
    vf::store8(dx + (size_t)row * E + c, v);
  }
  if (lane == 0) {
    stats[2 * (size_t)row] = mean;
    stats[2 * (size_t)row + 1] = rstd;
  }
}

// Column partials over one split of the rows: block (256 columns, split),
// 8 warps striding the split's rows, lane c owning 8 columns. With stats
// set, accumulates dy * xhat into part_a and dy into part_b (LayerNorm);
// without, x into part_a only (colsum).
template <typename T>
__device__ __forceinline__ void load8_any(const T* p, float* out);

template <>
__device__ __forceinline__ void load8_any<vf::bf16>(const vf::bf16* p, float* out) {
  vf::load8(p, out);
}

template <>
__device__ __forceinline__ void load8_any<float>(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

template <typename T>
__global__ void __launch_bounds__(256)
column_partial_kernel(const T* __restrict__ y, const vf::bf16* __restrict__ x,
                      const float* __restrict__ stats, float* __restrict__ part_a,
                      float* __restrict__ part_b, int rows, int N, int rows_per_split) {
  __shared__ float red[2][8][256];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 256 + lane * 8;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(rows, r0 + rows_per_split);
  float acc_a[8] = {0, 0, 0, 0, 0, 0, 0, 0}, acc_b[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  float g[8], v[8];
  if (c < N) {
    for (int row = r0 + warp; row < r1; row += 8) {
      load8_any<T>(y + (size_t)row * N + c, g);
      if (stats) {
        const float mean = stats[2 * (size_t)row], rstd = stats[2 * (size_t)row + 1];
        vf::load8(x + (size_t)row * N + c, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          acc_a[e] += g[e] * (v[e] - mean) * rstd;
          acc_b[e] += g[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc_a[e] += g[e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    red[0][warp][lane * 8 + e] = acc_a[e];
    red[1][warp][lane * 8 + e] = acc_b[e];
  }
  __syncthreads();
  const int col = blockIdx.x * 256 + threadIdx.x;
  if (col < N) {
    float a = 0.0f, b = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      a += red[0][w][threadIdx.x];
      b += red[1][w][threadIdx.x];
    }
    part_a[(size_t)blockIdx.y * N + col] = a;
    if (part_b) part_b[(size_t)blockIdx.y * N + col] = b;
  }
}

__global__ void column_final_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int splits, int N) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= N) return;
  float s = 0.0f;
  for (int i = 0; i < splits; ++i) s += part[(size_t)i * N + col];
  out[col] = s;
}

__global__ void geglu_bwd_kernel(const vf::bf16* __restrict__ f, const vf::bf16* __restrict__ dm,
                                 vf::bf16* __restrict__ df, int rows, int half) {
  const int chunks = half / 8;
  const long long total = (long long)rows * chunks;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / chunks;
    const int c = static_cast<int>(i % chunks) * 8;
    float val[8], gate[8], d[8];
    vf::load8(f + row * 2 * half + c, val);
    vf::load8(f + row * 2 * half + half + c, gate);
    vf::load8(dm + row * half + c, d);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float g = gate[e];
      const float cdf = 0.5f * (1.0f + erff(g * 0.70710678118654752f));
      const float pdf = 0.39894228040143268f * __expf(-0.5f * g * g);
      const float gelu = vf::round_bf16(g * cdf);
      gate[e] = d[e] * val[e] * (cdf + g * pdf);
      val[e] = d[e] * gelu;
    }
    vf::store8(df + row * 2 * half + c, val);
    vf::store8(df + row * 2 * half + half + c, gate);
  }
}

__global__ void masked_mean_pool_bwd_kernel(const vf::bf16* __restrict__ dpool,
                                            const int* __restrict__ tok_len,
                                            vf::bf16* __restrict__ dx, int L, int E) {
  const int n = blockIdx.x;
  const int len = min(max(tok_len[n], 0), L);
  const float denom = static_cast<float>(max(tok_len[n], 1));
  const float zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int c = threadIdx.x * 8; c < E; c += blockDim.x * 8) {
    float v[8];
    vf::load8(dpool + (size_t)n * E + c, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] /= denom;
    for (int r = 0; r < L; ++r)
      vf::store8(dx + ((size_t)n * L + r) * E + c, r < len ? v : zero);
  }
}

}  // namespace

// stats: [rows, 2] f32 scratch; part: [2, splits, E] f32 scratch.
extern "C" int vf_layernorm_bwd(const void* x, const void* dy, const void* scale,
                                const void* res_a, const void* res_b, void* dx, void* dscale,
                                void* dbias, void* stats, void* part, int rows, int E,
                                float eps, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  layernorm_bwd_kernel<<<(rows + LN_WARPS - 1) / LN_WARPS, LN_WARPS * 32, 0, s>>>(
      static_cast<const vf::bf16*>(x), static_cast<const vf::bf16*>(dy),
      static_cast<const float*>(scale), static_cast<const vf::bf16*>(res_a),
      static_cast<const vf::bf16*>(res_b), static_cast<vf::bf16*>(dx),
      static_cast<float*>(stats), rows, E, eps);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  float* pa = static_cast<float*>(part);
  float* pb = pa + (size_t)splits * E;
  dim3 grid((E + 255) / 256, splits);
  column_partial_kernel<vf::bf16><<<grid, 256, 0, s>>>(
      static_cast<const vf::bf16*>(dy), static_cast<const vf::bf16*>(x),
      static_cast<const float*>(stats), pa, pb, rows, E, (rows + splits - 1) / splits);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  column_final_kernel<<<(E + 255) / 256, 256, 0, s>>>(pa, static_cast<float*>(dscale), splits, E);
  column_final_kernel<<<(E + 255) / 256, 256, 0, s>>>(pb, static_cast<float*>(dbias), splits, E);
  return static_cast<int>(cudaGetLastError());
}

// part: [splits, N] f32 scratch.
extern "C" int vf_colsum(const void* x, void* out, void* part, int rows, int N, int splits,
                         int x_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + 255) / 256, splits);
  const int per = (rows + splits - 1) / splits;
  float* pa = static_cast<float*>(part);
  if (x_f32)
    column_partial_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x), nullptr,
                                                      nullptr, pa, nullptr, rows, N, per);
  else
    column_partial_kernel<vf::bf16><<<grid, 256, 0, s>>>(
        static_cast<const vf::bf16*>(x), nullptr, nullptr, pa, nullptr, rows, N, per);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  column_final_kernel<<<(N + 255) / 256, 256, 0, s>>>(pa, static_cast<float*>(out), splits, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vf_geglu_bwd(const void* f, const void* dm, void* df, int rows, int half,
                            void* stream) {
  const long long total = (long long)rows * (half / 8);
  const long long blocks = (total + 255) / 256;
  const int grid = static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
  geglu_bwd_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const vf::bf16*>(f), static_cast<const vf::bf16*>(dm),
      static_cast<vf::bf16*>(df), rows, half);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vf_masked_mean_pool_bwd(const void* dpool, const void* tok_len, void* dx, int N,
                                       int L, int E, void* stream) {
  const int threads = E / 8 < 256 ? ((E / 8 + 31) / 32) * 32 : 256;
  masked_mean_pool_bwd_kernel<<<N, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const vf::bf16*>(dpool), static_cast<const int*>(tok_len),
      static_cast<vf::bf16*>(dx), L, E);
  return static_cast<int>(cudaGetLastError());
}

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

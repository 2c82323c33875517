// Row-wise kernels of the encoder and modulator chains: layernorm, geglu,
// masked_mean_pool. All three are bound by bytes (one read of their input,
// one write of their output, a handful of flops per element) and move
// 16 bytes per thread per access.
//
// layernorm         replaces layer_norm inside the Pallas kernels
//                   (variantformer_tpu/ops/fused_encoder.py:_kernel l.107,
//                   fused_modulator.py:_kernel l.135): f32 mean and variance,
//                   (x - mean) * rsqrt(var + eps) * scale + bias, bf16 out.
//                   Bound by bytes: one read and one write of [rows, E].
//                   Where E = 256 * NCH, NCH <= 8 (512 and 1536 on the main
//                   paths), layernorm_rows_kernel: a persistent grid
//                   (ops/kernels.py layernorm_plan), one warp a row at a
//                   time, lane l owning columns 8 l + 256 k; the row comes
//                   into registers by one 16-byte load a lane per chunk,
//                   DEPTH rows of a warp in flight (the next rows' loads
//                   are issued as soon as a row's registers are free, before
//                   this row is reduced); scale and bias are loaded once per
//                   lane, as 16-byte loads, and kept in registers for all
//                   the warp's rows. Mean and centred variance come from the
//                   registers in the general kernel's order (the same
//                   per-lane sums, warp_sum, divisions and rsqrtf), so both
//                   give the same bits. The general kernel (any other E, a
//                   multiple of 8): one warp per row, reading it three times
//                   (mean, variance, output, the last two from L1) and scale
//                   and bias as scalar loads; it ran at 45% of the byte bound
//                   at [43416, 1536].
// geglu             replaces the GeGLU gate (fused_encoder.py l.179-183,
//                   fused_modulator.py l.256-260): value * gelu(gate) over the
//                   [:half] | [half:] split, exact erf GELU (the Pallas kernels
//                   use tanh only because Mosaic has no erf). gelu(gate) is
//                   rounded to bf16 before the product, as in the plain version.
//                   The expression is vf::geglu (common.cuh), which the
//                   GEMM's fused FFN-in epilogue (gemm_sm90.cu layout 3)
//                   shares; this kernel is left to the backward's
//                   recomputations, which keep the pre-activation, and to
//                   widths whose halves are not whole 128-column tiles.
// masked_mean_pool  replaces the pool of fused_encoder.py:_kernel l.191-201:
//                   f32 sum of the first len rows / max(len, 1), bf16 out.
//                   Rows past len are never read, so a pad window is 0.
//
// The backward kernels of the recompute chains (fused_encoder.py
// _bwd_kernel, fused_modulator.py _bwd1_kernel / _bwd0_kernel):
//
// layernorm_bwd     replaces _ln_bwd (variantformer_tpu/ops/fused_encoder.py
//                   l.493-501) inside the Pallas backward kernels:
//                   dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat *
//                   xhat)), dxhat = dy * scale, plus up to two residual
//                   cotangents added in f32 before the single rounding;
//                   dscale = sum_rows(dy * xhat), dbias = sum_rows(dy), f32.
//                   One pass, bound by bytes: a persistent grid (a few
//                   blocks an SM, each a contiguous span of rows, from
//                   ops/kernels.py layernorm_bwd_plan), one warp a row at a
//                   time, x, dy and the residuals read once with 16-byte
//                   loads, the statistics recomputed in f32 from registers,
//                   the dscale/dbias sums kept in registers (48 + 48 at
//                   E=1536, 16 + 16 at E=512) and summed over the block's
//                   warps once at the end into one partial row per block;
//                   a second small pass sums those rows in block order
//                   (deterministic, no atomics, no statistics scratch).
//                   Bytes in flight: a warp issues every 16-byte load of
//                   its row (up to 4 x 6 a lane at E=1536) before it uses
//                   any, so 8 warps an SM ask for ~96 KB at a time, well
//                   above the ~25 KB an SM needs in flight for 3.35 TB/s
//                   at ~1 us of latency; a prefetch of the next row, or a
//                   cp.async.bulk row ring, would need registers or shared
//                   memory the 96 accumulators already take. The Pallas
//                   kernels carry the column sums in VMEM across a
//                   sequential grid; blocks here run in no order.
// geglu_bwd         d(value) = dm * gelu(gate) (rounded as in the forward),
//                   d(gate) = dm * value * gelu'(gate) with the exact erf
//                   derivative Phi(g) + g * phi(g).
// masked_mean_pool_bwd  dx = dpool / max(len, 1) on the first len rows of a
//                   window and exactly 0 elsewhere.
// colsum            f32 column sums of a [rows, N] bf16 or f32 matrix (the
//                   bias gradients): per-block column partials over row
//                   splits, then a second pass sums them in split order.

#include "common.cuh"

// Warps of a LayerNorm block, from ops/kernels.py (LN_WARPS), whose
// layernorm_bwd_plan lays rows out by the same value.
#ifndef VF_LN_WARPS
#error "build through ops/kernels.py, which defines VF_LN_WARPS"
#endif

namespace {

constexpr int LN_WARPS = VF_LN_WARPS;

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

__device__ __forceinline__ void load_scale8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// The main paths' LayerNorm: see the note at the top. Warp w of block i takes
// rows i * LN_WARPS + w + j * gridDim.x * LN_WARPS; slot d of its ring holds
// the row of step j = (its row count) % DEPTH.
template <int NCH, int MIN_BLOCKS>
__global__ void __launch_bounds__(LN_WARPS * 32, MIN_BLOCKS)
layernorm_rows_kernel(const vf::bf16* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ bias, vf::bf16* __restrict__ out, int rows,
                      float eps) {
  constexpr int E = NCH * 256;
  // rows of a warp in flight (4 NCH registers a row): no spill at any NCH
  constexpr int DEPTH = NCH <= 6 ? 3 : NCH == 7 ? 2 : 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = gridDim.x * LN_WARPS;
  float sc[NCH * 8], bi[NCH * 8];
#pragma unroll
  for (int k = 0; k < NCH; ++k) {
    load_scale8(scale + lane * 8 + k * 256, sc + 8 * k);
    load_scale8(bias + lane * 8 + k * 256, bi + 8 * k);
  }
  auto load_row = [&](uint4 (&r)[NCH], int row) {
    if (row < rows) {
      const vf::bf16* xr = x + (size_t)row * E + lane * 8;
#pragma unroll
      for (int k = 0; k < NCH; ++k) r[k] = *reinterpret_cast<const uint4*>(xr + k * 256);
    }
  };
  uint4 ring[DEPTH][NCH];
  const int row0 = blockIdx.x * LN_WARPS + warp;
#pragma unroll
  for (int d = 0; d < DEPTH; ++d) load_row(ring[d], row0 + d * stride);

  for (int base = row0; base < rows; base += DEPTH * stride) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {
      const int row = base + d * stride;
      if (row >= rows) break;
      float v[8];
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        vf::unpack8(ring[d][k], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[e];
      }
      const float mean = vf::warp_sum(s) / E;
      float ss = 0.0f;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        vf::unpack8(ring[d][k], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float c = v[e] - mean;
          ss += c * c;
        }
      }
      const float rstd = rsqrtf(vf::warp_sum(ss) / E + eps);
      vf::bf16* orow = out + (size_t)row * E + lane * 8;
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        vf::unpack8(ring[d][k], v);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (v[e] - mean) * rstd * sc[8 * k + e] + bi[8 * k + e];
        vf::store8(orow + k * 256, v);
      }
      load_row(ring[d], row + DEPTH * stride);  // the slot's next row
    }
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
    for (int e = 0; e < 8; ++e) val[e] = vf::geglu(val[e], gate[e]);
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

// One pass over a contiguous span of rows per block (layernorm_bwd_plan):
// lane l of a warp owns columns l * 8 + 256 k (k < NCH), so a row is one
// 16-byte load a lane per chunk of x, dy and each residual, all issued
// before the first use; dscale and dbias partials stay in registers across
// the warp's rows and meet the block's other warps once, in shared memory,
// at the end: one f32 partial row of each per block (part [2, blocks, E]).
template <int NCH>
__global__ void __launch_bounds__(LN_WARPS * 32, 1)
layernorm_bwd_kernel(const vf::bf16* __restrict__ x, const vf::bf16* __restrict__ dy,
                     const float* __restrict__ scale, const vf::bf16* __restrict__ res_a,
                     const vf::bf16* __restrict__ res_b, vf::bf16* __restrict__ dx,
                     float* __restrict__ part, int rows, int E, float eps, int per_block) {
  extern __shared__ float red[];  // [LN_WARPS][E]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * per_block, r1 = min(rows, r0 + per_block);
  float acc_a[NCH * 8], acc_b[NCH * 8];  // sum over rows of dy * xhat, of dy
#pragma unroll
  for (int i = 0; i < NCH * 8; ++i) acc_a[i] = acc_b[i] = 0.0f;

  for (int row = r0 + warp; row < r1; row += LN_WARPS) {
    const size_t off = (size_t)row * E;
    uint4 xr[NCH], gr[NCH], ra[NCH], rb[NCH];
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = lane * 8 + k * 256;
      if (c < E) {
        xr[k] = *reinterpret_cast<const uint4*>(x + off + c);
        gr[k] = *reinterpret_cast<const uint4*>(dy + off + c);
        if (res_a) ra[k] = *reinterpret_cast<const uint4*>(res_a + off + c);
        if (res_b) rb[k] = *reinterpret_cast<const uint4*>(res_b + off + c);
      }
    }
    float v[8], g[8], sc[8];
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      if (lane * 8 + k * 256 < E) {
        vf::unpack8(xr[k], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) s += v[e];
      }
    }
    const float mean = vf::warp_sum(s) / E;
    float ss = 0.0f;
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      if (lane * 8 + k * 256 < E) {
        vf::unpack8(xr[k], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) ss += (v[e] - mean) * (v[e] - mean);
      }
    }
    const float rstd = rsqrtf(vf::warp_sum(ss) / E + eps);

    float m1 = 0.0f, m2 = 0.0f;  // mean(dxhat), mean(dxhat * xhat)
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = lane * 8 + k * 256;
      if (c < E) {
        vf::unpack8(xr[k], v);
        vf::unpack8(gr[k], g);
        load_scale8(scale + c, sc);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = (v[e] - mean) * rstd;
          const float dxh = g[e] * sc[e];
          m1 += dxh;
          m2 += dxh * xh;
          acc_a[k * 8 + e] += g[e] * xh;
          acc_b[k * 8 + e] += g[e];
        }
      }
    }
    m1 = vf::warp_sum(m1) / E;
    m2 = vf::warp_sum(m2) / E;

#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = lane * 8 + k * 256;
      if (c < E) {
        vf::unpack8(xr[k], v);
        vf::unpack8(gr[k], g);
        load_scale8(scale + c, sc);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float xh = (v[e] - mean) * rstd;
          v[e] = rstd * (g[e] * sc[e] - m1 - xh * m2);
        }
        if (res_a) {
          vf::unpack8(ra[k], g);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += g[e];
        }
        if (res_b) {
          vf::unpack8(rb[k], g);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] += g[e];
        }
        vf::store8(dx + off + c, v);
      }
    }
  }

  // The block's warps meet in shared memory, summed in warp order: first
  // dscale's partial row, then dbias's.
  auto block_sum = [&](const float(&acc)[NCH * 8], int pass) {
#pragma unroll
    for (int k = 0; k < NCH; ++k) {
      const int c = lane * 8 + k * 256;
      if (c < E) {
#pragma unroll
        for (int e = 0; e < 8; ++e) red[warp * E + c + e] = acc[k * 8 + e];
      }
    }
    __syncthreads();
    for (int col = threadIdx.x; col < E; col += LN_WARPS * 32) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < LN_WARPS; ++w) sum += red[w * E + col];
      part[((size_t)pass * gridDim.x + blockIdx.x) * E + col] = sum;
    }
    __syncthreads();
  };
  block_sum(acc_a, 0);
  block_sum(acc_b, 1);
}

// Column partials of colsum over one split of the rows: block (256
// columns, split), 8 warps striding the split's rows, lane c owning 8
// columns.
template <typename T>
__device__ __forceinline__ void load8_any(const T* p, float* out);

template <>
__device__ __forceinline__ void load8_any<vf::bf16>(const vf::bf16* p, float* out) {
  vf::load8(p, out);
}

template <>
__device__ __forceinline__ void load8_any<float>(const float* p, float* out) {
  load_scale8(p, out);
}

template <typename T>
__global__ void __launch_bounds__(256)
column_partial_kernel(const T* __restrict__ y, float* __restrict__ part, int rows, int N,
                      int rows_per_split) {
  __shared__ float red[8][256];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 256 + lane * 8;
  const int r0 = blockIdx.y * rows_per_split;
  const int r1 = min(rows, r0 + rows_per_split);
  float acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  float g[8];
  if (c < N) {
    for (int row = r0 + warp; row < r1; row += 8) {
      load8_any<T>(y + (size_t)row * N + c, g);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] += g[e];
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[warp][lane * 8 + e] = acc[e];
  __syncthreads();
  const int col = blockIdx.x * 256 + threadIdx.x;
  if (col < N) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) a += red[w][threadIdx.x];
    part[(size_t)blockIdx.y * N + col] = a;
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

template <int NCH>
int launch_layernorm_bwd(const void* x, const void* dy, const void* scale, const void* res_a,
                         const void* res_b, void* dx, void* part, int rows, int E, float eps,
                         int blocks, int per_block, cudaStream_t s) {
  const int bytes = LN_WARPS * E * 4;
  static int configured = 48 * 1024;
  if (bytes > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        layernorm_bwd_kernel<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = bytes;
  }
  layernorm_bwd_kernel<NCH><<<blocks, LN_WARPS * 32, bytes, s>>>(
      static_cast<const vf::bf16*>(x), static_cast<const vf::bf16*>(dy),
      static_cast<const float*>(scale), static_cast<const vf::bf16*>(res_a),
      static_cast<const vf::bf16*>(res_b), static_cast<vf::bf16*>(dx), static_cast<float*>(part),
      rows, E, eps, per_block);
  return static_cast<int>(cudaGetLastError());
}

// part: [2, blocks, E] f32 scratch; blocks and per_block (rows a block)
// from the launch plan (ops/kernels.py layernorm_bwd_plan); E <= 2048.
extern "C" int vf_layernorm_bwd(const void* x, const void* dy, const void* scale,
                                const void* res_a, const void* res_b, void* dx, void* dscale,
                                void* dbias, void* part, int rows, int E, float eps, int blocks,
                                int per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 8 || E % 8 || E > 2048 || blocks < 1 || per_block < 1 ||
      (long long)(blocks - 1) * per_block >= rows || (long long)blocks * per_block < rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (E + 255) / 256;
  int err;
#define VF_LN_BWD(N) \
  launch_layernorm_bwd<N>(x, dy, scale, res_a, res_b, dx, part, rows, E, eps, blocks, per_block, s)
  if (chunks <= 1) err = VF_LN_BWD(1);
  else if (chunks <= 2) err = VF_LN_BWD(2);
  else if (chunks <= 3) err = VF_LN_BWD(3);
  else if (chunks <= 4) err = VF_LN_BWD(4);
  else if (chunks <= 6) err = VF_LN_BWD(6);
  else err = VF_LN_BWD(8);
#undef VF_LN_BWD
  if (err) return err;
  float* pa = static_cast<float*>(part);
  column_final_kernel<<<(E + 255) / 256, 256, 0, s>>>(pa, static_cast<float*>(dscale), blocks, E);
  column_final_kernel<<<(E + 255) / 256, 256, 0, s>>>(pa + (size_t)blocks * E,
                                                      static_cast<float*>(dbias), blocks, E);
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
    column_partial_kernel<float><<<grid, 256, 0, s>>>(static_cast<const float*>(x), pa, rows,
                                                      N, per);
  else
    column_partial_kernel<vf::bf16><<<grid, 256, 0, s>>>(static_cast<const vf::bf16*>(x), pa,
                                                         rows, N, per);
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

template <int NCH>
int launch_layernorm_rows(const void* x, const void* scale, const void* bias, void* out,
                          int rows, float eps, int blocks, cudaStream_t s) {
  // two blocks an SM while scale, bias and the ring fit 128 registers a lane
  layernorm_rows_kernel<NCH, (NCH <= 3 ? 2 : 1)><<<blocks, LN_WARPS * 32, 0, s>>>(
      static_cast<const vf::bf16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<vf::bf16*>(out), rows, eps);
  return static_cast<int>(cudaGetLastError());
}

// blocks and chunks from the launch plan (ops/kernels.py layernorm_plan):
// chunks = E / 256 (1..8) takes the register-resident kernel on a grid of
// `blocks`; chunks = 0 (any other E, a multiple of 8) the general kernel on
// blocks = ceil(rows / LN_WARPS).
extern "C" int vf_layernorm(const void* x, const void* scale, const void* bias, void* out,
                            int rows, int E, float eps, int blocks, int chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int want = E % 256 == 0 && E <= 2048 ? E / 256 : 0;
  if (E < 8 || E % 8 || rows < 1 || blocks < 1 || chunks != want ||
      (!chunks && (long long)blocks * LN_WARPS < rows))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (chunks) {
    case 1: return launch_layernorm_rows<1>(x, scale, bias, out, rows, eps, blocks, s);
    case 2: return launch_layernorm_rows<2>(x, scale, bias, out, rows, eps, blocks, s);
    case 3: return launch_layernorm_rows<3>(x, scale, bias, out, rows, eps, blocks, s);
    case 4: return launch_layernorm_rows<4>(x, scale, bias, out, rows, eps, blocks, s);
    case 5: return launch_layernorm_rows<5>(x, scale, bias, out, rows, eps, blocks, s);
    case 6: return launch_layernorm_rows<6>(x, scale, bias, out, rows, eps, blocks, s);
    case 7: return launch_layernorm_rows<7>(x, scale, bias, out, rows, eps, blocks, s);
    case 8: return launch_layernorm_rows<8>(x, scale, bias, out, rows, eps, blocks, s);
    default: break;
  }
  layernorm_kernel<<<blocks, LN_WARPS * 32, 0, s>>>(
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

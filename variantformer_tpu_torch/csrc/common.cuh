// Helpers shared by the port's CUDA kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vf {

typedef __nv_bfloat16 bf16;

// Round to bf16 and back: reproduces a bf16 intermediate of the JAX math.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One GeGLU output: value * gelu(gate), exact (erf) GELU rounded to bf16
// before the product, as the plain version rounds it. rowwise.cu's
// geglu_kernel and gemm_sm90.cu's layout 3 both call it, so the fused
// epilogue gives the two-launch chain's bits.
__device__ __forceinline__ float geglu(float value, float gate) {
  const float gelu = round_bf16(0.5f * gate * (1.0f + erff(gate * 0.70710678118654752f)));
  return value * gelu;
}

// 16-byte asynchronous copy global -> shared; zero-fills when !valid
// (src-size 0 reads nothing, so `src` only has to be some device address).
__device__ __forceinline__ void cp_async16(void* smem, const void* src, bool valid) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int size = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(size));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 bf16 of one 16-byte word, held in registers, as floats.
__device__ __forceinline__ void unpack8(uint4 raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// 8 bf16 <-> 8 floats through one 16-byte access. The word is loaded into a
// register first: unpacked where it lies in global memory, it would be read
// by four 4-byte loads.
__device__ __forceinline__ void load8(const bf16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  unpack8(raw, out);
}

__device__ __forceinline__ void store8(bf16* p, const float* in) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// 64 rows of HD bf16 (row r at src + (row0 + r) * row_stride) into a shared
// tile with leading dimension LD; rows at or past nrows are zero-filled.
template <int HD, int LD, int NTHREADS>
__device__ __forceinline__ void load_rows64(bf16* dst, const bf16* src, long long row_stride,
                                            int row0, int nrows, int tid) {
  constexpr int CHUNKS = HD / 8;
  for (int c = tid; c < 64 * CHUNKS; c += NTHREADS) {
    const int r = c / CHUNKS, col = (c % CHUNKS) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < nrows)
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = v;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace vf

// probes: the capability probes of scripts/mosaic_capability_probe.py
// (probe_48slice, probe_3dreshape, probe_48slice_bf16_matmul) as kernels
// for sm_90a, each one block on a few KB.
//
//   probe_48slice     out[:, 48h:48h+48] = x[:, 48h:48h+48] * (h + 1), h < 4,
//                     x [rows, 192] f32;
//   probe_3dreshape   out[r, d] = ((x[r, d] + x[r, 48+d]) + x[r, 96+d]) + x[r, 144+d],
//                     [rows, 192] -> [rows, 48] f32;
//   probe_48slice_bf16_matmul
//                     per head h < 4: s = q_h q_h^T with q_h = x[:, 48h:48h+48]
//                     (f32 accumulation), out[:, 16h:16h+16] = bf16(s[:, :16]),
//                     x [32, 192] -> [32, 64] bf16.
//
// On the TPU they asked whether Mosaic could slice lanes at 48-element
// offsets, split lanes in a reshape, and feed such slices to the MXU. Here
// the first two are 16-byte vector loads at 192-byte head offsets (bound by
// launch latency at these sizes). The third is the smallest wgmma program:
// q_h, zero-padded to the instruction's 64 rows and to K = 64, is staged in
// shared memory in the 128-byte-swizzled K-major layout TMA would write; the
// same tile serves as A (64 rows) and, in its stored K-major layout, as B
// (its first 32 rows: B[k, n] = q_h[n, k]); three m64n32k16 steps from
// shared-memory descriptors accumulate in f32 registers, and the first 16
// columns of rows < 32 are stored as bf16 from the accumulator layout.

#include "sm90.cuh"

namespace {

using namespace vf::sm90;

constexpr int WIDTH = 192, HEAD = 48, HEADS = 4;

__global__ void probe_48slice_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                                     int n4) {
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    const float s = static_cast<float>((i % (WIDTH / 4)) * 4 / HEAD + 1);
    float4 v = x[i];
    v.x *= s;
    v.y *= s;
    v.z *= s;
    v.w *= s;
    out[i] = v;
  }
}

__global__ void probe_3dreshape_kernel(const float* __restrict__ x, float* __restrict__ out,
                                       int rows) {
  for (int i = threadIdx.x; i < rows * (HEAD / 4); i += blockDim.x) {
    const int r = i / (HEAD / 4), d = (i % (HEAD / 4)) * 4;
    const float* row = x + static_cast<size_t>(r) * WIDTH + d;
    float4 s = *reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int h = 1; h < HEADS; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(row + h * HEAD);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(out + static_cast<size_t>(r) * HEAD + d) = s;
  }
}

// D[64, 32] (f32, 16 registers a thread) += A[64, 16] B[16, 32] (bf16).
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

constexpr int MM_ROWS = 32, MM_OUT = 16;

__global__ void __launch_bounds__(128)
probe_48bf16mm_kernel(const vf::bf16* __restrict__ x, vf::bf16* __restrict__ out) {
  __shared__ unsigned char raw[64 * 128 + 1024];
  vf::bf16* tile =
      reinterpret_cast<vf::bf16*>(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int h = 0; h < HEADS; ++h) {
    // 64 rows x 8 chunks of 16 bytes: q_h in rows < 32, chunks < 6; zeros elsewhere.
    for (int c = tid; c < 64 * 8; c += 128) {
      const int r = c >> 3, chunk = c & 7;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < MM_ROWS && chunk < HEAD / 8)
        v = *reinterpret_cast<const uint4*>(x + r * WIDTH + h * HEAD + chunk * 8);
      *reinterpret_cast<uint4*>(tile + r * 64 + (chunk ^ (r & 7)) * 8) = v;
    }
    fence_proxy_async();
    __syncthreads();

    float acc[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HEAD / 16; ++kk) {
      const uint64_t d = desc_sw128(tile + kk * 16, 16, 1024);
      wgmma_m64n32k16<0, 0>(acc, d, d);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);

    // Accumulator i of a thread: row 16 * warp + lane / 4 + 8 * ((i >> 1) & 1),
    // column 8 * (i >> 2) + 2 * (lane % 4) + (i & 1).
    if (warp < MM_ROWS / 16) {
#pragma unroll
      for (int i = 0; i < 2 * MM_OUT / 4; i += 2) {
        const int row = 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
        const int col = 8 * (i >> 2) + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(out + row * (HEADS * MM_OUT) + h * MM_OUT + col) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    }
    __syncthreads();  // the tile is restaged for the next head
  }
}

}  // namespace

extern "C" int vf_probe_48slice(const void* x, void* out, int rows, void* stream) {
  probe_48slice_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(out), rows * WIDTH / 4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vf_probe_3dreshape(const void* x, void* out, int rows, void* stream) {
  probe_3dreshape_kernel<<<1, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int vf_probe_48slice_bf16_matmul(const void* x, void* out, void* stream) {
  probe_48bf16mm_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const vf::bf16*>(x), static_cast<vf::bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

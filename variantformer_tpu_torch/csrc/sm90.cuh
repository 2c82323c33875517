// Hopper building blocks of the wgmma kernels (sm_90a): shared-memory
// matrix descriptors, wgmma synchronisation, mbarriers, TMA tile loads and
// the host-side tensor map.
//
// Every wgmma operand here is stored as TMA writes it with
// CU_TENSOR_MAP_SWIZZLE_128B: rows of 128 bytes (64 bf16), the eight 16-byte
// chunks of row r at chunk index (c ^ (r % 8)), eight rows to a 1024-byte
// atom, each tile 1024-byte aligned.
//
// The tensor map is encoded by cuTensorMapEncodeTiled, which lives in
// libcuda, not in the CUDA runtime. It is fetched at run time through
// cudaGetDriverEntryPoint(ByVersion), so the library links against nothing
// more than the other sources do.
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace vf {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of a 128-byte-swizzled operand tile starting at `tile`.
//   K-major operand (the contraction contiguous: rows are M or N): stride
//     byte offset 1024 (the next eight rows); the leading byte offset is
//     not read (1). A k16 step adds 32 bytes to the start.
//   MN-major operand (M or N contiguous: rows are K): stride byte offset
//     1024 (the next eight K rows); leading byte offset = the distance
//     between two 64-wide M/N column blocks. A k16 step adds 16 rows.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lead_bytes,
                                               uint32_t stride_bytes) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lead_bytes & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((stride_bytes & 0x3FFFF) >> 4) << 32;
  d |= 1ull << 62;  // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma region.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Generic-proxy writes to shared memory made visible to wgmma and TMA.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the tensor map at (inner, outer) element coordinates into
// shared memory; completion is counted in bytes on `bar`. Boxes reaching
// past the tensor are zero-filled.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess && p)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Tensor map of a row-major bf16 [rows, cols] array (row stride `cols`),
// read in boxes of 64 columns (128 bytes) by `box_rows` rows with the
// 128-byte swizzle. Needs a 16-byte aligned base and cols % 8 == 0.
inline bool make_map_sw128(CUtensorMap* map, const void* base, uint64_t rows, uint64_t cols,
                           uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace vf

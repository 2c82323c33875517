// The tile shapes and wgmma forms shared by the attention forward
// (attention_sm90.cu) and its backward (attention_bwd_sm90.cu).
//
// Every operand is a [64 rows][64 columns] bf16 box as TMA writes it with the
// 128-byte swizzle (sm90.cuh), which holds at most 64 bf16 columns. A 64-row
// tile of a head is HEAD_BOXES(HD) such boxes side by side in shared memory:
// one at head dim 48 and 64, two at 128 (columns 0-63, then 64-127). A 64-row
// tile times a 64-row tile over the head dim is a K-major x K-major product
// (S = Q K^T in the forward; S^T = K Q^T, dP = dO V^T and dP^T = V dO^T in
// the backward): HD / 16 k16 steps, four a box. A 64 x 64 tile of weights
// held in registers times a head tile read along its rows is a register-A x
// MN-major-B product, one per box, each into its own 64-column accumulator
// (O += P V; dV += P^T dO, dK += dS^T Q, dQ += dS K). At head dim 48 the
// boxes stay 64 wide: the K-major products take three k16 steps, and the
// MN-major ones produce 64 columns of which the last 16 are dropped.
//
// Accumulator i of a consumer thread (warp w of its warpgroup, lane l) is
// row 16 w + l / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (l % 4) +
// (i & 1). The wgmma A fragment of k16 step kk holds, in register r, columns
// 16 kk + 8 (r >> 1) + 2 (l % 4) + {0, 1} of row 16 w + l / 4 + 8 (r & 1):
// the accumulator pair (8 kk + 2 r, 8 kk + 2 r + 1), so an f32 tile packs
// pairwise into the A fragment of the next product.
#pragma once

#include <float.h>
#include <math.h>

#include "sm90.cuh"

namespace vf {
namespace attn {

using namespace vf::sm90;

constexpr int BQ = 64;                      // query rows of a work item (one wgmma M)
constexpr int KT = 64;                      // keys per tile
constexpr int TILE_ELEMS = 64 * 64;         // one [64 rows][64 columns] bf16 box
constexpr int TILE_BYTES = 2 * TILE_ELEMS;  // 8 KB
constexpr int MAX_KV_TILES = 12;            // a key chunk's K and V held whole: <= 768 keys

// 64-column boxes of a head's row: 1 for head dims up to 64, 2 for 128.
__host__ __device__ constexpr int head_boxes(int hd) { return (hd + 63) / 64; }

// Columns 8 c + 2 (l % 4) + k (k = 0, 1) of half row hr (row l / 4, or
// l / 4 + 8) of a head tile's accumulators acc[head_boxes][32]: box c / 8,
// register 4 (c % 8) + 2 hr + k.
#define VF_ACC(acc, c, hr, k) acc[(c) >> 3][4 * ((c)&7) + 2 * (hr) + (k)]
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

#define VF_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define VF_D32 VF_D8(0), VF_D8(8), VF_D8(16), VF_D8(24)
#define VF_W8(i)                                                                          \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]), "=f"(d[i + 4]), "=f"(d[i + 5]), \
      "=f"(d[i + 6]), "=f"(d[i + 7])
#define VF_W32 VF_W8(0), VF_W8(8), VF_W8(16), VF_W8(24)
#define VF_R32                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D[64, 64] (f32, 32 registers a thread) (+)= A[64, 16] B[16, 64], both from
// shared memory, both K-major. The first k16 step overwrites D and declares
// it written only: the scores it replaces were last set on divergent paths
// (the masks), and a wgmma that read them would be serialised by ptxas.
template <bool ACCUMULATE>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b) {
  if constexpr (ACCUMULATE) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VF_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : VF_D32
        : "l"(desc_a), "l"(desc_b), "r"(1));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VF_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : VF_W32
        : "l"(desc_a), "l"(desc_b), "r"(0));
  }
}

// D[64, 64] += A[64, 16] B[16, 64]: A in registers (the bf16 fragment,
// 4 registers of 2), B from shared memory, MN-major (read transposed).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VF_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : VF_D32
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

#undef VF_D8
#undef VF_D32
#undef VF_W8
#undef VF_W32
#undef VF_R32

// D = A B^T over the head dim for two 64-row head tiles (S = Q K^T, S^T =
// K Q^T, dP = dO V^T, dP^T = V dO^T): HD / 16 k16 steps, the first
// write-only; step kk reads columns 16 kk.. of the tile, in box kk / 4.
template <int HD>
__device__ __forceinline__ void issue_scores(float (&s)[32], const vf::bf16* a,
                                             const vf::bf16* b) {
  wgmma_m64n64k16_ss<false>(s, desc_sw128(a, 16, 1024), desc_sw128(b, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < HD / 16; ++kk) {
    const int off = (kk / 4) * TILE_ELEMS + (kk % 4) * 16;
    wgmma_m64n64k16_ss<true>(s, desc_sw128(a + off, 16, 1024), desc_sw128(b + off, 16, 1024));
  }
}

// D += A B for A the packed register fragment of a 64 x 64 f32 tile and B a
// box read along its 64 rows (the contraction): four k16 steps.
__device__ __forceinline__ void issue_reg_times_box(float (&d)[32], const uint32_t (&a)[16],
                                                    const vf::bf16* box) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    wgmma_m64n64k16_rs(d, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                       desc_sw128(box + kk * 16 * 64, TILE_BYTES, 1024));
}

// D_b += A B_b for each 64-column box b of a head tile read along its 64
// rows, D_b the box's accumulator.
template <int HB>
__device__ __forceinline__ void issue_reg_times_head(float (&d)[HB][32], const uint32_t (&a)[16],
                                                     const vf::bf16* tile) {
#pragma unroll
  for (int hb = 0; hb < HB; ++hb) issue_reg_times_box(d[hb], a, tile + hb * TILE_ELEMS);
}

// fence_regs over a head tile's accumulators.
template <int HB>
__device__ __forceinline__ void fence_acc(float (&d)[HB][32]) {
#pragma unroll
  for (int hb = 0; hb < HB; ++hb) fence_regs(d[hb]);
}

// The keys a query row attends to: kv_len, or all Sk when it is 0.
__device__ __forceinline__ int keys_of(int len, int Sk) { return len > 0 ? min(len, Sk) : Sk; }

// 2^x in one instruction (0 at -inf and far below).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to one packed bf16 pair (the A fragment's register).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pk = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&pk);
}

}  // namespace attn
}  // namespace vf

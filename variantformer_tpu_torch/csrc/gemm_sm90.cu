// gemm_sm90: the bf16 tensor-core GEMM of the forward chains and of the
// weight gradients, written for Hopper (TMA, mbarriers, wgmma).
//
//   layout 0 (gemm_bf16)   out[M, N] bf16 = round(round(round(A @ B) + bias) + residual)
//                          A [M, K] (K-major), B = W [K, N] (N-major, so
//                          wgmma reads B transposed).
//   layout 1 (gemm_wgrad)  out[M, N] f32 += A^T-stored @ B: A = X stored
//                          [K, M] (M-major, read transposed), B = dY [K, N]
//                          (N-major): dW = X^T dY, contracting the rows
//                          (up to ~80 000), added into an existing buffer;
//                          with the rows split, each split's f32 partial
//                          goes to a workspace [splits, M, N] and a second
//                          pass adds p_0 + p_1 + ... in split order into out.
//   layout 2 (gemm_dgrad)  out[M, N] bf16 = round(round(A @ B) + residual):
//                          A = dY [M, K] (K-major), B = W^T with W the
//                          forward weight stored [N, K] (K-major, so wgmma
//                          reads B untransposed): dX = dY W^T, W^T never made.
//   layout 3 (gemm_geglu)  out[M, N/2] bf16 = geglu(round(round(A @ B) + bias)):
//                          the FFN-in projection and its GeGLU in one launch,
//                          A and B = W [K, N] as in layout 0 (no weight
//                          repacked); N % 256 == 0. Output tile n' (128
//                          columns) takes its 256 accumulator columns from
//                          four [64 k][64 n] boxes of B at the value columns
//                          128 n' + {0, 64} and the gate columns N/2 + 128 n'
//                          + {0, 64}, with the bias pairs of the same
//                          columns; the consumers stage round(round(acc) +
//                          bias) as layout 0 does (the pre-activation's
//                          bits), and the epilogue warps, not the
//                          consumers, read value chunk c and gate chunk c +
//                          16 of each staged row and store vf::geglu of
//                          them (common.cuh, the expression rowwise.cu's
//                          geglu_kernel calls) as one 16-byte chunk of out:
//                          the [M, N] pre-activation is never written, and
//                          the tensor cores never wait on erff. At K = 512
//                          (the window encoder) the three warps' GeGLU sets
//                          the pace of a tile (~1.3x the GEMM alone there,
//                          still under gemm_bf16 + geglu); handing chunks of
//                          it to the consumers gained nothing (PERF.md).
//
// Replaces the projections, the weight-gradient products and the
// input-cotangent (matmul_t) products inside the Pallas kernels of
// variantformer_tpu/ops/fused_encoder.py (_kernel, _bwd_kernel) and
// variantformer_tpu/ops/fused_modulator.py (_kernel, _run_fwd_save,
// _bwd1_kernel, _bwd0_kernel), which carry each weight gradient in VMEM
// across a sequential grid. Hopper blocks run in no order,
// so dW is one GEMM over all rows, split along them only when [M, N] has
// too few tiles for the card; the splits' partial sums are added in a fixed
// order, so a weight gradient is the same bits from run to run.
//
// Bound by tensor-core operations at every main-path shape. Design: a
// persistent grid (the launch plan, ops/kernels.py gemm_plan, picks one
// block per SM at most and the split count) walks (tile, split) units with
// output tiles in groups of `group_m` tile rows, so that the A and B tiles
// in flight are reused from L2. Roles:
//   thread 0      the producer: keeps TMA loads (128-byte swizzle, zero
//                 fill past the edges) in flight into a ring of STAGES
//                 shared-memory stages with full/empty mbarriers;
//   warps 1-3     the bf16 epilogue (layouts 0, 2, 3): the residual (or
//                 the GeGLU) and the coalesced 16-byte stores of the tile
//                 the consumers staged in shared memory, while those run
//                 the next tile;
//   warpgroups 1, 2  the consumers: wgmma m64n256k16 with f32 accumulators
//                 on 64 rows each of the 128 x 256 tile, one k-tile of wgmma
//                 groups in flight (setmaxnreg moves registers to them);
//                 then round(round(acc) + bias) into the staging tile.
// Tiles: 128 x 256 x 64 at every shape (128-wide tiles at N = 512 were no
// faster, gemm_bench.py). The 64 KB staging tile leaves room for a ring of
// 3 stages of 48 KB; the weight gradients, which add their f32 sums into
// `out` from the consumers' registers, keep the same ring (a fourth stage
// gained them nothing). The split partials cost one f32 write and read of
// [splits, M, N] (gemm_bench.py). Rows past M and columns past N are not stored. Written
// straight from the accumulator layout (4-byte stores, 8 rows a warp), the
// bf16 epilogue had taken a third of each tile's time; staged but written
// by the consumers themselves, it still held the tensor cores idle.

#include "sm90.cuh"

namespace {

using namespace vf::sm90;

constexpr int BM = 128, BN = 256, BK = 64, THREADS = 384;
constexpr int CONSUMER_THREADS = 256, EPILOGUE_THREADS = 96;
constexpr int EPI_J = 8;      // 8-column groups per batch of loads in the f32 epilogue
constexpr int EPI_BATCH = 8;  // 16-byte residual loads in flight per epilogue thread

// The ring depth. A build may set it: gemm_bench.py times the weight
// gradient at 4 stages, which only a layout without the staging tile fits.
#ifndef VF_GEMM_STAGES
#define VF_GEMM_STAGES 3
#endif

template <int LAYOUT>
struct Ring {
  static constexpr int STAGES = VF_GEMM_STAGES;
  static constexpr int A_ELEMS = BM * BK;
  static constexpr int B_ELEMS = BK * BN;
  static constexpr int STAGE_BYTES = 2 * (A_ELEMS + B_ELEMS);
  static constexpr int STAGING_ELEMS = LAYOUT != 1 ? BM * BN : 0;  // the bf16 tile
  static constexpr int BARRIERS = 2 * STAGES + 2;
  static constexpr int SMEM_BYTES =
      STAGES * STAGE_BYTES + 2 * STAGING_ELEMS + 8 * BARRIERS + 1024;
};

// 8 bf16 held in a uint4 (element 0 in the low half of .x) as floats.
__device__ __forceinline__ void unpack8(uint4 raw, float* v) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The staging tile is [BM rows][BN] with each row's 16-byte chunks
// XOR-swizzled by row % 8, so that neither the accumulator-layout writes
// (8 rows a warp) nor the row reads conflict on banks.
__device__ __forceinline__ int staged_offset(int row, int chunk) {
  return row * BN + (chunk ^ (row & 7)) * 8;
}

// D[64, 256] (f32, 128 registers a thread) += A[64, 16] B[16, 256] (bf16).
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(TRANS_A), "n"(TRANS_B));
}

struct Unit {
  int m0, n0, kt0, kt1;
};

// Unit u: output tile u / splits in grouped order (group_m tile rows, all
// tile columns, column-major inside the group), contraction range u % splits.
__device__ __forceinline__ Unit unit_of(int u, int splits, int tiles_m, int tiles_n,
                                        int group_m, int ktiles, int per_split) {
  const int tile = u / splits, split = u - tile * splits;
  const int group = group_m * tiles_n;
  const int first_m = (tile / group) * group_m;
  const int rows = min(tiles_m - first_m, group_m);
  const int in_group = tile % group;
  Unit w;
  w.m0 = (first_m + in_group % rows) * BM;
  w.n0 = (in_group / rows) * BN;
  w.kt0 = split * per_split;
  w.kt1 = min(ktiles, w.kt0 + per_split);
  return w;
}

// Accumulator i of a consumer thread (warp w of its warpgroup, lane l): row
// 16 w + l / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (l % 4) + (i & 1)
// of the warpgroup's 64 x BN.

// The column of B (and of the bias) behind accumulator column c of the
// tile at n0: n0 + c, except in layout 3, whose value half comes from
// columns n0 / 2 + c and whose gate half from N / 2 + n0 / 2 + c - BN / 2.
template <int LAYOUT>
__device__ __forceinline__ int b_col(int n0, int c, int N) {
  if constexpr (LAYOUT == 3) return n0 / 2 + c + (c < BN / 2 ? 0 : N / 2 - BN / 2);
  return n0 + c;
}

// A consumer thread's bias pairs, one for each 8-column group of the tile,
// loaded before the main loop, which hides their latency.
template <int LAYOUT>
__device__ __forceinline__ void load_bias(uint32_t (&bias2)[BN / 8], const vf::bf16* bias,
                                          int n0, int lane, int N) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = b_col<LAYOUT>(n0, 8 * j + 2 * (lane & 3), N);
    bias2[j] = bias && col < N ? *reinterpret_cast<const uint32_t*>(bias + col) : 0u;
  }
}

// A consumer warpgroup's round(round(acc) + bias) into its 64 rows of the
// staging tile.
__device__ __forceinline__ void stage_tile(const float (&acc)[BN / 2],
                                           const uint32_t (&bias2)[BN / 8], bool has_bias,
                                           vf::bf16* staged, int row_base, int warp, int lane) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const float b0 = __uint_as_float(bias2[j] << 16);
    const float b1 = __uint_as_float(bias2[j] & 0xffff0000u);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row_base + 16 * warp + (lane >> 2) + 8 * h;
      float v0 = vf::round_bf16(acc[4 * j + 2 * h]);
      float v1 = vf::round_bf16(acc[4 * j + 2 * h + 1]);
      if (has_bias) {
        v0 += b0;
        v1 += b1;
      }
      *reinterpret_cast<__nv_bfloat162*>(staged + staged_offset(r, j) + 2 * (lane & 3)) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

// The epilogue warps' share of a staged tile: thread t moves chunk
// t % (BN / 8) of rows t / (BN / 8) + p * 96 / (BN / 8) in whole 16-byte
// chunks, a warp a whole row, adding the residual (EPI_BATCH loads in
// flight) where there is one. Rows past M and columns past N are skipped.
__device__ __forceinline__ void store_tile(const vf::bf16* staged, int t, int m0, int n0,
                                           const vf::bf16* __restrict__ res,
                                           vf::bf16* __restrict__ out, int M, int N) {
  constexpr int CH = BN / 8, STEP = EPILOGUE_THREADS / CH;  // 96 % CH == 0
  constexpr int ROWS = (BM + STEP - 1) / STEP;
  const int cc = t % CH, col = n0 + 8 * cc;
  if (col >= N) return;  // N % 8 == 0: a chunk is in or out whole
#pragma unroll 1
  for (int p0 = 0; p0 < ROWS; p0 += EPI_BATCH) {
    uint4 r16[EPI_BATCH];
#pragma unroll
    for (int p = 0; p < EPI_BATCH; ++p) {
      const int r = t / CH + (p0 + p) * STEP, row = m0 + r;
      r16[p] = make_uint4(0, 0, 0, 0);
      if (res && p0 + p < ROWS && r < BM && row < M)
        r16[p] = *reinterpret_cast<const uint4*>(res + static_cast<size_t>(row) * N + col);
    }
#pragma unroll
    for (int p = 0; p < EPI_BATCH; ++p) {
      const int r = t / CH + (p0 + p) * STEP, row = m0 + r;
      if (p0 + p >= ROWS || r >= BM || row >= M) continue;
      const uint4 v16 = *reinterpret_cast<const uint4*>(staged + staged_offset(r, cc));
      vf::bf16* o = out + static_cast<size_t>(row) * N + col;
      if (!res) {
        *reinterpret_cast<uint4*>(o) = v16;
        continue;
      }
      float v[8], rv[8];
      unpack8(v16, v);
      unpack8(r16[p], rv);
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] += rv[e];
      vf::store8(o, v);
    }
  }
}

// Layout 3's epilogue: out[row, n0 + 8 cc ..] = vf::geglu of value chunk cc
// and gate chunk cc + 16 of each staged row. Thread t takes chunk t % 16 of
// rows t / 16 + 6 p, so a warp stores two whole 256-byte rows of the
// 128-column output tile; rows past M are skipped (half % 128 == 0: no
// ragged columns).
__device__ __forceinline__ void store_geglu_tile(const vf::bf16* staged, int t, int m0, int n0,
                                                 vf::bf16* __restrict__ out, int M, int half) {
  constexpr int CH = BN / 16, STEP = EPILOGUE_THREADS / CH;
  const int cc = t % CH;
#pragma unroll 2
  for (int r = t / CH; r < BM && m0 + r < M; r += STEP) {
    float v[8], g[8];
    unpack8(*reinterpret_cast<const uint4*>(staged + staged_offset(r, cc)), v);
    unpack8(*reinterpret_cast<const uint4*>(staged + staged_offset(r, cc + CH)), g);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = vf::geglu(v[e], g[e]);
    vf::store8(out + static_cast<size_t>(m0 + r) * half + n0 + 8 * cc, v);
  }
}

// The f32 epilogue of the weight gradients: each accumulator pair added
// into `out`, or, when the rows are split, stored into this split's partial
// `part` (an [M, N] slice of the workspace); batches of EPI_J 8-column groups
// issue all their loads of `out` before using any. (Written with the split
// count as a run-time branch: ptxas then keeps a batch's loads ahead of its
// stores, as it does not when the unsplit path is compiled alone.)
__device__ __forceinline__ void epilogue_f32(const float (&acc)[BN / 2], int row0, int col0,
                                             int lane, float* __restrict__ out,
                                             float* __restrict__ part, int M, int N,
                                             int splits) {
  const bool row_ok[2] = {row0 < M, row0 + 8 < M};
#pragma unroll
  for (int j0 = 0; j0 < BN / 8; j0 += EPI_J) {
    float2 in[EPI_J][2];
#pragma unroll
    for (int j = 0; j < EPI_J; ++j) {
      const int col = col0 + 8 * (j0 + j) + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        in[j][h] = make_float2(0.0f, 0.0f);
        // N % 8 == 0: a column pair is in or out whole
        const size_t o = static_cast<size_t>(row0 + 8 * h) * N + col;
        if (splits == 1 && col < N && row_ok[h])
          in[j][h] = *reinterpret_cast<const float2*>(out + o);
      }
    }
#pragma unroll
    for (int j = 0; j < EPI_J; ++j) {
      const int col = col0 + 8 * (j0 + j) + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (col >= N || !row_ok[h]) continue;
        const size_t o = static_cast<size_t>(row0 + 8 * h) * N + col;
        const float v0 = acc[4 * (j0 + j) + 2 * h], v1 = acc[4 * (j0 + j) + 2 * h + 1];
        if (splits > 1) {
          *reinterpret_cast<float2*>(part + o) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<float2*>(out + o) = make_float2(in[j][h].x + v0, in[j][h].y + v1);
        }
      }
    }
  }
}

template <int LAYOUT>
__global__ void __launch_bounds__(THREADS, 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_b, const vf::bf16* __restrict__ bias,
                 const vf::bf16* __restrict__ res, void* __restrict__ out,
                 float* __restrict__ ws, int M, int N, int K, int splits, int per_split,
                 int group_m) {
  using R = Ring<LAYOUT>;
  extern __shared__ unsigned char raw[];
  unsigned char* base = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  vf::bf16* As = reinterpret_cast<vf::bf16*>(base);
  vf::bf16* Bs = As + R::STAGES * R::A_ELEMS;
  vf::bf16* staged = Bs + R::STAGES * R::B_ELEMS;
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + R::STAGING_ELEMS);
  uint64_t* empty = full + R::STAGES;
  uint64_t* tile_staged = empty + R::STAGES;  // the consumers staged a tile
  uint64_t* tile_freed = tile_staged + 1;     // the epilogue warps read it out

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_THREADS / 32);
    }
    mbar_init(tile_staged, CONSUMER_THREADS);
    mbar_init(tile_freed, EPILOGUE_THREADS);
    mbar_fence_init();
  }
  __syncthreads();

  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int ktiles = (K + BK - 1) / BK;
  const int units = tiles_m * tiles_n * splits;

  if (tid < 128) {
    setmaxnreg_dec<88>();
    if (tid == 0) {
      // The producer: every TMA load.
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, splits, tiles_m, tiles_n, group_m, ktiles, per_split);
        for (int kt = w.kt0; kt < w.kt1; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_arrive_tx(&full[stage], R::STAGE_BYTES);
          vf::bf16* a = As + stage * R::A_ELEMS;
          vf::bf16* b = Bs + stage * R::B_ELEMS;
          if (LAYOUT != 1) {
            tma_load_2d(a, &map_a, &full[stage], kt * BK, w.m0);  // [128 m][64 k]
          } else {
#pragma unroll
            for (int j = 0; j < BM / 64; ++j)  // [64 k][64 m] blocks
              tma_load_2d(a + j * 64 * BK, &map_a, &full[stage], w.m0 + 64 * j, kt * BK);
          }
          if (LAYOUT == 2) {
            tma_load_2d(b, &map_b, &full[stage], kt * BK, w.n0);  // [256 n][64 k]
          } else {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)  // [64 k][64 n] blocks
              tma_load_2d(b + j * 64 * BK, &map_b, &full[stage], b_col<LAYOUT>(w.n0, 64 * j, N),
                          kt * BK);
          }
          if (++stage == R::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (LAYOUT != 1 && tid >= 32) {
      // The epilogue warps: each staged tile out to global memory.
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const Unit w = unit_of(u, splits, tiles_m, tiles_n, group_m, ktiles, per_split);
        mbar_wait(tile_staged, phase);
        if constexpr (LAYOUT == 3)
          store_geglu_tile(staged, tid - 32, w.m0, w.n0 / 2, static_cast<vf::bf16*>(out), M,
                           N / 2);
        else
          store_tile(staged, tid - 32, w.m0, w.n0, res, static_cast<vf::bf16*>(out), M, N);
        mbar_arrive(tile_freed);
        phase ^= 1;
      }
    }
  } else {
    // The consumers: rows 64 * c .. 64 * c + 63 of each tile.
    setmaxnreg_inc<208>();
    const int c = tid / 128 - 1, warp = (tid % 128) / 32, lane = tid % 32;
    int stage = 0;
    uint32_t phase = 0, freed_phase = 1;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const Unit w = unit_of(u, splits, tiles_m, tiles_n, group_m, ktiles, per_split);
      float acc[BN / 2];
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      uint32_t bias2[BN / 8];
      if constexpr (LAYOUT != 1) load_bias<LAYOUT>(bias2, bias, w.n0, lane, N);
      int prev = -1;
      for (int kt = w.kt0; kt < w.kt1; ++kt) {
        mbar_wait(&full[stage], phase);
        // Every layout keeps consumer c's 64 rows (or 64 columns of A^T) at
        // the same offset: rows 64c.. of the [128][64] K-major box, or the
        // c-th [64 k][64 m] block. B is K-major ([256 n][64 k]) in layout 2
        // and N-major ([64 k][64 n] blocks) in the others.
        const vf::bf16* a = As + stage * R::A_ELEMS + c * 64 * BK;
        const vf::bf16* b = Bs + stage * R::B_ELEMS;
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t da = LAYOUT != 1 ? desc_sw128(a + kk * 16, 16, 1024)
                                          : desc_sw128(a + kk * 16 * 64, 64 * BK * 2, 1024);
          const uint64_t db = LAYOUT == 2 ? desc_sw128(b + kk * 16, 16, 1024)
                                          : desc_sw128(b + kk * 16 * 64, 64 * BK * 2, 1024);
          wgmma_m64n256k16<LAYOUT == 1, LAYOUT != 2>(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait<1>();  // the previous k-tile's products are done: free its stage
        fence_regs(acc);
        if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == R::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);

      if constexpr (LAYOUT != 1) {
        mbar_wait(tile_freed, freed_phase);  // the previous tile is out of the staging tile
        freed_phase ^= 1;
        stage_tile(acc, bias2, bias != nullptr, staged, 64 * c, warp, lane);
        mbar_arrive(tile_staged);
      } else {
        epilogue_f32(acc, w.m0 + 64 * c + 16 * warp + (lane >> 2), w.n0, lane,
                     static_cast<float*>(out), ws + static_cast<size_t>(u % splits) * M * N,
                     M, N, splits);
      }
    }
  }
}

// out[i] += ws[0][i] + ws[1][i] + ... + ws[splits - 1][i], four columns a
// thread (M * N is a multiple of 8).
__global__ void split_sum_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                 long long n4, int splits) {
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 s = w4[i];
    for (int sp = 1; sp < splits; ++sp) {
      const float4 p = w4[sp * n4 + i];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    const float4 o = o4[i];
    o4[i] = make_float4(o.x + s.x, o.y + s.y, o.z + s.z, o.w + s.w);
  }
}

template <int LAYOUT>
int launch(const CUtensorMap& map_a, const CUtensorMap& map_b, const void* bias,
           const void* res, void* out, void* ws, int M, int N, int K, int splits, int per_split,
           int blocks, int group_m, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaFuncSetAttribute(gemm_sm90_kernel<LAYOUT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         Ring<LAYOUT>::SMEM_BYTES);
    configured = true;
  }
  gemm_sm90_kernel<LAYOUT><<<blocks, THREADS, Ring<LAYOUT>::SMEM_BYTES, stream>>>(
      map_a, map_b, static_cast<const vf::bf16*>(bias), static_cast<const vf::bf16*>(res),
      out, static_cast<float*>(ws), M, N, K, splits, per_split, group_m);
  const int err = static_cast<int>(cudaGetLastError());
  if (err || splits == 1) return err;
  const long long n4 = static_cast<long long>(M) * N / 4;
  const long long want = (n4 + 255) / 256;
  split_sum_kernel<<<static_cast<int>(want < 132 * 8 ? want : 132 * 8), 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), n4, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// layout 0: forward, a = A [M, K], b = W [K, N], bf16 out with bias and residual;
// layout 1: wgrad, a = X [K, M], b = dY [K, N], f32 out added into; with
//           splits > 1, ws is an f32 workspace [splits, M, N] (else unused);
// layout 2: dgrad, a = dY [M, K], b = W [N, K], bf16 out with residual (bias null);
// layout 3: FFN-in + GeGLU, a = A [M, K], b = W [K, N], bf16 out [M, N/2] with
//           bias, no residual; N % 256 == 0.
// splits, per_split (k-tiles of 64 per split), blocks and group_m come from
// the launch plan. Returns cudaErrorInvalidValue when a tensor map cannot
// be made or the plan does not fit the layout.
extern "C" int vf_gemm_sm90(const void* a, const void* b, const void* bias, const void* res,
                            void* out, int M, int N, int K, int layout, int splits,
                            int per_split, int blocks, int group_m, void* ws, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map_a, map_b;
  const bool ok = (layout == 1 ? make_map_sw128(&map_a, a, K, M, 64)
                               : make_map_sw128(&map_a, a, M, K, BM)) &&
                  (layout == 2 ? make_map_sw128(&map_b, b, N, K, BN)
                               : make_map_sw128(&map_b, b, K, N, 64));
  if (!ok || (layout != 1 && splits != 1) || (splits > 1 && !ws) || (layout == 3 && N % BN))
    return static_cast<int>(cudaErrorInvalidValue);
  if (layout == 0)
    return launch<0>(map_a, map_b, bias, res, out, nullptr, M, N, K, 1, per_split, blocks,
                     group_m, s);
  if (layout == 3)
    return launch<3>(map_a, map_b, bias, nullptr, out, nullptr, M, N, K, 1, per_split, blocks,
                     group_m, s);
  if (layout == 2)
    return launch<2>(map_a, map_b, nullptr, res, out, nullptr, M, N, K, 1, per_split, blocks,
                     group_m, s);
  if (layout == 1)
    return launch<1>(map_a, map_b, bias, res, out, ws, M, N, K, splits, per_split, blocks,
                     group_m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

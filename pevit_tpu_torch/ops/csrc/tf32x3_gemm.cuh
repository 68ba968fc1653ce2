// The float32 GEMM main loop on Hopper's tensor cores (3xTF32, see
// tf32x3.cuh), for the fused MLP's float32 bodies.
//
// A block of 8 warps owns X3_BM = 128 rows and 16 NT output columns of
// C = A . B (NT = X3_NT = 8 unless a kernel asks for a narrower tile); the
// warps form a 4 x 2 grid, each owning 32 rows and 8 NT columns as 2 x NT
// tiles of m16n8k8.  K advances X3_BK = 32 at a time through a ring of
// X3_STAGES shared-memory stages filled by 16-byte cp.async, so the copies
// of the next stages overlap this one's products.  A is row-major (R x K, K
// contiguous; rows past R are clamped on load and never stored); B is
// row-major (K x N, N contiguous): the forward's weights as they lie, the
// backward's transposed copies.  Any K and N that fill whole 16-byte
// chunks are taken: the chunks past K (of A and B) and past N (of B) are
// zero-filled in shared memory and never read, and the epilogues store no
// column past N.  Each operand element is split into its
// TF32 hi and lo parts in registers as its fragment is loaded from shared
// memory (32-bit loads: A tiles are padded to a row stride of 36 floats and
// B tiles to 16 NT + 8, so that the 32 lanes of a fragment load hit 32
// banks).

#pragma once

#include "tf32x3.cuh"
#include "wgmma_gemm.cuh"

namespace {

constexpr int X3_THREADS = 256;                  // 8 warps
constexpr int X3_BM = 128;                       // rows per tile
constexpr int X3_BK = 32;                        // K per stage
constexpr int X3_STAGES = 3;
constexpr int X3_WM = 4;                         // warps along the rows
constexpr int X3_WN = 8 / X3_WM;                 // warps along the columns
constexpr int X3_MT = X3_BM / X3_WM / 16;        // m16 tiles a warp
constexpr int X3_NT = 8;                         // n8 tiles a warp, unless asked otherwise
constexpr int X3_BN = X3_NT * X3_WN * 8;         // output columns per tile: 128
constexpr int X3_LDA = X3_BK + 4;                // A tile row stride, floats

// B tile row stride and floats per stage, for tiles of NT n8 tiles a warp
template <int NT>
__host__ __device__ constexpr int x3_ldb() { return NT * X3_WN * 8 + 8; }
template <int NT>
__host__ __device__ constexpr int x3_stage() { return X3_BM * X3_LDA + X3_BK * x3_ldb<NT>(); }

// whether a GEMM over K with N output columns in tiles of 16 NT has a
// partial last k-step or column tile (the TAILS instantiations)
template <int NT = X3_NT>
bool x3_tails(int K, int N) { return K % X3_BK != 0 || N % (NT * X3_WN * 8) != 0; }

// dynamic shared memory of a kernel running x3_gemm_mainloop: 105 KB at
// NT = 8, 81 KB at NT = 4
template <int NT = X3_NT>
constexpr size_t x3_gemm_smem_bytes() {
  return (size_t)X3_STAGES * x3_stage<NT>() * sizeof(float);
}

// Row and column, in the block's tile, of accumulator j of tile (mi, ni)
__device__ __forceinline__ int x3_row(int mi, int j) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp / X3_WN) * (16 * X3_MT) + 16 * mi + (lane >> 2) + 8 * (j >> 1);
}
template <int NT = X3_NT>
__device__ __forceinline__ int x3_col(int ni, int j) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp % X3_WN) * (8 * NT) + 8 * ni + 2 * (lane & 3) + (j & 1);
}

// acc[mi][ni] (this thread's part of the block's 128 x 16 NT tile, placed
// as x3_row and x3_col<NT> say) = A[row0 .. row0 + 128, :K] . B[:K, n0 ..
// n0 + 16 NT] of N columns; K and N multiples of 4 (every row of A and B
// 16-byte aligned), and K x ldb below 2^31.  UNROLL k-steps of 8 are
// unrolled together.  With TAILS (``x3_tails``) a last k-step past K and
// columns past N are zero-filled; without, K and N fill whole tiles.
template <int NT, int UNROLL, bool TAILS>
__device__ __forceinline__ void x3_gemm_mainloop(float (&acc)[X3_MT][NT][4],
                                                 const float* __restrict__ a, long long lda,
                                                 const float* __restrict__ b, long long ldb,
                                                 int row0, int R, int n0, int N, int K,
                                                 float* smem) {
  static_assert(NT == 4 || NT == 8, "tiles of 64 or 128 columns");
  constexpr int BN = NT * X3_WN * 8, LDB = x3_ldb<NT>(), STAGE = x3_stage<NT>();
  constexpr int B_SHIFT = NT == 8 ? 5 : 4;      // log2 of a B row's 16-byte chunks
  const int ksteps = TAILS ? (K + X3_BK - 1) / X3_BK : K / X3_BK;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int warp = threadIdx.x >> 5, wm = warp / X3_WN, wn = warp % X3_WN;
#pragma unroll
  for (int mi = 0; mi < X3_MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  // offsets from the tile's corner fit 32 bits (128 rows of A, K rows of B)
  // and keep the copies' addresses out of 64-bit registers
  const float* a_tile = a + row0 * lda;
  const float* b_tile = b + n0;
  const int rows = R - row0, lda32 = (int)lda, ldb32 = (int)ldb;
  [[maybe_unused]] const int cols = N - n0;
  auto load_stage = [&](int ks) {
    float* sa = smem + (ks % X3_STAGES) * STAGE;
    float* sb = sa + X3_BM * X3_LDA;
    const int k0 = ks * X3_BK;
#pragma unroll
    for (int i = 0; i < X3_BM * X3_BK / 4 / X3_THREADS; ++i) {  // 128 rows x 8 chunks
      const int e = threadIdx.x + i * X3_THREADS;
      const int r = e >> 3, c = e & 7;
      const int at = min(r, rows - 1) * lda32 + k0 + c * 4;
      if constexpr (TAILS) {
        const bool valid = k0 + c * 4 < K;
        cp_async16_zfill(smem_u32(sa + r * X3_LDA + c * 4), a_tile + (valid ? at : 0), valid);
      } else {
        cp_async16(smem_u32(sa + r * X3_LDA + c * 4), a_tile + at);
      }
    }
#pragma unroll
    for (int i = 0; i < X3_BK * BN / 4 / X3_THREADS; ++i) {  // 32 rows x BN / 4 chunks
      const int e = threadIdx.x + i * X3_THREADS;
      const int r = e >> B_SHIFT, c = e & (BN / 4 - 1);
      if constexpr (TAILS) {
        const bool valid = k0 + r < K && c * 4 < cols;
        cp_async16_zfill(smem_u32(sb + r * LDB + c * 4),
                         b_tile + (valid ? (k0 + r) * ldb32 + c * 4 : 0), valid);
      } else {
        cp_async16(smem_u32(sb + r * LDB + c * 4), b_tile + ((k0 + r) * ldb32 + c * 4));
      }
    }
  };
#pragma unroll
  for (int s = 0; s < X3_STAGES - 1; ++s) {
    if (s < ksteps) load_stage(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int ks = 0; ks < ksteps; ++ks) {
    cp_async_wait<X3_STAGES - 2>();  // this thread's copies of step ks have landed
    __syncthreads();                 // everyone's have; step ks - 1's stage is free
    if (ks + X3_STAGES - 1 < ksteps) load_stage(ks + X3_STAGES - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const float* sa = smem + (ks % X3_STAGES) * STAGE + (wm * 16 * X3_MT + g) * X3_LDA + t;
    const float* sb = smem + (ks % X3_STAGES) * STAGE + X3_BM * X3_LDA + t * LDB + wn * 8 * NT + g;
    // UNROLL = 1 at NT = 8: fetching the next k-step's fragments early
    // would take registers past the 128 that two blocks an SM allow
#pragma unroll UNROLL
    for (int kk = 0; kk < X3_BK / 8; ++kk) {
      // the A fragments of every m-tile held, the B fragments split as used
      uint32_t a_hi[X3_MT][4], a_lo[X3_MT][4];
#pragma unroll
      for (int mi = 0; mi < X3_MT; ++mi) {
        const float* ap = sa + mi * 16 * X3_LDA + kk * 8;
        split_tf32(ap[0], a_hi[mi][0], a_lo[mi][0]);
        split_tf32(ap[8 * X3_LDA], a_hi[mi][1], a_lo[mi][1]);
        split_tf32(ap[4], a_hi[mi][2], a_lo[mi][2]);
        split_tf32(ap[8 * X3_LDA + 4], a_hi[mi][3], a_lo[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const float* bp = sb + kk * 8 * LDB + ni * 8;
        uint32_t b_hi[2], b_lo[2];
        split_tf32(bp[0], b_hi[0], b_lo[0]);
        split_tf32(bp[4 * LDB], b_hi[1], b_lo[1]);
#pragma unroll
        for (int mi = 0; mi < X3_MT; ++mi)
          mma_tf32x3(acc[mi][ni], a_hi[mi], a_lo[mi], b_hi, b_lo);
      }
    }
  }
}

}  // namespace

// Mask-free attention forward: out = softmax(q . k^T) . v per (batch, head).
//
// Replaces: pevit_tpu/ops/attention.py `_pallas_forward` (the Pallas kernel
// behind `_fused` / `attention_core`).  Same contract: q arrives already
// scaled by 1/sqrt(hd) with any PEFT delta added; logits, max, exp and sum in
// float32; the probabilities are normalised in float32 and rounded to the
// input type BEFORE the product with v (the reference rounds there, so an
// online softmax that normalises at the end would round differently in
// bf16); the product accumulates in float32 and the output is rounded once.
//
// What bounds it on an H100: the work is ~4*N*hd operations per query row
// against 4 * N * hd * elem bytes of q, k, v and out per head, i.e. ~N/elem
// bytes operations per byte: 25 at N = 50 in bf16, ~288 at N = 577, where
// it meets the ~295 at which the card turns compute-bound.  So at ViT-B
// shapes the bound is memory traffic (each of q, k, v, out read or written
// once), and at ViT-L/14 @ 336 px (N = 577) the two bounds meet.  In
// float32 the three TF32 products of each product (below) make the
// operations bound about as large as the bytes bound at N = 197.  Every
// body stages rows of q, k and v in shared memory by 16-byte copies, and
// takes q, k and v with (batch, token, head) strides, so the wrapper passes
// (B, N, H, hd) views of the packed qkv projection without copies.  Every
// N >= 1 is taken: the dtype picks the body, and in bf16 N does (the
// register body up to N = 257, where it is the faster, the long body
// beyond); no body falls back to another.
//
// bfloat16 register body, N <= 257 (tensor cores): one block per (batch,
// head), which reads the head's rows of q, k and v exactly once.  Bytes
// bound the kernel at these lengths, so the design aims to keep the
// arithmetic off the critical path and the loads wide:
//   * staging: q, k and v rows (128 contiguous bytes each) go to shared
//     memory by 16-byte cp.async, with the 16-byte chunks of a row XOR-
//     swizzled by (row & 7) so that ldmatrix reads are free of bank
//     conflicts; the keys are padded to a multiple of 16 (NP) with zero
//     rows (a padded v row must be zero: p = 0 times garbage may be NaN);
//   * logits: each warp owns a 16-query-row tile and computes S = Q K^T
//     with mma.sync m16n8k16 (bf16 in, float32 accumulators), operands by
//     ldmatrix; padded key columns are set to -inf;
//   * softmax: row max and sum in float32 across the 4 lanes of a quad
//     (shuffles); p = exp(s - max) / sum in float32, then rounded to bf16:
//     the rounded p of a 16-key tile is exactly the A fragment of P V, so it
//     never goes through shared memory;
//   * output: V fragments by ldmatrix.trans, float32 accumulators, rounded
//     once, staged in the warp's own q rows and written with 16-byte stores.
// The whole (16 x NP) float32 S tile lives in registers: at N = 257 (NP =
// 272) that is 136 per lane; P V consumes it 16 keys at a time.  ptxas
// fits the largest instantiations in 255 registers without spills, so one
// pass over K suffices (no second pass that recomputes S).  The key count
// is rounded up to one of four instantiations (NP = 64, 128, 208, 272),
// and no more fit: a longer row of S does not.
//
// bfloat16 long body, N > 257 (tensor cores, the same mma.sync, ldmatrix,
// swizzle and output staging as the register body).  The rounding point
// rules out a one-pass online softmax: p must be normalised by the row's
// final sum before it is rounded.  So the body holds one chunk's S (64
// keys, 32 floats a lane) and walks the keys three times: the exact row
// max, then the float32 row sum l of exp(s - max) (which differs from the
// reference's only in its order: each lane sums its columns, then the
// quad's 4 lanes by shuffles), then p = exp(s - max) / l, rounded to bf16,
// and O += P V.  The recomputed Q K^T costs operations, not bytes, and
// the ceiling on N is gone:
//   * grid: one block per (batch, head, tile of 64 query rows), 4 warps, a
//     warp per 16 query rows, so a head's queries spread over several SMs;
//     a warp whose rows all lie past N only takes part in the block's
//     copies and barriers;
//   * keys and values in chunks of 64 rows by 16-byte cp.async into two
//     swizzled buffers (K alone in the first two passes), the copies of
//     the next chunk in flight during the products of this one; each pass
//     starts on the chunk the last one ended on and keeps its S;
//   * p's division is a product by the correctly rounded 1 / l and its
//     exact residual (Markstein), the correctly rounded quotient;
//   * 40 KB of static shared memory; at ViT-B lengths it is slower than the
//     register body (three walks over the keys, two exponentials a logit),
//     so it runs only where that one cannot.
//
// float32 body (tensor cores, 3xTF32: tf32x3.cuh).  TF32 mma.sync m16n8k8
// with each product split in three, so it stays float32-class (not TF32:
// see tf32x3.cuh).  The split triples the products and adds the splits and
// the rounded adds of the partial sums, so instruction throughput and
// latency bound the body, not bytes; it is built for warps in flight:
//   * grid: one block per (batch, head, tile of 64 query rows), 4 warps, a
//     warp per 16 query rows; a warp whose rows all lie past N only takes
//     part in the block's copies and barriers;
//   * q: the block's rows staged by 16-byte cp.async, then each warp's
//     fragments split once into registers (64 of them);
//   * keys in chunks of 32 through two shared-memory buffers (K rows, then V
//     rows, 16-byte cp.async, a row stride of 68 floats so that the 32 lanes
//     of a 32-bit fragment load hit 32 banks; rows past N zero): the copies
//     of chunk c + 1 overlap the products of chunk c;
//   * per chunk: S = Q K^T, 8-key tiles that hold no key below N skipped
//     and padded columns set to -inf; an online softmax in float32 with
//     quad shuffles (running row max m, sum l, the output rescaled by
//     exp(m_old - m_new)); O += P V;
//   * P V: a lane's S accumulators hold keys 2t and 2t + 1 of each 8-key
//     step, where the A fragment wants keys t and t + 4.  Nothing is
//     shuffled: A's k-index t stands for key 2t and t + 4 for key 2t + 1,
//     and V's B fragment rows are loaded in that same order; the sum over
//     the keys does not depend on it;
//   * output: O / l, stored as 8-byte pairs.  The reference normalises p
//     before the product because it rounds p to v's type there; in float32
//     that rounding is the identity, so dividing once at the end differs
//     only in float32 rounding.
// One kernel takes every N, in 34 KB of shared memory and registers for two
// blocks an SM (three would leave ptxas too few, and it spills).  Keeping
// the whole (16 x N) S tile in registers, as the bf16 body does, would take
// over 200 registers at N = 197 on top of the split's, and keys in chunks
// spend them on q's fragments instead, split once.

// Above 48 KB of dynamic shared memory the bf16 launcher raises the
// kernel's limit with cudaFuncSetAttribute first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int HD = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int QROWS = WARPS * 16;  // query rows a block (the fp32 and the long bf16 body)
// the longest sequence the bf16 register body takes (its S row in registers)
constexpr int MAX_SEQ_REGS = 257;

// ---------------------------------------------------------------------------
// bfloat16 body (tensor cores); its copy and quad helpers serve both bodies
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8, float32) += a (16x16, bf16, row) . b (16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// element offset of 16-byte chunk c (0..7) of row r in a swizzled 64-wide tile
__device__ __forceinline__ int swz(int r, int c) { return r * HD + ((c ^ (r & 7)) << 3); }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows [0, N) of one head into a swizzled (NP x 64) tile, rows [N, NP) zero
template <int NP>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long sn, int N) {
  for (int e = threadIdx.x; e < NP * 8; e += THREADS) {
    const int r = e >> 3, c = e & 7;
    bf16* d = dst + swz(r, c);
    if (r < N)
      cp_async16(smem_u32(d), src + r * sn + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// KT: 16-key tiles held in registers (NP = 16 KT >= N)
template <int KT>
__global__ void __launch_bounds__(THREADS)
attention_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ out, int H, int N,
                   long long qsb, long long qsn, long long qsh,
                   long long ksb, long long ksn, long long ksh,
                   long long vsb, long long vsn, long long vsh) {
  constexpr int NP = 16 * KT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + NP * HD;
  bf16* v_s = k_s + NP * HD;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  stage_rows<NP>(q_s, q + b * qsb + h * qsh, qsn, N);
  stage_rows<NP>(k_s, k + b * ksb + h * ksh, ksn, N);
  stage_rows<NP>(v_s, v + b * vsb + h * vsh, vsn, N);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int n_tiles = (N + 15) >> 4;
  for (int qt = warp; qt < n_tiles; qt += WARPS) {
    // Q fragments: 4 steps of 16 along hd
    uint32_t qa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int r = qt * 16 + (lane & 15);
      ldmatrix_x4(qa[kk], smem_u32(q_s + swz(r, 2 * kk + (lane >> 4))));
    }

    // S = Q K^T: n8 tile j covers keys 8j..8j+7
    float s[2 * KT][4];
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const int r = kt * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_u32(k_s + swz(r, 2 * kk + ((lane >> 3) & 1))));
        mma_16816(s[2 * kt], qa[kk], kb[0], kb[1]);
        mma_16816(s[2 * kt + 1], qa[kk], kb[2], kb[3]);
      }
    }

    // softmax in float32; a lane holds rows g (s[j][0..1]) and g + 8
    // (s[j][2..3]), columns 8j + 2t and 8j + 2t + 1
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) {
      const int col = 8 * j + 2 * t;
      if (col >= N) s[j][0] = s[j][2] = -INFINITY;
      if (col + 1 >= N) s[j][1] = s[j][3] = -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * KT; ++j) {
      s[j][0] = expf(s[j][0] - mx0);
      s[j][1] = expf(s[j][1] - mx0);
      s[j][2] = expf(s[j][2] - mx1);
      s[j][3] = expf(s[j][3] - mx1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    sum0 = quad_sum(sum0);
    sum1 = quad_sum(sum1);

    // O = P V, 16 keys at a time; p normalised in float32, then rounded
    float o[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kt][0] / sum0, s[2 * kt][1] / sum0),
          pack_bf16(s[2 * kt][2] / sum1, s[2 * kt][3] / sum1),
          pack_bf16(s[2 * kt + 1][0] / sum0, s[2 * kt + 1][1] / sum0),
          pack_bf16(s[2 * kt + 1][2] / sum1, s[2 * kt + 1][3] / sum1)};
      const int r = kt * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_u32(v_s + swz(r, 2 * dn + (lane >> 4))));
        mma_16816(o[2 * dn], pa, vb[0], vb[1]);
        mma_16816(o[2 * dn + 1], pa, vb[2], vb[3]);
      }
    }

    // round once, stage in this warp's own q rows, 16-byte stores
    __syncwarp();
    const int r0 = qt * 16 + (lane >> 2), r1 = r0 + 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(q_s + swz(r0, j) + 2 * t) = pack_bf16(o[j][0], o[j][1]);
      *reinterpret_cast<uint32_t*>(q_s + swz(r1, j) + 2 * t) = pack_bf16(o[j][2], o[j][3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = lane + 32 * i;
      const int r = qt * 16 + (e >> 3), c = e & 7;
      if (r < N)
        *reinterpret_cast<uint4*>(out + (((size_t)b * N + r) * H + h) * HD + c * 8) =
            *reinterpret_cast<const uint4*>(q_s + swz(r, c));
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 body for N > 257 (tensor cores, keys in chunks, three passes)
// ---------------------------------------------------------------------------

constexpr int KCHUNK = 64;         // keys per chunk
constexpr int TILE = KCHUNK * HD;  // bf16 elements of one 64-row tile
static_assert(QROWS == KCHUNK, "q, k and v tiles share one staging routine");

// rows [r0, r0 + 64) of one head into a swizzled 64-row tile; rows at or
// past N are zero (a zero v row keeps p = 0 from meeting garbage, which may
// be NaN; a zero k row keeps the logits finite before the mask)
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src, long long sn, int r0,
                                           int N) {
  for (int e = threadIdx.x; e < KCHUNK * 8; e += THREADS) {
    const int r = e >> 3, c = e & 7;
    bf16* d = dst + swz(r, c);
    if (r0 + r < N)
      cp_async16(smem_u32(d), src + (r0 + r) * sn + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// e / l rounded to nearest from rl, the correctly rounded 1 / l: a product
// and its exact residual (Markstein's correction) give the correctly
// rounded quotient wherever it is a normal float, as e / l would, in three
// instructions instead of a division's dozen
__device__ __forceinline__ float div_rn(float e, float l, float rl) {
  const float q = e * rl;
  return fmaf(fmaf(-q, l, e), rl, q);
}

// One block per (batch, head, tile of 64 query rows), a warp per 16 rows.
// Three passes over the key chunks: 0 the row max m (exact: a max does not
// depend on order), 1 the row sum l of exp(s - m) in float32, 2 p = exp(s -
// m) / l rounded to bf16 and O += P V.  Pass 1 walks the chunks backwards,
// so each pass starts on the chunk the last one ended on and takes its S
// from registers instead of recomputing it.  The chunks stream through two
// buffers by cp.async, the copies of iteration i + 1 in flight during the
// products of iteration i (K alone in passes 0 and 1, K and V in pass 2).
// It takes any N; the launcher gives it N > 257.
__global__ void __launch_bounds__(THREADS, 4)
attention_fwd_bf16_long(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ out, int H, int N,
                        int q_tiles, long long qsb, long long qsn, long long qsh,
                        long long ksb, long long ksn, long long ksh,
                        long long vsb, long long vsn, long long vsh) {
  __shared__ __align__(128) bf16 q_s[TILE];
  __shared__ __align__(128) bf16 kv_s[2][2 * TILE];  // a buffer: K rows, then V rows

  const int bh = blockIdx.x / q_tiles, qt = blockIdx.x - bh * q_tiles;
  const int b = bh / H, h = bh - b * H;
  const int r0 = qt * QROWS;
  const bf16* kh = k + b * ksb + h * ksh;
  const bf16* vh = v + b * vsb + h * vsh;
  const int C = (N + KCHUNK - 1) / KCHUNK;
  const int iters = 3 * C;
  // the chunk iteration it works on; whether it takes S from the one before
  auto chunk_of = [C](int it) {
    const int c = it % C;
    return it / C == 1 ? C - 1 - c : c;
  };
  auto reuses = [C](int it) { return it == C || it == 2 * C; };
  auto stage = [&](int it) {  // what iteration it reads, into buffer it & 1
    bf16* dst = kv_s[it & 1];
    const int c = chunk_of(it);
    if (!reuses(it)) stage_tile(dst, kh, ksn, c * KCHUNK, N);
    if (it >= 2 * C) stage_tile(dst + TILE, vh, vsn, c * KCHUNK, N);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  stage_tile(q_s, q + b * qsb + h * qsh, qsn, r0, N);
  stage(0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = lane & 3;
  const bool active = r0 + warp * 16 < N;  // uniform across the warp

  // Q fragments: 4 steps of 16 along hd
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldmatrix_x4(qa[kk], smem_u32(q_s + swz(warp * 16 + (lane & 15), 2 * kk + (lane >> 4))));

  // a lane holds rows g (s[j][0..1]) and g + 8 (s[j][2..3]) of the warp's
  // 16, columns 8j + 2t and 8j + 2t + 1 of the chunk; m and l per row, l
  // the lane's part until pass 1 ends, then rl = 1 / l
  float s[KCHUNK / 8][4], o[HD / 8][4];
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, rl0 = 0.f, rl1 = 0.f;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; it < iters; ++it) {
    if (it > 0) {
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      // iteration it's tiles have landed, and every warp is done with the
      // buffer that iteration it - 1 read
      __syncthreads();
    }
    if (it + 1 < iters) stage(it + 1);
    if (!active) continue;
    const int pass = it / C, c = chunk_of(it);
    // 16-key tiles holding a key < N
    const int kt_n = min(KCHUNK / 16, (N - c * KCHUNK + 15) >> 4);
    const bf16* ks = kv_s[it & 1];

    if (!reuses(it)) {
      // S = Q K^T over the chunk: n8 tile j covers keys 8j..8j+7
#pragma unroll
      for (int j = 0; j < KCHUNK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kt = 0; kt < KCHUNK / 16; ++kt) {
        if (kt >= kt_n) continue;
        const int r = kt * 16 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t kb[4];
          ldmatrix_x4(kb, smem_u32(ks + swz(r, 2 * kk + ((lane >> 3) & 1))));
          mma_16816(s[2 * kt], qa[kk], kb[0], kb[1]);
          mma_16816(s[2 * kt + 1], qa[kk], kb[2], kb[3]);
        }
      }
      if ((c + 1) * KCHUNK > N) {  // the last chunk: key columns past N to -inf
#pragma unroll
        for (int j = 0; j < KCHUNK / 8; ++j) {
          const int col = c * KCHUNK + 8 * j + 2 * t;
          if (col >= N) s[j][0] = s[j][2] = -INFINITY;
          if (col + 1 >= N) s[j][1] = s[j][3] = -INFINITY;
        }
      }
    }

    if (pass == 0) {
#pragma unroll
      for (int j = 0; j < KCHUNK / 8; ++j) {
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
      if (it == C - 1) {
        m0 = quad_max(m0);  // every row holds a key < N: finite
        m1 = quad_max(m1);
      }
    } else if (pass == 1) {
#pragma unroll
      for (int j = 0; j < KCHUNK / 8; ++j) {
        if (j >= 2 * kt_n) continue;  // every key past N: exp gives 0
        l0 += expf(s[j][0] - m0) + expf(s[j][1] - m0);
        l1 += expf(s[j][2] - m1) + expf(s[j][3] - m1);
      }
      if (it == 2 * C - 1) {
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
        rl0 = __frcp_rn(l0);
        rl1 = __frcp_rn(l1);
      }
    } else {
      // O += P V, 16 keys at a time; p normalised in float32, then rounded
      // to bf16, which is exactly the A fragment of the product
      const bf16* vs = ks + TILE;
#pragma unroll
      for (int kt = 0; kt < KCHUNK / 16; ++kt) {
        if (kt >= kt_n) continue;
        float p[2][4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float* sj = s[2 * kt + h2];
          p[h2][0] = div_rn(expf(sj[0] - m0), l0, rl0);
          p[h2][1] = div_rn(expf(sj[1] - m0), l0, rl0);
          p[h2][2] = div_rn(expf(sj[2] - m1), l1, rl1);
          p[h2][3] = div_rn(expf(sj[3] - m1), l1, rl1);
        }
        const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                                pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
        const int r = kt * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int dn = 0; dn < 4; ++dn) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, smem_u32(vs + swz(r, 2 * dn + (lane >> 4))));
          mma_16816(o[2 * dn], pa, vb[0], vb[1]);
          mma_16816(o[2 * dn + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }
  if (!active) return;

  // round once, stage in this warp's own q rows, 16-byte stores
  const int w0 = warp * 16 + (lane >> 2), w1 = w0 + 8;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    *reinterpret_cast<uint32_t*>(q_s + swz(w0, j) + 2 * t) = pack_bf16(o[j][0], o[j][1]);
    *reinterpret_cast<uint32_t*>(q_s + swz(w1, j) + 2 * t) = pack_bf16(o[j][2], o[j][3]);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = lane + 32 * i;
    const int r = warp * 16 + (e >> 3), cc = e & 7;
    if (r0 + r < N)
      *reinterpret_cast<uint4*>(out + (((size_t)b * N + r0 + r) * H + h) * HD + cc * 8) =
          *reinterpret_cast<const uint4*>(q_s + swz(r, cc));
  }
}

// ---------------------------------------------------------------------------
// float32 body (tensor cores, 3xTF32)
// ---------------------------------------------------------------------------

constexpr int LD32 = HD + 4;         // row stride of the float32 tiles, floats
constexpr int KC = 32;               // keys per chunk
constexpr int BUF32 = 2 * KC * LD32; // floats of one chunk buffer: K rows, then V rows
static_assert(QROWS * LD32 <= BUF32, "the q tile is staged in the second chunk buffer");

// two chunk buffers; the q tile is staged in the second before its first use
constexpr size_t SMEM_F32 = (size_t)2 * BUF32 * sizeof(float);

// rows [r0, r0 + rows) of one head into a (rows x LD32) float32 tile; rows
// at or past N are zero
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, long long sn, int r0,
                                               int rows, int N) {
  for (int e = threadIdx.x; e < rows * (HD / 4); e += THREADS) {
    const int r = e >> 4, c = e & 15;
    float* d = dst + r * LD32 + c * 4;
    if (r0 + r < N)
      cp_async16(smem_u32(d), src + (r0 + r) * sn + c * 4);
    else
      *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// o += P V over one 8-key step whose P accumulators are p: a lane holds
// keys 2t and 2t + 1 of the step, which A's k-indices t and t + 4 stand
// for, and V's B fragment rows are read in that order from vr (key 2t of
// the step, column g)
__device__ __forceinline__ void pv_step(float (&o)[HD / 8][4], const float (&p)[4],
                                        const float* vr) {
  uint32_t a_hi[4], a_lo[4];
  split_tf32(p[0], a_hi[0], a_lo[0]);  // row g,     key 2t
  split_tf32(p[2], a_hi[1], a_lo[1]);  // row g + 8, key 2t
  split_tf32(p[1], a_hi[2], a_lo[2]);  // row g,     key 2t + 1
  split_tf32(p[3], a_hi[3], a_lo[3]);  // row g + 8, key 2t + 1
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    uint32_t b_hi[2], b_lo[2];
    split_tf32(vr[8 * dn], b_hi[0], b_lo[0]);         // key 2t, column 8 dn + g
    split_tf32(vr[LD32 + 8 * dn], b_hi[1], b_lo[1]);  // key 2t + 1
    mma_tf32x3(o[dn], a_hi, a_lo, b_hi, b_lo);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int H, int N,
                  int q_tiles, long long qsb, long long qsn, long long qsh,
                  long long ksb, long long ksn, long long ksh,
                  long long vsb, long long vsn, long long vsh) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* buf = reinterpret_cast<float*>(smem);

  const int bh = blockIdx.x / q_tiles, qt = blockIdx.x - bh * q_tiles;
  const int b = bh / H, h = bh - b * H;
  const int r0 = qt * QROWS;
  const float* kh = k + b * ksb + h * ksh;
  const float* vh = v + b * vsb + h * vsh;
  const int chunks = (N + KC - 1) / KC;
  auto stage_chunk = [&](int c) {
    float* dst = buf + (c & 1) * BUF32;
    stage_rows_f32(dst, kh, ksn, c * KC, KC, N);
    stage_rows_f32(dst + KC * LD32, vh, vsn, c * KC, KC, N);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  stage_rows_f32(buf + BUF32, q + b * qsb + h * qsh, qsn, r0, QROWS, N);
  stage_chunk(0);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bool active = r0 + warp * 16 < N;  // uniform across the warp

  // the warp's q fragments, split once: k-step kk of 8 along hd
  uint32_t q_hi[HD / 8][4], q_lo[HD / 8][4];
  {
    const float* qw = buf + BUF32 + (warp * 16 + g) * LD32 + t;
#pragma unroll
    for (int kk = 0; kk < HD / 8; ++kk) {
      split_tf32(qw[8 * kk], q_hi[kk][0], q_lo[kk][0]);
      split_tf32(qw[8 * LD32 + 8 * kk], q_hi[kk][1], q_lo[kk][1]);
      split_tf32(qw[8 * kk + 4], q_hi[kk][2], q_lo[kk][2]);
      split_tf32(qw[8 * LD32 + 8 * kk + 4], q_hi[kk][3], q_lo[kk][3]);
    }
  }

  // online softmax over chunks of KC keys: m the running row max, l the
  // lane's part of the row sum of exp(s - m), o the unnormalised output
  float o[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int c = 0; c < chunks; ++c) {
    if (c > 0) asm volatile("cp.async.wait_all;\n" ::: "memory");
    // chunk c has landed, and every warp is done with chunk c - 1 (or q)
    __syncthreads();
    if (c + 1 < chunks) stage_chunk(c + 1);  // into the buffer chunk c - 1 (or q) held
    if (!active) continue;
    const float* kc = buf + (c & 1) * BUF32;
    const float* vc = kc + KC * LD32;
    const int nt = min(KC / 8, (N - c * KC + 7) / 8);  // 8-key tiles holding a key < N

    // S = Q K^T over the chunk; tile j holds keys 8j..8j+7 of the chunk, a
    // lane rows g and g + 8, columns 2t and 2t + 1
    float s[KC / 8][4];
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      if (j >= nt) continue;
      const float* kw = kc + (8 * j + g) * LD32 + t;
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        uint32_t b_hi[2], b_lo[2];
        split_tf32(kw[8 * kk], b_hi[0], b_lo[0]);
        split_tf32(kw[8 * kk + 4], b_hi[1], b_lo[1]);
        mma_tf32x3(s[j], q_hi[kk], q_lo[kk], b_hi, b_lo);
      }
    }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      const int col = c * KC + 8 * j + 2 * t;
      if (col >= N) s[j][0] = s[j][2] = -INFINITY;
      if (col + 1 >= N) s[j][1] = s[j][3] = -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // every chunk holds a key < N, so the new maxima are finite
    const float n0 = fmaxf(m0, quad_max(mx0)), n1 = fmaxf(m1, quad_max(mx1));
    const float a0 = expf(m0 - n0), a1 = expf(m1 - n1);  // 0 on the first chunk
    m0 = n0;
    m1 = n1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      o[dn][0] *= a0;
      o[dn][1] *= a0;
      o[dn][2] *= a1;
      o[dn][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) {
      s[j][0] = expf(s[j][0] - n0);
      s[j][1] = expf(s[j][1] - n0);
      s[j][2] = expf(s[j][2] - n1);
      s[j][3] = expf(s[j][3] - n1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }

    // O += P V
    const float* vw = vc + 2 * t * LD32 + g;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
      if (j < nt) pv_step(o, s[j], vw + 8 * j * LD32);
  }
  if (!active) return;

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int row0 = r0 + warp * 16 + g, row1 = row0 + 8;
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    const int col = 8 * dn + 2 * t;
    if (row0 < N)
      *reinterpret_cast<float2*>(out + (((size_t)b * N + row0) * H + h) * HD + col) =
          make_float2(o[dn][0] / l0, o[dn][1] / l0);
    if (row1 < N)
      *reinterpret_cast<float2*>(out + (((size_t)b * N + row1) * H + h) * HD + col) =
          make_float2(o[dn][2] / l1, o[dn][3] / l1);
  }
}

template <int KT>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int H, int N,
                long long qsb, long long qsn, long long qsh, long long ksb, long long ksn,
                long long ksh, long long vsb, long long vsn, long long vsh,
                cudaStream_t stream) {
  const size_t smem = (size_t)3 * 16 * KT * HD * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_bf16<KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_bf16<KT><<<B * H, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh);
  return (int)cudaGetLastError();
}

int launch_bf16_long(const void* q, const void* k, const void* v, void* out, int B, int H,
                     int N, long long qsb, long long qsn, long long qsh, long long ksb,
                     long long ksn, long long ksh, long long vsb, long long vsn, long long vsh,
                     cudaStream_t stream) {
  const int q_tiles = (N + QROWS - 1) / QROWS;
  attention_fwd_bf16_long<<<B * H * q_tiles, THREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), H, N, q_tiles, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh);
  return (int)cudaGetLastError();
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int H, int N,
               long long qsb, long long qsn, long long qsh, long long ksb, long long ksn,
               long long ksh, long long vsb, long long vsn, long long vsh, cudaStream_t stream) {
  const int q_tiles = (N + QROWS - 1) / QROWS;
  attention_fwd_f32<<<B * H * q_tiles, THREADS, SMEM_F32, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, N, q_tiles, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v: (B, N, H, 64) with the given
// element strides for batch, token and head (unit stride inside a head);
// out: contiguous (B, N, H, 64); any N >= 1.  Both bodies copy 16-byte
// chunks of rows, so every base pointer must be 16-byte aligned and every
// stride a multiple of 16 bytes (8 bf16 or 4 float32 elements).  The grid
// (one block per (batch, head) for the bf16 register body at N <= 257, per
// (batch, head, 64-query tile) otherwise) holds at most 2^31 - 1 blocks.
// Returns the CUDA error code (0 = launched).
extern "C" int attention_fwd(const void* q, const void* k, const void* v, void* out, int dtype,
                             int B, int H, int N, long long qsb, long long qsn, long long qsh,
                             long long ksb, long long ksn, long long ksh, long long vsb,
                             long long vsn, long long vsh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || N < 1) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const bool regs = dtype == 1 && N <= MAX_SEQ_REGS;
  const long long blocks = (long long)B * H * (regs ? 1 : (N + QROWS - 1) / QROWS);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  const long long chunk = dtype == 0 ? 4 : 8;  // elements in 16 bytes
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out)) ||
      ((qsb | qsn | qsh | ksb | ksn | ksh | vsb | vsn | vsh) & (chunk - 1)))
    return (int)cudaErrorMisalignedAddress;
  if (dtype == 0)
    return launch_f32(q, k, v, out, B, H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, s);
  if (!regs)
    return launch_bf16_long(q, k, v, out, B, H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn,
                            vsh, s);
  const int kt = (N + 15) / 16;
  if (kt <= 4)
    return launch_bf16<4>(q, k, v, out, B, H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, s);
  if (kt <= 8)
    return launch_bf16<8>(q, k, v, out, B, H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, s);
  if (kt <= 13)
    return launch_bf16<13>(q, k, v, out, B, H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, s);
  return launch_bf16<17>(q, k, v, out, B, H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, s);
}

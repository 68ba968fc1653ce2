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
// What bounds it on an H100: at ViT shapes (N = 50..257, hd = 64) the work
// is ~4*N*hd operations per query row against 4 * N * hd * elem bytes of
// q, k, v and out per head, i.e. ~N/elem_bytes operations per byte: 25 at
// N = 50 in bf16, far below the ~295 the card needs to be compute-bound.  So
// the bound is memory traffic (each of q, k, v, out read or written once).
// Both bodies take one block per (batch, head), read the head's rows of q,
// k and v from device memory exactly once into shared memory, and take q, k
// and v with (batch, token, head) strides, so the wrapper passes (B, N, H, hd)
// views of the packed qkv projection without copies.  The dtype picks the
// body; neither falls back to the other.
//
// bfloat16 body (tensor cores).  Bytes bound the kernel, so the design aims
// to keep the arithmetic off the critical path and the loads wide:
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
// is rounded up to one of four instantiations (NP = 64, 128, 208, 272).
//
// float32 body (FMA units): tensor cores would need TF32 and lose float32
// parity, so it stays the simple exact-order version: a warp owns one query
// row at a time, lanes split the keys for the logits (K rows padded by one
// 4-byte word so that 32 lanes reading 32 keys hit 32 banks), the row's
// probabilities go through shared memory, and lanes split the 64 output
// columns for the product with V.
//
// Above 48 KB of dynamic shared memory the launcher raises the kernel's
// limit with cudaFuncSetAttribute first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

// ---------------------------------------------------------------------------
// float32 body
// ---------------------------------------------------------------------------

// K row stride in elements: one extra 4-byte word per row (bank spread).
constexpr int KS32 = HD + 1;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t smem_bytes_f32(int n) {
  return (size_t)n * KS32 * sizeof(float)        // K
         + (size_t)n * HD * sizeof(float)        // V
         + (size_t)WARPS * n * sizeof(float)     // probabilities, one row per warp
         + (size_t)WARPS * HD * sizeof(float);   // the query row, one per warp
}

__global__ void __launch_bounds__(THREADS)
attention_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out, int H, int N,
                  long long qsb, long long qsn, long long qsh,
                  long long ksb, long long ksn, long long ksh,
                  long long vsb, long long vsn, long long vsh) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + (size_t)N * KS32;
  float* p_s = v_s + (size_t)N * HD;
  float* q_s = p_s + WARPS * N;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const float* qh = q + b * qsb + h * qsh;
  const float* kh = k + b * ksb + h * ksh;
  const float* vh = v + b * vsb + h * vsh;

  for (int e = threadIdx.x; e < N * HD; e += THREADS) {
    const int j = e / HD, d = e % HD;
    k_s[j * KS32 + d] = kh[j * ksn + d];
    v_s[j * HD + d] = vh[j * vsn + d];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = p_s + warp * N;
  float* qr = q_s + warp * HD;
  for (int row = warp; row < N; row += WARPS) {
    qr[lane] = qh[row * qsn + lane];
    qr[lane + 32] = qh[row * qsn + lane + 32];
    __syncwarp();

    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      const float* kr = k_s + j * KS32;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < N; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < N; j += 32) p[j] = p[j] / sum;
    __syncwarp();

    float a0 = 0.f, a1 = 0.f;
    const int d0 = 2 * lane;
    for (int j = 0; j < N; ++j) {
      const float pj = p[j];
      a0 = fmaf(pj, v_s[j * HD + d0], a0);
      a1 = fmaf(pj, v_s[j * HD + d0 + 1], a1);
    }
    float* o = out + (((size_t)b * N + row) * H + h) * HD;
    o[d0] = a0;
    o[d0 + 1] = a1;
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// bfloat16 body (tensor cores)
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

int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int H, int N,
               long long qsb, long long qsn, long long qsh, long long ksb, long long ksn,
               long long ksh, long long vsb, long long vsn, long long vsh, cudaStream_t stream) {
  const size_t smem = smem_bytes_f32(N);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_f32,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_f32<<<B * H, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v: (B, N, H, 64) with the given
// element strides for batch, token and head (unit stride inside a head);
// out: contiguous (B, N, H, 64); 1 <= N <= 257.  bfloat16 also needs every
// base pointer 16-byte aligned and every stride a multiple of 8 elements.
// Returns the CUDA error code (0 = launched).
extern "C" int attention_fwd(const void* q, const void* k, const void* v, void* out, int dtype,
                             int B, int H, int N, long long qsb, long long qsn, long long qsh,
                             long long ksb, long long ksn, long long ksh, long long vsb,
                             long long vsn, long long vsh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > 257) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_f32(q, k, v, out, B, H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (!(aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out)) ||
      ((qsb | qsn | qsh | ksb | ksn | ksh | vsb | vsn | vsh) & 7))
    return (int)cudaErrorMisalignedAddress;
  const int kt = (N + 15) / 16;
  if (kt <= 4)
    return launch_bf16<4>(q, k, v, out, B, H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, s);
  if (kt <= 8)
    return launch_bf16<8>(q, k, v, out, B, H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, s);
  if (kt <= 13)
    return launch_bf16<13>(q, k, v, out, B, H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, s);
  return launch_bf16<17>(q, k, v, out, B, H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, s);
}

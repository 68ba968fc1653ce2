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
//
// Design: one block per (batch, head).  The head's K and V are staged in
// shared memory once (K rows padded by one 4-byte word so that 32 lanes
// reading 32 different keys hit 32 different banks) and every query row of
// the head is served from there, so K and V are read from device memory
// exactly once.  A warp owns one query row at a time: lanes split the keys
// for the logits, the row's probabilities go through shared memory, and
// lanes split the 64 output columns for the product with V.  Above 48 KB of
// dynamic shared memory (N = 257 needs ~72 KB in bf16, ~138 KB in fp32) the
// launcher raises the kernel's limit with cudaFuncSetAttribute first.
// q, k and v are taken with (batch, token, head) strides, so the wrapper can
// pass (B, N, H, hd) views of the packed qkv projection without copies.
// Tensor cores are not used yet: this is the simple, exact-order version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// K row stride in elements: one extra 4-byte word per row (bank spread).
template <typename T> __host__ __device__ constexpr int k_stride() { return HD + 4 / (int)sizeof(T); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
size_t smem_bytes(int n) {
  return (size_t)n * k_stride<T>() * sizeof(T)      // K
         + (size_t)n * HD * sizeof(T)                // V
         + (size_t)WARPS * n * sizeof(float)         // probabilities, one row per warp
         + (size_t)WARPS * HD * sizeof(float);       // the query row, one per warp
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     T* __restrict__ out, int H, int N,
                     long long qsb, long long qsn, long long qsh,
                     long long ksb, long long ksn, long long ksh,
                     long long vsb, long long vsn, long long vsh) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KS = k_stride<T>();
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + (size_t)N * KS;
  float* p_s = reinterpret_cast<float*>(v_s + (size_t)N * HD);
  float* q_s = p_s + WARPS * N;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const T* qh = q + b * qsb + h * qsh;
  const T* kh = k + b * ksb + h * ksh;
  const T* vh = v + b * vsb + h * vsh;

  for (int e = threadIdx.x; e < N * HD; e += THREADS) {
    const int j = e / HD, d = e % HD;
    k_s[j * KS + d] = kh[j * ksn + d];
    v_s[j * HD + d] = vh[j * vsn + d];
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p = p_s + warp * N;
  float* qr = q_s + warp * HD;
  for (int row = warp; row < N; row += WARPS) {
    qr[lane] = to_f(qh[row * qsn + lane]);
    qr[lane + 32] = to_f(qh[row * qsn + lane + 32]);
    __syncwarp();

    float mx = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      const T* kr = k_s + j * KS;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qr[d], to_f(kr[d]), s);
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
    for (int j = lane; j < N; j += 32) p[j] = to_f(from_f<T>(p[j] / sum));
    __syncwarp();

    float a0 = 0.f, a1 = 0.f;
    const int d0 = 2 * lane;
    for (int j = 0; j < N; ++j) {
      const float pj = p[j];
      a0 = fmaf(pj, to_f(v_s[j * HD + d0]), a0);
      a1 = fmaf(pj, to_f(v_s[j * HD + d0 + 1]), a1);
    }
    T* o = out + (((size_t)b * N + row) * H + h) * HD;
    o[d0] = from_f<T>(a0);
    o[d0 + 1] = from_f<T>(a1);
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int N,
           long long qsb, long long qsn, long long qsh, long long ksb, long long ksn,
           long long ksh, long long vsb, long long vsn, long long vsh, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(N);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_fwd_kernel<T><<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v: (B, N, H, 64) with the given
// element strides for batch, token and head (unit stride inside a head);
// out: contiguous (B, N, H, 64).  Returns the CUDA error code (0 = launched).
extern "C" int attention_fwd(const void* q, const void* k, const void* v, void* out, int dtype,
                             int B, int H, int N, long long qsb, long long qsn, long long qsh,
                             long long ksb, long long ksn, long long ksh, long long vsb,
                             long long vsn, long long vsh, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn, vsh, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, B, H, N, qsb, qsn, qsh, ksb, ksn, ksh, vsb, vsn,
                                 vsh, s);
  return (int)cudaErrorInvalidValue;
}

// Hopper's Tensor Memory Accelerator (TMA) and mbarriers, shared by every
// kernel that streams its operands by TMA boxes: attention_fwd.cu's
// shared-memory and persistent bf16 bodies, and the fused MLP's GEMM core
// (wgmma_gemm.cuh), bf16 and float32.  Device side: the mbarrier operations
// a ring of full / empty barriers needs.  Host side: cuTensorMapEncodeTiled,
// looked up through the runtime's entry-point query so that no library
// links against libcuda; an encoder of maps in the 128-byte swizzle, of
// any element type, that keeps the last maps it encoded; and the device's
// SM count, the grid of a persistent kernel.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

// shared memory a block may use on Hopper (227 KB): the budget of every
// ring above, K1's and the GEMM core's
constexpr int SMEM_BUDGET = 232448;

namespace {

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query,
// so the library links against nothing but the runtime
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int encode_tiled(EncodeTiledFn* fn) {
  static EncodeTiledFn found_fn = nullptr;
  if (found_fn == nullptr) {
    void* entry = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const int err = (int)cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &entry, 12000,
                                                          cudaEnableDefault, &found);
#else
    const int err =
        (int)cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &entry, cudaEnableDefault, &found);
#endif
    if (err != 0) return err;
    if (found != cudaDriverEntryPointSuccess || entry == nullptr) return (int)cudaErrorNotSupported;
    found_fn = reinterpret_cast<EncodeTiledFn>(entry);
  }
  *fn = found_fn;
  return 0;
}

constexpr int MAX_MAP_RANK = 5;
constexpr int KEPT_MAPS = 64;

// The TMA map of a tensor of `type` (bf16 or float32) and `rank`
// dimensions (dims innermost first, strides in bytes of dimensions 1 and
// up), read in boxes of `box` elements in the 128-byte swizzle, elements
// out of bounds read as zeros.
// The last KEPT_MAPS maps encoded are kept, keyed by all that goes into
// them, so that a call on the tensors of an earlier one (the caching
// allocator hands a model's layers the same buffers) skips the encoding,
// which is most of a launch's host time.  Returns a CUDA error code
// (cudaErrorInvalidValue where the encoder refuses the map: a base or a
// stride that is not 16-byte aligned, a box past 256).
int tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
               const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
               CUtensorMapL2promotion promotion) {
  struct Key {
    const void* base;
    cuuint64_t dims[MAX_MAP_RANK], strides[MAX_MAP_RANK - 1];
    cuuint32_t box[MAX_MAP_RANK];
    int type, rank, promotion;
  };
  struct Entry {
    Key key;
    CUtensorMap map;
  };
  if (rank < 1 || rank > MAX_MAP_RANK) return (int)cudaErrorInvalidValue;
  static std::mutex lock;
  static Entry kept[KEPT_MAPS];
  static int used = 0, next = 0;
  Key key;
  memset(&key, 0, sizeof key);  // padding too: keys compare bytewise
  key.base = base;
  key.type = (int)type, key.rank = rank, key.promotion = (int)promotion;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i > 0) key.strides[i - 1] = strides[i - 1];
  }
  {
    std::lock_guard<std::mutex> hold(lock);
    for (int i = 0; i < used; ++i)
      if (memcmp(&kept[i].key, &key, sizeof key) == 0) {
        *map = kept[i].map;
        return 0;
      }
  }
  EncodeTiledFn encode;
  const int err = encode_tiled(&encode);
  if (err != 0) return err;
  cuuint32_t unit[MAX_MAP_RANK] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, promotion,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> hold(lock);
  kept[next] = Entry{key, *map};
  next = (next + 1) % KEPT_MAPS;
  used = used < KEPT_MAPS ? used + 1 : KEPT_MAPS;
  return 0;
}

// the SMs of the current device: a persistent kernel's grid at most
int sm_count(int* n) {
  static int counts[64] = {};  // by device, once asked
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev < 64 && counts[dev] > 0) {
    *n = counts[dev];
    return 0;
  }
  err = (int)cudaDeviceGetAttribute(n, cudaDevAttrMultiProcessorCount, dev);
  if (err == 0 && dev < 64) counts[dev] = *n;
  return err;
}

}  // namespace

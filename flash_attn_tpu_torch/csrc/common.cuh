// Shared helpers for the port's Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fatt {

// Large-negative score for masked entries (the JAX kernels' NEG_INF): it
// exp()s to exactly 0 and keeps fully-masked rows NaN-free.
constexpr float kNegInf = -1e30f;

// KV storage types, as the wrappers pass them.
enum KvType { kBf16 = 0, kInt8 = 1, kFp8 = 2 };

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One stored KV element as float.  int8 and e4m3 values are exact in bf16,
// so this equals the JAX kernel's cast into its bf16 compute type.
template <int KV>
__device__ __forceinline__ float load_kv(const void* p, int64_t i) {
  if constexpr (KV == kBf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  } else if constexpr (KV == kInt8) {
    return static_cast<float>(static_cast<const int8_t*>(p)[i]);
  } else {
    __nv_fp8_e4m3 x;
    x.__x = static_cast<const __nv_fp8_storage_t*>(p)[i];
    return static_cast<float>(x);
  }
}

}  // namespace fatt

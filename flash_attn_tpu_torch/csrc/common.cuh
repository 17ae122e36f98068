// Shared helpers for the port's Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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

// Copy primitives (sm_80+), shared by K1 and K4.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copy of 16 bytes; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

// The same for 4 bytes (through L1).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// Host side.  A kernel's dynamic shared-memory limit is raised once on each
// device, not before every launch: a launcher keeps one SmemLimitSet (a
// function-local static, so one for each kernel instance) and calls
// smem_limit_once before its launch.  Two first calls that race only repeat
// the same attribute call.
constexpr int kMaxDevices = 64;
using SmemLimitSet = std::atomic<bool>[kMaxDevices];

template <typename Kernel>
inline cudaError_t smem_limit_once(Kernel kernel, int bytes, SmemLimitSet& set) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < kMaxDevices;
  if (kept && set[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && kept) set[dev].store(true, std::memory_order_relaxed);
  return e;
}

}  // namespace fatt

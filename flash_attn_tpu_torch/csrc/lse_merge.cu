// K1m: the split-KV combine.  Partials out_i [n, rows, D] fp32 and lse_i
// [n, rows] fp32 over disjoint key sets merge by the LSE rule
//     lse = logsumexp_i(lse_i),  out = sum_i exp(lse_i - lse) * out_i
// into out [rows, D] (bf16 or fp32) and lse [rows] fp32, in one launch.
// Every split-KV caller (K1 over a BHSD or BSHD cache, K8, and the chunk
// kernel as K1c and K8c) merges through it.
//
// Replaces the eager flash_attn_tpu_torch/ops/lse.py:lse_merge on CUDA
// tensors; the JAX package leaves the same merge to XLA
// (flash_attn_tpu/ops/lse.py), so there is no Pallas kernel behind it.
//
// Bound on the H100: bytes.  It reads each partial once (n*rows*(D+1)*4
// bytes) and writes the result once, with 2 flops per partial element.
// One warp per row: every lane reads the row's n LSE values (one cached
// line), then each lane merges 4 consecutive columns per 128 with 16-byte
// loads, so a warp reads 512 contiguous bytes of a partial at a time.
// The arithmetic is lse_merge's, case for case: partials at -inf or at the
// kernels' finite -1e30 weigh exp(lse_i - lse) (0 beside a live partial;
// a row whose partials are all -1e30 sums them with weight 1, all zeros);
// a row whose partials are all -inf gives lse -inf and out 0.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 x);

template <>
__device__ __forceinline__ void store4<float>(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst, float4 x) {
  uint2 w;
  w.x = fatt::pack_bf16(x.x, x.y);
  w.y = fatt::pack_bf16(x.z, x.w);
  *reinterpret_cast<uint2*>(dst) = w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lse_merge_kernel(
    const float* __restrict__ part_out, const float* __restrict__ part_lse,
    T* __restrict__ out, float* __restrict__ lse, int n, int64_t rows, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;
  // logsumexp as torch forms it: the max, then log of the shifted sum; an
  // all -inf row stays -inf.
  float m = -CUDART_INF_F;
  for (int i = 0; i < n; ++i) m = fmaxf(m, part_lse[i * rows + r]);
  float total = -CUDART_INF_F;
  if (m != -CUDART_INF_F) {
    float s = 0.f;
    for (int i = 0; i < n; ++i) s += expf(part_lse[i * rows + r] - m);
    total = m + logf(s);
  }
  const float safe = isfinite(total) ? total : 0.f;
  for (int c = lane * 4; c < D; c += 128) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = 0; i < n; ++i) {
      const float li = part_lse[i * rows + r];
      const float w = isfinite(li) ? expf(li - safe) : 0.f;
      const float4 x = *reinterpret_cast<const float4*>(part_out + (i * rows + r) * D + c);
      acc.x += x.x * w;
      acc.y += x.y * w;
      acc.z += x.z * w;
      acc.w += x.w * w;
    }
    store4<T>(out + r * D + c, acc);
  }
  if (lane == 0) lse[r] = total;
}

}  // namespace

// part_out [n, rows, D] fp32, part_lse [n, rows] fp32 -> out [rows, D]
// (out_fp32 1: fp32, 0: bf16), lse [rows] fp32.  D % 4 == 0.
extern "C" int fatt_lse_merge(const void* part_out, const void* part_lse,
                              void* out, void* lse, int n, int64_t rows, int D,
                              int out_fp32, void* stream) {
  if (n < 1 || rows < 1 || D < 4 || D % 4 != 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto po = static_cast<const float*>(part_out);
  const auto pl = static_cast<const float*>(part_lse);
  if (out_fp32) {
    lse_merge_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        po, pl, static_cast<float*>(out), static_cast<float*>(lse), n, rows, D);
  } else {
    lse_merge_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        po, pl, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), n, rows, D);
  }
  return (int)cudaGetLastError();
}

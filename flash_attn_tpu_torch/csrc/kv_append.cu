// K2: quantize-and-append one token's K and V per sequence, in place.
//
// Replaces flash_attn_tpu/ops/kv_append.py:_append_kernel.
//
// Bound on the H100: bytes, and those are tiny (B*Hk*D*2 inputs, the
// same count of 1- or 2-byte outputs and 2*B*Hk scales), so the launch
// itself dominates.  The design writes only the touched row: one block
// per (sequence, head, K or V) reduces the absmax of its D values in
// registers, writes the quantized row at length[b] and its fp32 scale at
// [b, h, length[b]].  Nothing else of the cache is read or written.  A
// sequence whose length has reached the capacity (an idle engine slot
// keeps advancing) writes nothing.
//
// Rounding follows the JAX kernel: y = x / scale with IEEE division,
// int8 rounds half to even (rintf), fp8 converts with saturation.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxD = 512;
constexpr int kPer = kMaxD / kThreads;

template <int MODE>
__global__ void __launch_bounds__(kThreads) kv_append_kernel(
    void* __restrict__ kc, void* __restrict__ vc, float* __restrict__ ks,
    float* __restrict__ vs, const __nv_bfloat16* __restrict__ nk,
    const __nv_bfloat16* __restrict__ nv, const int* __restrict__ length,
    int Hk, int S, int D) {
  const int b = blockIdx.x, h = blockIdx.y;
  const bool is_v = blockIdx.z == 1;
  const int pos = length[b];
  if (pos < 0 || pos >= S) return;
  const __nv_bfloat16* src = (is_v ? nv : nk) + ((int64_t)b * Hk + h) * D;
  const int tid = threadIdx.x;

  float x[kPer];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = tid + i * kThreads;
    x[i] = d < D ? __bfloat162float(src[d]) : 0.f;
    amax = fmaxf(amax, fabsf(x[i]));
  }
  __shared__ float red[kThreads / 32];
  amax = fatt::warp_max(amax);
  if ((tid & 31) == 0) red[tid >> 5] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, red[w]);

  const int64_t row = ((int64_t)b * Hk + h) * S + pos;
  if constexpr (MODE == fatt::kBf16) {
    auto dst = static_cast<__nv_bfloat16*>(is_v ? vc : kc) + row * D;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = tid + i * kThreads;
      if (d < D) dst[d] = __float2bfloat16(x[i]);
    }
  } else {
    const float qmax = MODE == fatt::kInt8 ? 127.f : 448.f;
    const float scale = amax > 0.f ? amax / qmax : 1.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = tid + i * kThreads;
      if (d >= D) continue;
      const float y = x[i] / scale;
      if constexpr (MODE == fatt::kInt8) {
        auto dst = static_cast<int8_t*>(is_v ? vc : kc) + row * D;
        dst[d] = static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f));
      } else {
        auto dst = static_cast<__nv_fp8_storage_t*>(is_v ? vc : kc) + row * D;
        dst[d] = __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
      }
    }
    if (tid == 0) (is_v ? vs : ks)[row] = scale;
  }
}

}  // namespace

extern "C" int fatt_kv_append(void* kc, void* vc, void* ks, void* vs,
                              const void* nk, const void* nv,
                              const void* length, int B, int Hk, int S, int D,
                              int mode, void* stream) {
  if (D > kMaxD) return (int)cudaErrorInvalidValue;
  dim3 grid(B, Hk, 2);
  auto st = static_cast<cudaStream_t>(stream);
  auto ksp = static_cast<float*>(ks);
  auto vsp = static_cast<float*>(vs);
  auto nkp = static_cast<const __nv_bfloat16*>(nk);
  auto nvp = static_cast<const __nv_bfloat16*>(nv);
  auto lp = static_cast<const int*>(length);
  switch (mode) {
    case fatt::kBf16:
      kv_append_kernel<fatt::kBf16><<<grid, kThreads, 0, st>>>(
          kc, vc, ksp, vsp, nkp, nvp, lp, Hk, S, D);
      break;
    case fatt::kInt8:
      kv_append_kernel<fatt::kInt8><<<grid, kThreads, 0, st>>>(
          kc, vc, ksp, vsp, nkp, nvp, lp, Hk, S, D);
      break;
    case fatt::kFp8:
      kv_append_kernel<fatt::kFp8><<<grid, kThreads, 0, st>>>(
          kc, vc, ksp, vsp, nkp, nvp, lp, Hk, S, D);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

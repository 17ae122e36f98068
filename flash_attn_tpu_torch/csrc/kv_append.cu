// K2: quantize-and-append one token's K and V per sequence, in place.
//
// Replaces flash_attn_tpu/ops/kv_append.py:_append_kernel.
//
// Bound on the H100: bytes, and those are tiny (B*Hk*D*2 inputs, the
// same count of 1- or 2-byte outputs and 2*B*Hk scales), so the launch
// itself is the floor.  The design writes only the touched row and keeps
// each row inside one warp: one warp per (sequence, head, K or V) row,
// eight rows a block.  A lane reads 4 consecutive elements with one 8-byte
// load per 128 columns, the row's absmax takes 5 shuffles (no shared
// memory, no barrier), and the lane writes its 4 quantized bytes as one
// 32-bit store (bf16: one 8-byte store) at length[b]; lane 0 writes the
// fp32 scale at [b, h, length[b]].  Nothing else of the cache is read or
// written.  A sequence whose length is negative or has reached the capacity
// (an idle engine slot keeps advancing) writes nothing.
//
// Rounding follows the JAX kernel: y = x / scale with IEEE division,
// int8 rounds half to even (rintf) and saturates to +-127, fp8 converts
// with saturation.
#include "common.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // warps a block
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kMaxD = 512;
constexpr int kPer = kMaxD / 128;  // 4-element groups a lane at most

// 4 floats of one lane as stored bytes, or bf16 for MODE kBf16.
template <int MODE>
__device__ __forceinline__ uint32_t quantize4(const float (&x)[4], float scale) {
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float y = x[e] / scale;
    uint32_t byte;
    if constexpr (MODE == fatt::kInt8) {
      byte = static_cast<uint8_t>(static_cast<int8_t>(fminf(fmaxf(rintf(y), -127.f), 127.f)));
    } else {
      byte = __nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3);
    }
    w |= byte << (8 * e);
  }
  return w;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) kv_append_kernel(
    void* __restrict__ kc, void* __restrict__ vc, float* __restrict__ ks,
    float* __restrict__ vs, const __nv_bfloat16* __restrict__ nk,
    const __nv_bfloat16* __restrict__ nv, const int* __restrict__ length, int Hk,
    int S, int D) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);  // of sequence b
  if (row >= Hk * 2) return;
  const bool is_v = row & 1;
  const int64_t bh = (int64_t)b * Hk + (row >> 1);
  // the row's values load beside the length, not after it
  const int pos = length[b];
  const __nv_bfloat16* src = (is_v ? nv : nk) + bh * D;
  uint2 raw[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = lane * 4 + i * 128;
    if (d < D) raw[i] = *reinterpret_cast<const uint2*>(src + d);
  }
  if (pos < 0 || pos >= S) return;
  const int64_t dst_row = bh * S + pos;

  float x[kPer][4];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = lane * 4 + i * 128;
    if (d < D) {
      const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[i].x));
      const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw[i].y));
      x[i][0] = lo.x;
      x[i][1] = lo.y;
      x[i][2] = hi.x;
      x[i][3] = hi.y;
      if constexpr (MODE == fatt::kBf16) {
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(is_v ? vc : kc) + dst_row * D + d) =
            raw[i];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(x[i][e]));
    }
  }
  if constexpr (MODE != fatt::kBf16) {
    amax = fatt::warp_max(amax);
    const float qmax = MODE == fatt::kInt8 ? 127.f : 448.f;
    const float scale = amax > 0.f ? amax / qmax : 1.f;
    auto dst = static_cast<unsigned char*>(is_v ? vc : kc) + dst_row * D;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int d = lane * 4 + i * 128;
      if (d < D) *reinterpret_cast<uint32_t*>(dst + d) = quantize4<MODE>(x[i], scale);
    }
    if (lane == 0) (is_v ? vs : ks)[dst_row] = scale;
  }
}

// Launched as K2 is, with no work: its time is the floor of a kernel this
// small (chip_smoke.py phase 2 times it beside K2).
__global__ void __launch_bounds__(kThreads) empty_kernel() {}

// One block per 8 of sequence b's 2 Hk rows (K and V of each head): the
// sequence is blockIdx.y, so no block divides to find it.
dim3 grid(int B, int Hk) {
  return dim3((2 * Hk + kRowsPerBlock - 1) / kRowsPerBlock, B);
}

}  // namespace

// k/v caches [B, Hk, S, D] (bf16, int8 or fp8 by mode), scales [B, Hk, S]
// fp32 (quantized modes), new_k/new_v [B, Hk, D] bf16, length [B] int32.
// D % 4 == 0, at most 512; rows 8-byte aligned.
extern "C" int fatt_kv_append(void* kc, void* vc, void* ks, void* vs,
                              const void* nk, const void* nv,
                              const void* length, int B, int Hk, int S, int D,
                              int mode, void* stream) {
  if (D > kMaxD || D % 4 != 0 || B < 1 || B > 65535 || Hk < 1 || Hk > 0x3fffffff)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto ksp = static_cast<float*>(ks);
  auto vsp = static_cast<float*>(vs);
  auto nkp = static_cast<const __nv_bfloat16*>(nk);
  auto nvp = static_cast<const __nv_bfloat16*>(nv);
  auto lp = static_cast<const int*>(length);
  const dim3 g = grid(B, Hk);
  switch (mode) {
    case fatt::kBf16:
      kv_append_kernel<fatt::kBf16><<<g, kThreads, 0, st>>>(
          kc, vc, ksp, vsp, nkp, nvp, lp, Hk, S, D);
      break;
    case fatt::kInt8:
      kv_append_kernel<fatt::kInt8><<<g, kThreads, 0, st>>>(
          kc, vc, ksp, vsp, nkp, nvp, lp, Hk, S, D);
      break;
    case fatt::kFp8:
      kv_append_kernel<fatt::kFp8><<<g, kThreads, 0, st>>>(
          kc, vc, ksp, vsp, nkp, nvp, lp, Hk, S, D);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The empty kernel on K2's grid for B sequences and Hk heads.
extern "C" int fatt_empty(int B, int Hk, void* stream) {
  if (B < 1 || B > 65535 || Hk < 1 || Hk > 0x3fffffff) return (int)cudaErrorInvalidValue;
  empty_kernel<<<grid(B, Hk), kThreads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

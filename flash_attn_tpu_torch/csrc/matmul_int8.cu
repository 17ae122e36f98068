// K3: weight-only int8 matmul, out[M, N] = (x[M, K] @ w[K, N]) * s[N].
//
// Replaces flash_attn_tpu/ops/matmul.py:_int8_kernel (per-column scales).
//
// Bound on the H100: at decode (M = batch <= 16) bytes -- the K*N int8
// weight stream is everything, 2*M flops per byte; at prefill (M = 512 ..
// 2048) operations -- 2*M*K*N bf16 flops on the tensor cores.  The design:
//   * int8 weights are read once per block tile as 16-byte vectors and
//     widened to bf16 in shared memory (exact for |w| <= 127); the bf16
//     product runs on the tensor cores through WMMA (mma.sync) with an
//     fp32 accumulator, and the per-column scale multiplies the
//     accumulator once at the end, as on the TPU;
//   * small M takes a 16-row tile and splits K across blockIdx.z, so the
//     N/64 column tiles of one decode projection still put enough blocks
//     on the 132 SMs to stream the weights; the fp32 split partials are
//     summed, scaled and rounded by a second small kernel;
//   * large M takes 64 x 128 tiles (4 warps of 32 x 64) with one split.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;

template <int BM, int BN, int BK, int WM, int WN>
struct Cfg {
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kWarps = (BM / WM) * kWarpsN;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kFM = WM / 16, kFN = WN / 16;
  static constexpr int kXLd = BK + 8;   // bf16 row stride of the x tile
  static constexpr int kWLd = BN + 8;   // bf16 row stride of the w tile
  static constexpr int kCLd = BN + 4;   // fp32 row stride of the epilogue
  static constexpr int kLoadBytes = (BM * kXLd + BK * kWLd) * 2;
  static constexpr int kEpiBytes = BM * kCLd * 4;
  static constexpr int kSmem = kLoadBytes > kEpiBytes ? kLoadBytes : kEpiBytes;
};

template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__((Cfg<BM, BN, BK, WM, WN>::kThreads))
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ w,
                   const float* __restrict__ scales,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ part,
                   int M, int K, int N, int k_per_split) {
  using C = Cfg<BM, BN, BK, WM, WN>;
  __shared__ __align__(128) unsigned char smem[C::kSmem];
  auto xs = reinterpret_cast<__nv_bfloat16*>(smem);
  auto ws = xs + BM * C::kXLd;
  auto cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / C::kWarpsN, wn = warp % C::kWarpsN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[C::kFM][C::kFN];
#pragma unroll
  for (int i = 0; i < C::kFM; ++i)
#pragma unroll
    for (int j = 0; j < C::kFN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    // x tile [BM, BK]: 8 bf16 (16 bytes) per load; rows >= M are zero.
    for (int i = tid; i < BM * BK / 8; i += C::kThreads) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && k0 + c < kend)
        val = *reinterpret_cast<const uint4*>(x + (int64_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(xs + r * C::kXLd + c) = val;
    }
    // w tile [BK, BN]: 16 int8 (16 bytes) per load, widened to bf16.
    for (int i = tid; i < BK * BN / 16; i += C::kThreads) {
      const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
      int4 raw = make_int4(0, 0, 0, 0);
      if (k0 + r < kend && n0 + c < N)
        raw = *reinterpret_cast<const int4*>(w + (int64_t)(k0 + r) * N + n0 + c);
      const int8_t* b8 = reinterpret_cast<const int8_t*>(&raw);
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(ws + r * C::kWLd + c);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = __floats2bfloat162_rn((float)b8[2 * e], (float)b8[2 * e + 1]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[C::kFM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[C::kFN];
#pragma unroll
      for (int i = 0; i < C::kFM; ++i)
        wmma::load_matrix_sync(a[i], xs + (wm * WM + i * 16) * C::kXLd + kk, C::kXLd);
#pragma unroll
      for (int j = 0; j < C::kFN; ++j)
        wmma::load_matrix_sync(bf[j], ws + kk * C::kWLd + wn * WN + j * 16, C::kWLd);
#pragma unroll
      for (int i = 0; i < C::kFM; ++i)
#pragma unroll
        for (int j = 0; j < C::kFN; ++j) wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue through shared memory (fragment element order is opaque).
#pragma unroll
  for (int i = 0; i < C::kFM; ++i)
#pragma unroll
    for (int j = 0; j < C::kFN; ++j)
      wmma::store_matrix_sync(cs + (wm * WM + i * 16) * C::kCLd + wn * WN + j * 16,
                              acc[i][j], C::kCLd, wmma::mem_row_major);
  __syncthreads();
  const bool split = gridDim.z > 1;
  for (int i = tid; i < BM * BN; i += C::kThreads) {
    const int r = i / BN, c = i % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm >= M || gn >= N) continue;
    const float val = cs[r * C::kCLd + c];
    if (split) {
      part[((int64_t)blockIdx.z * M + gm) * N + gn] = val;
    } else {
      out[(int64_t)gm * N + gn] = __float2bfloat16(val * scales[gn]);
    }
  }
}

__global__ void split_reduce_kernel(const float* __restrict__ part,
                                    const float* __restrict__ scales,
                                    __nv_bfloat16* __restrict__ out, int M,
                                    int N, int splits) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * total + i];
  out[i] = __float2bfloat16(s * scales[i % N]);
}

template <int BM, int BN, int BK, int WM, int WN>
void launch(const void* x, const void* w, const void* scales, void* out,
            void* part, int M, int K, int N, int splits, cudaStream_t st) {
  using C = Cfg<BM, BN, BK, WM, WN>;
  int k_per_split = (K + splits - 1) / splits;
  k_per_split = (k_per_split + BK - 1) / BK * BK;
  splits = (K + k_per_split - 1) / k_per_split;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  int8_matmul_kernel<BM, BN, BK, WM, WN><<<grid, C::kThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), M, K, N, k_per_split);
  if (splits > 1) {
    const int64_t total = (int64_t)M * N;
    split_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(part), static_cast<const float*>(scales),
        static_cast<__nv_bfloat16*>(out), M, N, splits);
  }
}

}  // namespace

// splits > 1 needs part: fp32 scratch of splits * M * N (M <= 16 only).
extern "C" int fatt_matmul_int8(const void* x, const void* w,
                                const void* scales, void* out, void* part,
                                int M, int K, int N, int splits, void* stream) {
  if (K % 8 != 0 || N % 16 != 0 || splits < 1 || (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 16) {
    launch<16, 64, 64, 16, 16>(x, w, scales, out, part, M, K, N, splits, st);
  } else {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    launch<64, 128, 32, 32, 64>(x, w, scales, out, part, M, K, N, 1, st);
  }
  return (int)cudaGetLastError();
}

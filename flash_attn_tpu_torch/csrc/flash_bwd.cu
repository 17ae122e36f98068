// K9 and K10: FlashAttention-2 backward, BSHD bf16, D = 128, bottom-right
// causal GQA with q-side RoPE applied in the kernels.  Two passes, each
// deterministic by construction (no atomics), as on the TPU:
//   K9  (dq pass)    replaces flash_attn_tpu/ops/flash_bwd.py:_dq_kernel;
//   K10 (dk/dv pass) replaces flash_attn_tpu/ops/flash_bwd.py:_dkv_kernel
// on the subset the Llama training step uses (no bias/dbias, segments,
// positions, window, softcap, ALiBi or dropout).
//
// Bound on the H100: operations.  At S = 2048, D = 128 the causal half of
// the five products (QK^T, dO V^T, dS K; QK^T, dO V^T, P^T dO, dS^T Q,
// counted 3 + 4 GEMMs of 2*S^2*D/2 flops per head) is far above the
// ridge against ~4*S*D*2 bytes of inputs per head.  The design keeps
// scores, probabilities and dS out of device memory:
//   * K9: one block per (64-query tile, head, batch), 4 warps each owning
//     16 query rows.  R(q) and dO are loaded once; K/V tiles of 64 keys
//     stream through shared memory up to the causal limit; dq stays in
//     WMMA accumulators (fp32) for the whole loop, then is scaled, pulled
//     back through the rotation in fp32 and written as fp32.
//   * K10: one block per (64-key tile, query head, batch), 4 warps each
//     owning 16 keys.  K/V are loaded once; q tiles (rotated at load) and
//     dO stream from the first live tile; S^T and dP^T are computed key-
//     major so each warp's P^T and dS^T rows feed its own dv += P^T dO and
//     dk += dS^T R(q) in accumulators.  Each query head writes its own
//     fp32 dk/dv; the wrapper sums a GQA group afterwards.
//   * Products on the tensor cores (WMMA bf16, fp32 accumulate); the
//     elementwise softmax backward in fp32 through shared memory.
//   * Dead causal tiles are never loaded (:178-182, :254-265).
//   * ~111 KB of shared memory per block, so two blocks share an SM.
// Roundings as the reference: R(q) rounded to bf16 before the products
// (flash_fwd.py:146-160); s = (R(q) k^T) * scale in natural units;
// p = exp(s - lse) masked elementwise (padded and fully masked rows carry
// lse = NEG_INF); ds = p (dp - delta); dS cast to bf16 before dq and dk,
// P cast to bf16 before dv.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using fatt::kNegInf;

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // keys per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int D>
struct Smem {
  static constexpr int kLd = D + 8;     // bf16 stride of the D-wide tiles
  static constexpr int kSLd = 64 + 4;   // fp32 stride of a 64x64 score tile
  static constexpr int kPLd = 64 + 8;   // bf16 stride of a 64x64 p/ds tile
  static constexpr int kOLd = D + 4;    // fp32 stride of K9's dq epilogue
  static constexpr size_t kTile = (size_t)64 * kLd * 2;
  static constexpr size_t kScore = (size_t)64 * kSLd * 4;
  // four D-wide bf16 tiles (A, B fixed per block; C, E streamed), two fp32
  // score tiles, one bf16 64x64 tile, then 2 x 64 fp32 row statistics
  static constexpr size_t kA = 0;
  static constexpr size_t kB = kA + kTile;
  static constexpr size_t kC = kB + kTile;
  static constexpr size_t kE = kC + kTile;
  static constexpr size_t kS = kE + kTile;
  static constexpr size_t kDP = kS + kScore;
  static constexpr size_t kP = kDP + kScore;
  static constexpr size_t kRow = kP + (size_t)64 * kPLd * 2;
  static constexpr size_t kBytes = kRow + 2 * 64 * 4;
  static_assert((size_t)64 * kOLd * 4 <= 2 * kScore, "dq epilogue fits the score tiles");
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// 64 rows from row0 of head hx of a [B, S, Hx, D] bf16 tensor into a tile
// (zeros past S), 16 bytes a thread per step.
template <int D>
__device__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int b,
                          int row0, int S, int Hx, int hx) {
  constexpr int L = Smem<D>::kLd;
  for (int i = threadIdx.x; i < 64 * D / 8; i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row0 + r < S)
      x = *reinterpret_cast<const uint4*>(src + (((int64_t)b * S + row0 + r) * Hx + hx) * D + c);
    *reinterpret_cast<uint4*>(dst + r * L + c) = x;
  }
}

// 64 query rows of head h, rotated (rotate-half) in fp32 with each row's
// cos/sin and rounded to bf16: rope_rotate_block on a bf16 block.  The
// products are rounded apart (no fused multiply-add), as PyTorch's
// elementwise ops round them.  Without tables, the rows as they are.
template <int D>
__device__ void load_q(__nv_bfloat16* dst, const __nv_bfloat16* q, const float* cosv,
                       const float* sinv, int b, int row0, int Sq, int H, int h,
                       int rope_bstride) {
  if (cosv == nullptr) {
    load_rows<D>(dst, q, b, row0, Sq, H, h);
    return;
  }
  constexpr int L = Smem<D>::kLd, D2 = D / 2;
  for (int i = threadIdx.x; i < 64 * D2; i += kThreads) {
    const int r = i / D2, c = i % D2, gq = row0 + r;
    float o1 = 0.f, o2 = 0.f;
    if (gq < Sq) {
      const int64_t base = (((int64_t)b * Sq + gq) * H + h) * D;
      const float x1 = __bfloat162float(q[base + c]);
      const float x2 = __bfloat162float(q[base + c + D2]);
      const int64_t t = (int64_t)b * rope_bstride + (int64_t)gq * D2 + c;
      const float cs = cosv[t], sn = sinv[t];
      o1 = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
      o2 = __fadd_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
    }
    dst[r * L + c] = __float2bfloat16(o1);
    dst[r * L + c + D2] = __float2bfloat16(o2);
  }
}

// out[16 x 64] (fp32, stride kSLd) = a[16 x D] . b[64 x D]^T, one warp.
template <int D>
__device__ __forceinline__ void mm_abt(float* out, const __nv_bfloat16* a,
                                       const __nv_bfloat16* b) {
  constexpr int L = Smem<D>::kLd;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA fa;
      FragBc fb;
      wmma::load_matrix_sync(fa, a + kk, L);
      wmma::load_matrix_sync(fb, b + j * 16 * L + kk, L);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + j * 16, acc, Smem<D>::kSLd, wmma::mem_row_major);
  }
}

// acc[16 x D] += a[16 x 64] (bf16, stride kPLd) . b[64 x D], one warp.
template <int D>
__device__ __forceinline__ void mm_acc(FragC (&acc)[D / 16], const __nv_bfloat16* a,
                                       const __nv_bfloat16* b) {
  constexpr int L = Smem<D>::kLd;
#pragma unroll
  for (int kk = 0; kk < 64; kk += 16) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk, Smem<D>::kPLd);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBr fb;
      wmma::load_matrix_sync(fb, b + kk * L + n * 16, L);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// p = exp(s * scale - lse) where the element is live, else 0.
__device__ __forceinline__ float prob(float s, float scale, float lse, bool live) {
  return live ? expf(__fsub_rn(__fmul_rn(s, scale), lse)) : 0.f;
}

template <int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ cosv, const float* __restrict__ sinv,
    float* __restrict__ dq, int Sq, int Sk, int H, int Hk, int rope_bstride,
    float scale, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::kA);
  auto dOs = reinterpret_cast<__nv_bfloat16*>(smem + L::kB);
  auto Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::kC);
  auto Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::kE);
  auto Ss = reinterpret_cast<float*>(smem + L::kS);
  auto DPs = reinterpret_cast<float*>(smem + L::kDP);
  auto dSs = reinterpret_cast<__nv_bfloat16*>(smem + L::kP);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = qt * kBQ;
  const int shift = Sk - Sq;

  load_q<D>(Qs, q, cosv, sinv, b, row0, Sq, H, h, rope_bstride);
  load_rows<D>(dOs, dout, b, row0, Sq, H, h);

  // lane pair (2r', 2r'+1) of warp w owns row w*16 + r', 32 columns each
  const int my_row = warp * 16 + (lane >> 1);
  const int half = (lane & 1) * (kBK / 2);
  const int g_row = row0 + my_row;
  float lse_r = kNegInf, delta_r = 0.f;
  if (g_row < Sq) {
    const int64_t r = ((int64_t)b * H + h) * Sq + g_row;
    lse_r = lse[r];
    delta_r = delta[r];
  }
  const bool row_live = g_row < Sq && lse_r > kNegInf / 2;

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  int kv_end = Sk;
  if (causal) kv_end = min(Sk, min(row0 + kBQ - 1, Sq - 1) + shift + 1);

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // previous K/V tile fully consumed
    load_rows<D>(Ks, k, b, k0, Sk, Hk, kvh);
    load_rows<D>(Vs, v, b, k0, Sk, Hk, kvh);
    __syncthreads();

    mm_abt<D>(Ss + warp * 16 * L::kSLd, Qs + warp * 16 * L::kLd, Ks);
    mm_abt<D>(DPs + warp * 16 * L::kSLd, dOs + warp * 16 * L::kLd, Vs);
    __syncwarp();

    const float* srow = Ss + my_row * L::kSLd + half;
    const float* dprow = DPs + my_row * L::kSLd + half;
    __nv_bfloat16* dsrow = dSs + my_row * L::kPLd + half;
#pragma unroll 8
    for (int c = 0; c < kBK / 2; ++c) {
      const int col = k0 + half + c;
      const bool live = row_live && col < Sk && (!causal || col <= g_row + shift);
      const float p = prob(srow[c], scale, lse_r, live);
      dsrow[c] = __float2bfloat16(p * (dprow[c] - delta_r));
    }
    __syncwarp();

    mm_acc<D>(acc, dSs + warp * 16 * L::kPLd, Ks);
  }
  __syncthreads();  // every warp is done with the score tiles

  // dq = scale * acc, pulled back through the rotation (R^-1 = R(-angle))
  // in fp32 on this warp's own rows.
  float* Os = reinterpret_cast<float*>(smem + L::kS);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int i = 0; i < acc[n].num_elements; ++i) acc[n].x[i] *= scale;
    wmma::store_matrix_sync(Os + warp * 16 * L::kOLd + n * 16, acc[n], L::kOLd,
                            wmma::mem_row_major);
  }
  __syncwarp();
  if (g_row < Sq) {
    constexpr int D2 = D / 2;
    const float* orow = Os + my_row * L::kOLd;
    float* dst = dq + (((int64_t)b * Sq + g_row) * H + h) * D;
    const int c0 = (lane & 1) * (D2 / 2);
    for (int c = c0; c < c0 + D2 / 2; ++c) {
      const float x1 = orow[c], x2 = orow[c + D2];
      float o1 = x1, o2 = x2;
      if (cosv != nullptr) {
        const int64_t t = (int64_t)b * rope_bstride + (int64_t)g_row * D2 + c;
        const float cs = cosv[t], sn = sinv[t];
        o1 = __fadd_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
        o2 = __fsub_rn(__fmul_rn(x2, cs), __fmul_rn(x1, sn));
      }
      dst[c] = o1;
      dst[c + D2] = o2;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) dkv_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ cosv, const float* __restrict__ sinv,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H, int Hk,
    int rope_bstride, float scale, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::kA);
  auto Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::kB);
  auto Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::kC);
  auto dOs = reinterpret_cast<__nv_bfloat16*>(smem + L::kE);
  auto STs = reinterpret_cast<float*>(smem + L::kS);
  auto dPTs = reinterpret_cast<float*>(smem + L::kDP);
  auto Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::kP);
  auto lse_s = reinterpret_cast<float*>(smem + L::kRow);
  auto delta_s = lse_s + 64;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = kt * kBK;
  const int shift = Sk - Sq;

  load_rows<D>(Ks, k, b, k0, Sk, Hk, kvh);
  load_rows<D>(Vs, v, b, k0, Sk, Hk, kvh);

  // lane pair (2r', 2r'+1) of warp w owns key w*16 + r', 32 queries each
  const int my_key = warp * 16 + (lane >> 1);
  const int half = (lane & 1) * (kBQ / 2);
  const int g_key = k0 + my_key;

  FragC acc_k[D / 16], acc_v[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(acc_k[n], 0.f);
    wmma::fill_fragment(acc_v[n], 0.f);
  }

  // First live q tile: (kt, qt) is live iff k0 <= qt*kBQ + kBQ - 1 + shift.
  int qt0 = 0;
  if (causal) {
    const int t = k0 - shift - (kBQ - 1);
    qt0 = t > 0 ? (t + kBQ - 1) / kBQ : 0;
  }
  const int nq = (Sq + kBQ - 1) / kBQ;

  for (int qt = qt0; qt < nq; ++qt) {
    const int row0 = qt * kBQ;
    __syncthreads();  // previous q tile fully consumed
    load_q<D>(Qs, q, cosv, sinv, b, row0, Sq, H, h, rope_bstride);
    load_rows<D>(dOs, dout, b, row0, Sq, H, h);
    for (int i = threadIdx.x; i < kBQ; i += kThreads) {
      const int gq = row0 + i;
      const int64_t r = ((int64_t)b * H + h) * Sq + gq;
      lse_s[i] = gq < Sq ? lse[r] : kNegInf;
      delta_s[i] = gq < Sq ? delta[r] : 0.f;
    }
    __syncthreads();

    // S^T and dP^T for this warp's 16 keys against the tile's 64 queries
    mm_abt<D>(STs + warp * 16 * L::kSLd, Ks + warp * 16 * L::kLd, Qs);
    mm_abt<D>(dPTs + warp * 16 * L::kSLd, Vs + warp * 16 * L::kLd, dOs);
    __syncwarp();

    float* strow = STs + my_key * L::kSLd + half;
    __nv_bfloat16* prow = Ps + my_key * L::kPLd + half;
#pragma unroll 8
    for (int c = 0; c < kBQ / 2; ++c) {
      const int row = row0 + half + c;
      const float l = lse_s[half + c];
      const bool live = row < Sq && l > kNegInf / 2 && g_key < Sk &&
                        (!causal || g_key <= row + shift);
      const float p = prob(strow[c], scale, l, live);
      strow[c] = p;
      prow[c] = __float2bfloat16(p);
    }
    __syncwarp();
    mm_acc<D>(acc_v, Ps + warp * 16 * L::kPLd, dOs);  // dv += P^T dO
    __syncwarp();

    const float* dprow = dPTs + my_key * L::kSLd + half;
#pragma unroll 8
    for (int c = 0; c < kBQ / 2; ++c)
      prow[c] = __float2bfloat16(strow[c] * (dprow[c] - delta_s[half + c]));
    __syncwarp();
    mm_acc<D>(acc_k, Ps + warp * 16 * L::kPLd, Qs);  // dk += dS^T R(q)
  }

  // fp32 [B, H, Sk_pad, D] rows of this tile; Sk_pad = gridDim.x * kBK
  const int64_t row = ((int64_t)b * H + h) * ((int64_t)gridDim.x * kBK) + k0 + warp * 16;
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int i = 0; i < acc_k[n].num_elements; ++i) acc_k[n].x[i] *= scale;
    wmma::store_matrix_sync(dk + row * D + n * 16, acc_k[n], D, wmma::mem_row_major);
    wmma::store_matrix_sync(dv + row * D + n * 16, acc_v[n], D, wmma::mem_row_major);
  }
}

template <typename Kernel>
int prepare(Kernel kernel, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// q, dout [B, Sq, H, D]; k, v [B, Sk, Hk, D] bf16; lse, delta [B, H, Sq]
// fp32; cos/sin [B or 1, Sq, D/2] fp32 with batch stride rope_bstride (0
// when shared), or both null.  dq: [B, Sq, H, D] fp32, w.r.t. un-rotated q.
extern "C" int fatt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 const void* cosv, const void* sinv, void* dq, int B,
                                 int Sq, int Sk, int H, int Hk, int D, int rope_bstride,
                                 float scale, int causal, void* stream) {
  // Only head_dim 128 (Llama-3) is built; another D needs a card check.
  if (H % Hk != 0 || D != 128) return (int)cudaErrorInvalidValue;
  constexpr size_t bytes = Smem<128>::kBytes;
  int e = prepare(dq_kernel<128>, bytes);
  if (e != 0) return e;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  dq_kernel<128><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      static_cast<float*>(dq), Sq, Sk, H, Hk, rope_bstride, scale, causal);
  return (int)cudaGetLastError();
}

// As fatt_flash_bwd_dq; dk, dv: [B, H, ceil(Sk / 64) * 64, D] fp32 per
// query head (rows past Sk are zero).
extern "C" int fatt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  const void* cosv, const void* sinv, void* dk, void* dv,
                                  int B, int Sq, int Sk, int H, int Hk, int D,
                                  int rope_bstride, float scale, int causal,
                                  void* stream) {
  if (H % Hk != 0 || D != 128) return (int)cudaErrorInvalidValue;
  constexpr size_t bytes = Smem<128>::kBytes;
  int e = prepare(dkv_kernel<128>, bytes);
  if (e != 0) return e;
  dim3 grid((Sk + kBK - 1) / kBK, H, B);
  dkv_kernel<128><<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H, Hk, rope_bstride,
      scale, causal);
  return (int)cudaGetLastError();
}

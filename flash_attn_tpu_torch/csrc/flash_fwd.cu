// K4: FlashAttention-2 forward, BSHD bf16, causal (bottom-right) GQA
// prefill with q-side RoPE applied in the kernel, "clamped" or "online"
// softmax, fp32 LSE.
//
// Replaces flash_attn_tpu/ops/flash_fwd.py:_fwd_kernel on the subset the
// Llama prefill uses (models/llama.py prefill_with_kv).
//
// Bound on the H100: operations.  At S = 2048, D = 128 the causal half of
// QK^T and PV is ~4*S^2*D/2 flops per head against ~4*S*D bytes, far above
// the ridge, so the tensor cores set the bound.  The design keeps scores
// and probabilities out of device memory:
//   * one block per (64-query tile, head, batch); 4 warps, each owning 16
//     query rows; Q is loaded once, scaled, rotated in fp32 and rounded to
//     bf16 (as flash_fwd.py:146-160 does), then K/V tiles of 64 keys
//     stream through shared memory;
//   * QK^T and PV run on the tensor cores (WMMA bf16, fp32 accumulate);
//     the softmax runs on the fp32 scores in shared memory, p is rounded
//     to bf16 for the PV product, as on the TPU;
//   * tiles wholly above the causal diagonal are never loaded;
//   * the KV head is h / (H / Hk): GQA without a materialised broadcast.
// Scores are in base-2 units (log2(e) folded into the q pre-scale).
// Clamped mode drops the running max: p = 2^min(s, 80), no rescale.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using fatt::kNegInf;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kClamp2 = 80.f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Smem {
  static constexpr int kQLd = D + 8;    // bf16 stride of Q/K/V tiles
  static constexpr int kSLd = kBK + 4;  // fp32 stride of scores
  static constexpr int kPLd = kBK + 8;  // bf16 stride of probabilities
  static constexpr int kOLd = D + 4;    // fp32 stride of the accumulator
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + (size_t)kBQ * kQLd * 2;
  static constexpr size_t kV = kK + (size_t)kBK * kQLd * 2;
  static constexpr size_t kS = kV + (size_t)kBK * kQLd * 2;
  static constexpr size_t kP = kS + (size_t)kBQ * kSLd * 4;
  static constexpr size_t kO = kP + (size_t)kBQ * kPLd * 2;
  static constexpr size_t kBytes = kO + (size_t)kBQ * kOLd * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ cosv,
    const float* __restrict__ sinv, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hk,
    int rope_bstride, float eff_scale, int causal, int clamped) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  auto Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);
  auto Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::kV);
  auto Ss = reinterpret_cast<float*>(smem + L::kS);
  auto Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::kP);
  auto Os = reinterpret_cast<float*>(smem + L::kO);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Hk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = qt * kBQ;
  const int shift = Sk - Sq;  // bottom-right causal alignment
  constexpr int D2 = D / 2;

  // Q tile: scale in fp32, round to bf16, rotate (rotate-half) in fp32
  // with the row's cos/sin, round to bf16.  Rows >= Sq are zero.
  for (int i = tid; i < kBQ * D2; i += kThreads) {
    const int r = i / D2, c = i % D2;
    const int gq = row0 + r;
    float o1 = 0.f, o2 = 0.f;
    if (gq < Sq) {
      const int64_t base = (((int64_t)b * Sq + gq) * H + h) * D;
      const float x1 = fatt::bf16_round(__bfloat162float(q[base + c]) * eff_scale);
      const float x2 = fatt::bf16_round(__bfloat162float(q[base + c + D2]) * eff_scale);
      if (cosv != nullptr) {
        const int64_t t = (int64_t)b * rope_bstride + (int64_t)gq * D2 + c;
        const float cs = cosv[t], sn = sinv[t];
        o1 = x1 * cs - x2 * sn;
        o2 = x2 * cs + x1 * sn;
      } else {
        o1 = x1;
        o2 = x2;
      }
    }
    Qs[r * L::kQLd + c] = __float2bfloat16(o1);
    Qs[r * L::kQLd + c + D2] = __float2bfloat16(o2);
  }
  for (int i = tid; i < kBQ * D; i += kThreads) Os[(i / D) * L::kOLd + i % D] = 0.f;

  // Row statistics: lane pair (2r', 2r'+1) of warp w owns row w*16 + r'.
  const int my_row = warp * 16 + (lane >> 1);
  const int half = (lane & 1) * (kBK / 2);
  const int g_row = row0 + my_row;
  float m_run = kNegInf, l_run = 0.f;

  int kv_end = Sk;
  if (causal) kv_end = min(Sk, min(row0 + kBQ - 1, Sq - 1) + shift + 1);

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < kBK * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (k0 + r < Sk) {
        const int64_t g = (((int64_t)b * Sk + k0 + r) * Hk + kvh) * D + c;
        kv4 = *reinterpret_cast<const uint4*>(k + g);
        vv4 = *reinterpret_cast<const uint4*>(v + g);
      }
      *reinterpret_cast<uint4*>(Ks + r * L::kQLd + c) = kv4;
      *reinterpret_cast<uint4*>(Vs + r * L::kQLd + c) = vv4;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows (fp32 into shared memory).
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, Qs + warp * 16 * L::kQLd + kk, L::kQLd);
        wmma::load_matrix_sync(bt, Ks + j * 16 * L::kQLd + kk, L::kQLd);
        wmma::mma_sync(sf, a, bt, sf);
      }
      wmma::store_matrix_sync(Ss + warp * 16 * L::kSLd + j * 16, sf, L::kSLd,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Softmax on this lane's 32 columns of its row.
    float* srow = Ss + my_row * L::kSLd + half;
    float mx = kNegInf;
#pragma unroll 8
    for (int c = 0; c < kBK / 2; ++c) {
      const int col = k0 + half + c;
      float s = srow[c];
      if (col >= Sk || (causal && col > g_row + shift)) s = kNegInf;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    float alpha = 1.f, m_new = 0.f;
    if (!clamped) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      m_new = fmaxf(m_run, mx);
      alpha = exp2f(m_run - m_new);
      m_run = m_new;
    }
    float psum = 0.f;
    __nv_bfloat16* prow = Ps + my_row * L::kPLd + half;
#pragma unroll 8
    for (int c = 0; c < kBK / 2; ++c) {
      const float p = clamped ? exp2f(fminf(srow[c], kClamp2)) : exp2f(srow[c] - m_new);
      psum += p;
      prow[c] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * alpha + psum;
    if (!clamped) {
      float* orow = Os + my_row * L::kOLd + (lane & 1) * D2;
      for (int c = 0; c < D2; ++c) orow[c] *= alpha;
    }
    __syncwarp();

    // O += P V for this warp's rows, accumulated through shared memory.
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      float* optr = Os + warp * 16 * L::kOLd + n * 16;
      wmma::load_matrix_sync(of, optr, L::kOLd, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + warp * 16 * L::kPLd + kk, L::kPLd);
        wmma::load_matrix_sync(bv, Vs + kk * L::kQLd + n * 16, L::kQLd);
        wmma::mma_sync(of, a, bv, of);
      }
      wmma::store_matrix_sync(optr, of, L::kOLd, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // Finalize: out = O / l; lse in natural-log units.
  const bool valid = l_run > 0.f && (clamped || m_run > kNegInf / 2);
  if (g_row < Sq) {
    const float* orow = Os + my_row * L::kOLd;
    __nv_bfloat16* dst = out + (((int64_t)b * Sq + g_row) * H + h) * D;
    for (int c = (lane & 1) * D2; c < (lane & 1) * D2 + D2; ++c)
      dst[c] = __float2bfloat16(valid ? orow[c] / l_run : 0.f);
    if ((lane & 1) == 0) {
      float l = kNegInf;
      if (valid) l = clamped ? logf(l_run) : m_run * kLn2 + logf(l_run);
      lse[((int64_t)b * H + h) * Sq + g_row] = l;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* cosv,
           const void* sinv, void* out, void* lse, int B, int Sq, int Sk, int H,
           int Hk, int rope_bstride, float eff_scale, int causal, int clamped,
           cudaStream_t st) {
  const size_t bytes = Smem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D><<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(cosv),
      static_cast<const float*>(sinv), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Sq, Sk, H, Hk, rope_bstride, eff_scale, causal,
      clamped);
  return (int)cudaGetLastError();
}

}  // namespace

// cos/sin: [B or 1, Sq, D/2] fp32 with batch stride rope_bstride (0 when
// shared across the batch), or both null for no rotation.
extern "C" int fatt_flash_fwd(const void* q, const void* k, const void* v,
                              const void* cosv, const void* sinv, void* out,
                              void* lse, int B, int Sq, int Sk, int H, int Hk,
                              int D, int rope_bstride, float eff_scale,
                              int causal, int clamped, void* stream) {
  // Only head_dim 128 (Llama-3) is built; another D needs a card check.
  if (H % Hk != 0 || D != 128) return (int)cudaErrorInvalidValue;
  return launch<128>(q, k, v, cosv, sinv, out, lse, B, Sq, Sk, H, Hk,
                     rope_bstride, eff_scale, causal, clamped,
                     static_cast<cudaStream_t>(stream));
}

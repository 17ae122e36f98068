// K1: single-token decode attention over a BHSD KV cache (bf16, int8 or
// fp8-e4m3 with per-(position, head) fp32 scales).
//
// Replaces flash_attn_tpu/ops/decode.py:_decode_kernel_bhsd.
//
// Bound on the H100: bytes.  Each step reads every live K/V row once
// (B*Hk*kv_len*D*2 elements) and does 4 flops per element; at 1-2 bytes
// per element that is far below the 295 flop/byte ridge.  The design
// therefore only has to read each byte once and keep enough loads in
// flight:
//   * one block serves all H/Hk query heads of one KV head (GQA grouped),
//     so each K/V tile is read from device memory once, not H/Hk times;
//   * each 64-row K and V tile is staged in shared memory by all threads
//     with independent 16-byte loads, then consumed from there: scores by
//     two threads per row, PV by one thread per head-dim column;
//   * tiles at or beyond kv_length are never read;
//   * a split-KV grid axis (blockIdx.y) cuts the sequence so that B*Hk
//     blocks (64 at batch 8) become enough to fill 132 SMs; each split
//     writes an fp32 (out, lse) partial that the wrapper merges with the
//     LSE rule (ops/lse.py).
// Dequantization is fused: scores are scaled by the K scale of their
// position and p by the V scale before the PV product, as on the TPU.
#include "common.cuh"

namespace {

using fatt::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr int kMaxGroup = 8;
constexpr int kMaxD = 128;
constexpr int kRowPad = 32;  // bytes; shifts successive rows by 8 banks
constexpr int kRowBytes = kMaxD * 2 + kRowPad;

// Eight consecutive stored elements as floats.
template <int KV>
__device__ __forceinline__ void load8(const unsigned char* p, float* out) {
  if constexpr (KV == fatt::kBf16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h[e]);
      out[2 * e] = f.x;
      out[2 * e + 1] = f.y;
    }
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const unsigned char* b = reinterpret_cast<const unsigned char*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = fatt::load_kv<KV>(b, e);
  }
}

template <int KV>
__global__ void __launch_bounds__(kThreads) decode_bhsd_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
    const void* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ kv_len,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_out,
    float* __restrict__ part_lse, int B, int H, int Hk, int S, int D,
    int split_len, float qscale, int clamped, float clamp2) {
  constexpr int kElem = KV == fatt::kBf16 ? 2 : 1;
  const int b = blockIdx.x / Hk;
  const int hk = blockIdx.x % Hk;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int G = H / Hk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  __shared__ __align__(16) unsigned char k_s[kTile * kRowBytes];
  __shared__ __align__(16) unsigned char v_s[kTile * kRowBytes];
  __shared__ float q_s[kMaxGroup][kMaxD];
  __shared__ float s_s[kMaxGroup][kTile];
  __shared__ float ks_s[kTile], vs_s[kTile];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], a_s[kMaxGroup];

  // q pre-scaled in bf16, as the TPU kernel folds the softmax scale into
  // its bf16 q block (qscale is already rounded to bf16 by the wrapper).
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float x = __bfloat162float(q[((int64_t)b * H + hk * G + g) * D + d]);
    q_s[g][d] = fatt::bf16_round(x * qscale);
  }
  if (tid < kMaxGroup) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    a_s[tid] = 1.f;
  }
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;

  const int len = min(kv_len[b], S);
  const int lo = split * split_len;
  const int hi = min(lo + split_len, len);
  const int64_t row0 = ((int64_t)b * Hk + hk) * S;  // first cache row
  const int row_bytes = D * kElem;
  const int chunks = row_bytes / 16;  // 16-byte chunks per row
  const unsigned char* kb = static_cast<const unsigned char*>(k);
  const unsigned char* vb = static_cast<const unsigned char*>(v);

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int nvalid = min(kTile, hi - t0);
    __syncthreads();  // the previous tile is consumed; q_s/stats are set
    // Stage the K and V tiles (rows past nvalid are zero).
    for (int i = tid; i < kTile * chunks; i += kThreads) {
      const int r = i / chunks, c = i % chunks;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (r < nvalid) {
        const int64_t off = (row0 + t0 + r) * row_bytes + c * 16;
        kv4 = *reinterpret_cast<const uint4*>(kb + off);
        vv4 = *reinterpret_cast<const uint4*>(vb + off);
      }
      *reinterpret_cast<uint4*>(k_s + r * kRowBytes + c * 16) = kv4;
      *reinterpret_cast<uint4*>(v_s + r * kRowBytes + c * 16) = vv4;
    }
    if (tid < kTile) {
      const bool in = KV != fatt::kBf16 && tid < nvalid;
      ks_s[tid] = in ? ks[row0 + t0 + tid] : 1.f;
      vs_s[tid] = in ? vs[row0 + t0 + tid] : 0.f;
    }
    __syncthreads();

    // Phase 1: s[g][j] = (q_g . k_j) * k_scale_j; two threads per row j,
    // each taking alternate 8-element chunks of the head dim.
    {
      const int j = tid >> 1, h = tid & 1;
      float dots[kMaxGroup];
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) dots[g] = 0.f;
      for (int cc = h; cc < D / 8; cc += 2) {
        float kf[8];
        load8<KV>(k_s + j * kRowBytes + cc * 8 * kElem, kf);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < 8; ++e) dots[g] += q_s[g][cc * 8 + e] * kf[e];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        dots[g] += __shfl_xor_sync(0xffffffffu, dots[g], 1);
      if (h == 0) {
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < G) s_s[g][j] = j < nvalid ? dots[g] * ks_s[j] : kNegInf;
      }
    }
    __syncthreads();

    // Phase 2: softmax statistics, one warp per query head; p * v_scale is
    // rounded to bf16 as the TPU kernel feeds it to the PV product.
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = s_s[g][lane], s1 = s_s[g][lane + 32];
      float p0, p1, alpha = 1.f;
      if (clamped) {
        p0 = exp2f(fminf(s0, clamp2));
        p1 = exp2f(fminf(s1, clamp2));
      } else {
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, fatt::warp_max(fmaxf(s0, s1)));
        alpha = expf(m_prev - m_new);
        p0 = expf(s0 - m_new);
        p1 = expf(s1 - m_new);
        __syncwarp();
        if (lane == 0) m_s[g] = m_new;
      }
      const float psum = fatt::warp_sum(p0 + p1);
      const float v0 = KV != fatt::kBf16 ? vs_s[lane] : 1.f;
      const float v1 = KV != fatt::kBf16 ? vs_s[lane + 32] : 1.f;
      s_s[g][lane] = fatt::bf16_round(p0 * v0);
      s_s[g][lane + 32] = fatt::bf16_round(p1 * v1);
      if (lane == 0) {
        l_s[g] = l_s[g] * alpha + psum;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // Phase 3: acc[g] (column d = tid) = acc * alpha + sum_j p[g][j] v[j][d].
    if (tid < D) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g)
        if (g < G) acc[g] *= a_s[g];
      for (int j = 0; j < nvalid; ++j) {
        const float vv = fatt::load_kv<KV>(v_s + j * kRowBytes, tid);
#pragma unroll
        for (int g = 0; g < kMaxGroup; ++g)
          if (g < G) acc[g] += s_s[g][j] * vv;
      }
    }
  }
  __syncthreads();

  // Finalize: a row is valid iff some unmasked score was seen.
  if (tid < D) {
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g) {
      if (g >= G) continue;
      const float l = l_s[g];
      const bool valid = l > 0.f && (clamped || m_s[g] > kNegInf / 2);
      const float o = valid ? acc[g] / l : 0.f;
      const int64_t h = (int64_t)b * H + hk * G + g;
      if (nsplit == 1) {
        out[h * D + tid] = __float2bfloat16(o);
      } else {
        part_out[((int64_t)split * B * H + h) * D + tid] = o;
      }
    }
  }
  if (tid < G) {
    const float l = l_s[tid];
    const bool valid = l > 0.f && (clamped || m_s[tid] > kNegInf / 2);
    const float lse = valid ? (clamped ? logf(l) : m_s[tid] + logf(l)) : kNegInf;
    part_lse[(int64_t)split * B * H + (int64_t)b * H + hk * G + tid] = lse;
  }
}

}  // namespace

extern "C" int fatt_decode_bhsd(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs,
                                const void* kv_len, void* out, void* part_out,
                                void* part_lse, int B, int H, int Hk, int S,
                                int D, int kv_type, int num_splits,
                                int split_len, float qscale, int clamped,
                                float clamp2, void* stream) {
  if (H % Hk != 0 || H / Hk > kMaxGroup || D > kMaxD || D % 32 != 0 ||
      num_splits < 1 || split_len % kTile != 0)
    return (int)cudaErrorInvalidValue;
  dim3 grid(B * Hk, num_splits);
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const __nv_bfloat16*>(q);
  auto ksp = static_cast<const float*>(ks);
  auto vsp = static_cast<const float*>(vs);
  auto lp = static_cast<const int*>(kv_len);
  auto op = static_cast<__nv_bfloat16*>(out);
  auto po = static_cast<float*>(part_out);
  auto pl = static_cast<float*>(part_lse);
  switch (kv_type) {
    case fatt::kBf16:
      decode_bhsd_kernel<fatt::kBf16><<<grid, kThreads, 0, st>>>(
          qp, k, v, ksp, vsp, lp, op, po, pl, B, H, Hk, S, D, split_len,
          qscale, clamped, clamp2);
      break;
    case fatt::kInt8:
      decode_bhsd_kernel<fatt::kInt8><<<grid, kThreads, 0, st>>>(
          qp, k, v, ksp, vsp, lp, op, po, pl, B, H, Hk, S, D, split_len,
          qscale, clamped, clamp2);
      break;
    case fatt::kFp8:
      decode_bhsd_kernel<fatt::kFp8><<<grid, kThreads, 0, st>>>(
          qp, k, v, ksp, vsp, lp, op, po, pl, B, H, Hk, S, D, split_len,
          qscale, clamped, clamp2);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

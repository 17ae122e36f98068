// K4: FlashAttention-2 forward, BSHD bf16, causal (bottom-right) GQA
// prefill with q-side RoPE applied in the kernel, "clamped" or "online"
// softmax, fp32 LSE.
//
// Replaces flash_attn_tpu/ops/flash_fwd.py:_fwd_kernel on the subset the
// Llama prefill and the training forward use (models/llama.py).
//
// Bound on the H100: operations.  At S = 2048, D = 128 the causal half of
// QK^T and PV is ~4*S^2*D/2 flops per head against ~4*S*D bytes, far above
// the ridge, so the tensor cores set the bound.  The design keeps every
// intermediate in registers and the tensor cores fed:
//   * one block per (64-query tile, head, batch): one warpgroup of 4 warps,
//     16 query rows each.  Each thread builds its Q fragments straight from
//     device memory: scaled, rounded to bf16, rotated in fp32 and rounded
//     again (as flash_fwd.py:146-160 does); a column and its rotation
//     partner 64 away land in the same thread;
//   * QK^T and PV run on wgmma m64n64k16 (bf16 in, fp32 accumulate): A (Q,
//     then P) from registers, B (K, then V transposed) read by descriptor
//     from shared memory once for the warpgroup's 64 rows.  Scores, the
//     running max and sum, and the O accumulator live in registers for the
//     whole KV loop; P is packed to bf16 straight from the score
//     accumulators, whose layout is the A-fragment layout; O is written
//     once, at the end, through the drained ring;
//   * K/V tiles of 64 keys arrive by cp.async into a two-stage ring, so the
//     next tile loads while the current one computes; rows past Sk are
//     zero-filled (src-size 0), so V rows that p = 0 multiplies are finite.
//     The ring holds each tile as two 64-column halves in the 128-byte
//     swizzle that wgmma reads, which also keeps the cp.async writes free
//     of bank conflicts.  65 KB and 167 registers a block: three blocks an
//     SM;
//   * only tiles that a warp's diagonal (or Sk's ragged edge) crosses are
//     masked element by element; tiles above the diagonal are never
//     loaded; the heavy (last) query tiles are scheduled first;
//   * the KV head is h / (H / Hk): GQA without a materialised broadcast.
// Scores are in base-2 units (log2(e) folded into the q pre-scale).
// Clamped mode drops the running max: p = 2^min(s, 80), no rescale.
#include "common.cuh"

namespace {

using fatt::kNegInf;

constexpr int kD = 128;
constexpr int kBQ = 64;  // query rows per block: one warpgroup
constexpr int kBK = 64;  // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;
constexpr int kRowBytes = kD * 2;
constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks per row
constexpr int kTileBytes = kBK * kRowBytes;
// + 1024: the ring starts at the next 1024-byte boundary (the swizzle atom)
constexpr int kSmemBytes = kStages * 2 * kTileBytes + 1024;
constexpr float kClamp2 = 80.f;
constexpr float kLn2 = 0.6931471805599453f;

// Byte offset of 16-byte chunk c of row r in a swizzled [rows][kD] tile.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * kRowBytes + ((c ^ (r & 7)) << 4);
}

// A K/V ring tile is two 64-column halves of kBK rows in the 128-byte
// swizzle (fatt::sw128): every operand K4's products (fatt::attn_qk,
// fatt::attn_pv) read from it spans one swizzle atom (K: 16 of 64 columns;
// V: 64 of 64).

__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ cosv,
    const float* __restrict__ sinv, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int Sq, int Sk, int H, int Hk,
    int rope_bstride, float eff_scale, int causal, int clamped) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_base = fatt::smem_u32(smem);
  const uint32_t kv_base = (s_base + 1023) & ~1023u;
  // The ring's first stage holds O on its way out once the ring is drained.
  unsigned char* Os = smem + (kv_base - s_base);

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heavy causal tiles first
  const int kvh = h / (H / Hk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = qt * kBQ;
  const int shift = Sk - Sq;  // bottom-right causal alignment

  int kv_end = Sk;
  if (causal) kv_end = min(Sk, min(row0 + kBQ - 1, Sq - 1) + shift + 1);
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  // K and V of the tile at key k0 into ring stage st.
  auto load_tile = [&](int st, int k0) {
    const uint32_t ks = kv_base + st * 2 * kTileBytes;
    const uint32_t vs = ks + kTileBytes;
    for (int i = tid; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool in = k0 + r < Sk;
      const int64_t g = (((int64_t)b * Sk + (in ? k0 + r : 0)) * Hk + kvh) * kD + c * 8;
      fatt::cp_async16(ks + fatt::sw128<kBK>(r, c), k + g, in ? 16 : 0);
      fatt::cp_async16(vs + fatt::sw128<kBK>(r, c), v + g, in ? 16 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i, i * kBK);
    fatt::cp_async_commit();
  }

  // Q: scale in fp32, round to bf16, rotate (rotate-half) in fp32 with the
  // row's cos/sin, round to bf16.  Rows >= Sq are zero.
  uint32_t qf[kD / 16][4];  // this warp's 16 rows as A fragments, 16 columns each
  // Straight into the fragments: this thread holds columns 16kk + 2(lane%4)
  // + {0, 1} (+ 8) of rows lane/4 and lane/4 + 8; column c < 64 and its
  // rotation partner c + 64 sit in fragments kk and kk + 4 of one thread.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int gq = row0 + warp * 16 + (lane >> 2) + hf * 8;
    const bool in = gq < Sq;
    const __nv_bfloat16* src = q + (((int64_t)b * Sq + (in ? gq : 0)) * H + h) * kD;
    const int64_t t = (int64_t)b * rope_bstride + (int64_t)(in ? gq : 0) * (kD / 2);
#pragma unroll
    for (int kk = 0; kk < kD / 32; ++kk) {
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int c = kk * 16 + h8 * 8 + (lane & 3) * 2;
        float2 x1 = make_float2(0.f, 0.f), x2 = make_float2(0.f, 0.f);
        if (in) {
          x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + c));
          x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + c + kD / 2));
        }
        float a[2] = {fatt::bf16_round(x1.x * eff_scale), fatt::bf16_round(x1.y * eff_scale)};
        float e[2] = {fatt::bf16_round(x2.x * eff_scale), fatt::bf16_round(x2.y * eff_scale)};
        if (cosv != nullptr) {
          const float2 cs = *reinterpret_cast<const float2*>(cosv + t + c);
          const float2 sn = *reinterpret_cast<const float2*>(sinv + t + c);
          const float cv[2] = {cs.x, cs.y}, sv[2] = {sn.x, sn.y};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float o1 = __fsub_rn(__fmul_rn(a[u], cv[u]), __fmul_rn(e[u], sv[u]));
            const float o2 = __fadd_rn(__fmul_rn(e[u], cv[u]), __fmul_rn(a[u], sv[u]));
            a[u] = o1;
            e[u] = o2;
          }
        }
        qf[kk][hf + 2 * h8] = fatt::pack_bf16(a[0], a[1]);
        qf[kk + kD / 32][hf + 2 * h8] = fatt::pack_bf16(e[0], e[1]);
      }
    }
  }

  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // This thread's rows: wrow0 + lane/4 (accumulator entries 0, 1) and 8
  // below it (entries 2, 3).  l_run holds this thread's share of the sum;
  // the quad's four shares are added at the end.
  const int wrow0 = row0 + warp * 16;
  const int my_row = wrow0 + (lane >> 2);
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + kStages - 1 < n_tiles) load_tile((t + kStages - 1) % kStages, (t + kStages - 1) * kBK);
    fatt::cp_async_commit();
    fatt::cp_async_wait<kStages - 1>();
    fatt::fence_proxy_async();  // cp.async -> wgmma
    __syncthreads();
    const uint32_t ks = kv_base + (t % kStages) * 2 * kTileBytes;
    const uint32_t vs = ks + kTileBytes;
    const int k0 = t * kBK;

    // S = Q K^T: 16 rows x 64 keys as eight n8 tiles.
    float s[kBK / 8][4];
    fatt::attn_qk(s, qf, ks);

    // Mask only where this warp's diagonal or Sk's edge crosses the tile.
    const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > wrow0 + shift);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int row = my_row + (e >> 1) * 8;
          if (col >= Sk || (causal && col > row + shift)) s[j][e] = kNegInf;
        }
    }

    // Softmax in registers; P to bf16 A fragments (keys 16c..16c+15).
    uint32_t pf[kBK / 16][4];
    float alpha[2] = {1.f, 1.f};
    if (!clamped) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
        const float m_new = fmaxf(m_run[hf], fatt::quad_max(mx));
        alpha[hf] = exp2f(m_run[hf] - m_new);
        m_run[hf] = m_new;
      }
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = clamped ? exp2f(fminf(s[j][e], kClamp2)) : exp2f(s[j][e] - m_run[e >> 1]);
        psum[e >> 1] += p[e];
      }
      fatt::put_p(pf, j, p);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l_run[hf] = l_run[hf] * alpha[hf] + psum[hf];
    if (!clamped) {
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
    }

    // O += P V.
    fatt::attn_pv(o, pf, vs);
    __syncthreads();  // the stage is consumed before the ring refills it
  }
  fatt::cp_async_wait<0>();

  // Finalize: out = O / l (staged in this warp's rows of the drained ring,
  // then written as 16-byte rows); lse in natural-log units.
  float inv[2];
  bool valid[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float l = fatt::quad_sum(l_run[hf]);
    valid[hf] = l > 0.f && (clamped || m_run[hf] > kNegInf / 2);
    inv[hf] = valid[hf] ? 1.f / l : 0.f;
    const int row = my_row + hf * 8;
    if ((lane & 3) == 0 && row < Sq) {
      float x = kNegInf;
      if (valid[hf]) x = clamped ? logf(l) : m_run[hf] * kLn2 + logf(l);
      lse[((int64_t)b * H + h) * Sq + row] = x;
    }
  }
  const int lr = warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float x0 = valid[hf] ? o[j][2 * hf] * inv[hf] : 0.f;
      const float x1 = valid[hf] ? o[j][2 * hf + 1] * inv[hf] : 0.f;
      *reinterpret_cast<uint32_t*>(Os + swz(lr + hf * 8, j) + (lane & 3) * 4) =
          fatt::pack_bf16(x0, x1);
    }
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int idx = it * 32 + lane;
    const int r = warp * 16 + idx / kChunks, c = idx % kChunks;
    const int grow = row0 + r;
    if (grow < Sq)
      *reinterpret_cast<uint4*>(out + (((int64_t)b * Sq + grow) * H + h) * kD + c * 8) =
          *reinterpret_cast<const uint4*>(Os + swz(r, c));
  }
}

int launch(const void* q, const void* k, const void* v, const void* cosv,
           const void* sinv, void* out, void* lse, int B, int Sq, int Sk, int H,
           int Hk, int rope_bstride, float eff_scale, int causal, int clamped,
           cudaStream_t st) {
  static fatt::SmemLimitSet smem_set;
  cudaError_t e = fatt::smem_limit_once(flash_fwd_kernel, kSmemBytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, st>>>(
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
  // Only head_dim 128 (Llama-3) is built.
  if (H % Hk != 0 || D != kD || B > 65535 || (Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  return launch(q, k, v, cosv, sinv, out, lse, B, Sq, Sk, H, Hk, rope_bstride,
                eff_scale, causal, clamped, static_cast<cudaStream_t>(stream));
}

// K4: FlashAttention-2 forward, BSHD bf16, causal (bottom-right) GQA
// prefill with q-side RoPE applied in the kernel, "clamped" or "online"
// softmax, fp32 LSE, and optional segment ids and positions (the packed and
// chunked prefill's masks).
//
// Replaces flash_attn_tpu/ops/flash_fwd.py:_fwd_kernel (B7) on the subset
// the Llama prefill paths and the training forward use (models/llama.py).
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
//   * only tiles that a warp's diagonal (or Sk's edge) crosses are
//     masked element by element; tiles above the diagonal are never
//     loaded; the heavy (last) query tiles are scheduled first;
//   * the KV head is h / (H / Hk): GQA without a materialised broadcast.
// Scores are in base-2 units (log2(e) folded into the q pre-scale).
// Clamped mode drops the running max: p = 2^min(s, 80), no rescale.
//
// Segment ids and positions (the kMeta instance): a pair is live only where
// every mask given holds, as _apply_mask composes them (flash_fwd.py:
// 296-347): causal by index, q segment == kv segment, kv position <= q
// position.  A packed prefill's live pairs are a few percent of the square
// (8.5 % at phase 4's eight prompts in 4096), so the design skips what it
// can prove dead and masks only where it must:
//   * the wrapper passes each side's (segment, position) per token, padded
//     to whole tiles ([B, n*64] int2), and each tile's least and greatest
//     segment and position ([B, n] int4), plain torch reductions made once
//     for the mask tensors that a prefill's layers share;
//   * each block first lists its live key tiles in shared memory, 128 at a
//     time by ballot and a prefix count (in order): a k tile is dead when
//     its segment range misses the q tile's, or its least position exceeds
//     the q tile's greatest, or (causal) the index test drops it.  Ranges
//     only have to be conservative, so the test holds whatever the order of
//     the ids, padding (id 0, position 0) included.  The list entry also
//     says whether the pair is live throughout (one segment on both sides
//     and greatest kv position <= least q position); every other listed
//     tile is masked element by element.  On request (tile_count) head 0's
//     blocks add up their lists, so a check can read back what was walked;
//   * the cp.async ring walks the list, so it prefetches the next live
//     tile, and each tile's 64 (segment, position) pairs ride beside its
//     K/V in a small ring of their own; each thread holds its two rows'
//     segment and position in registers;
//   * a dead tile adds exactly 0 in both softmax modes, so skipping it
//     changes nothing.  A row with no live key gives 0 and lse -1e30;
//     padding rows (segment 0, position 0) see every padding key, as in
//     JAX;
//   * the q tiles keep the causal order (last first): in a chunk over a
//     cache and within a packed prompt the later tiles see the most keys.
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
// With masks: a stage's 64 (segment, position) pairs after the K/V ring,
// then the block's list of live key tiles (at most kMaxListTiles).
constexpr int kMetaBytes = kBK * 8;
constexpr int kMaxListTiles = 4096;
constexpr int kFullBit = 1 << 30;  // list entry: live throughout, no mask
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

// qmeta/kmeta: [B, nq*64] / [B, nk*64] (segment, position) per token;
// qrange/krange: [B, nq] / [B, nk] (least segment, least position, greatest
// segment, greatest position) per tile.  Read only by the kMeta instance.
template <bool kMeta>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ cosv,
    const float* __restrict__ sinv, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, const int2* __restrict__ qmeta,
    const int2* __restrict__ kmeta, const int4* __restrict__ qrange,
    const int4* __restrict__ krange, int* __restrict__ tile_count, int Sq, int Sk,
    int H, int Hk, int rope_bstride, float eff_scale, int causal, int clamped) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_base = fatt::smem_u32(smem);
  const uint32_t kv_base = (s_base + 1023) & ~1023u;
  // The ring's first stage holds O on its way out once the ring is drained.
  unsigned char* Os = smem + (kv_base - s_base);
  // kMeta: the tiles' (segment, position) ring, then the live-tile list.
  const uint32_t meta_base = kv_base + kStages * 2 * kTileBytes;
  const unsigned char* meta_s = smem + (meta_base - s_base);
  int* list = reinterpret_cast<int*>(smem + (meta_base - s_base) + kStages * kMetaBytes);

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heavy (last) tiles first
  const int kvh = h / (H / Hk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = qt * kBQ;
  const int shift = Sk - Sq;  // bottom-right causal alignment
  const int nk = (Sk + kBK - 1) / kBK;

  int kv_end = Sk;
  if (causal) kv_end = min(Sk, min(row0 + kBQ - 1, Sq - 1) + shift + 1);
  const int n_tiles = kv_end > 0 ? (kv_end + kBK - 1) / kBK : 0;

  // The block's live key tiles, in order, each with its kFullBit.
  int n_live = n_tiles;
  if constexpr (kMeta) {
    __shared__ int warp_live[kWarps];
    const int4 qr = qrange[(int64_t)b * gridDim.z + qt];
    int n = 0;
    for (int base = 0; base < n_tiles; base += kThreads) {
      const int t = base + tid;
      bool live = false;
      int entry = t;
      if (t < n_tiles) {
        const int4 kr = krange[(int64_t)b * nk + t];
        live = kr.z >= qr.x && kr.x <= qr.z && kr.y <= qr.w;
        if (qr.x == qr.z && kr.x == kr.z && kr.x == qr.x && kr.w <= qr.y) entry |= kFullBit;
      }
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (lane == 0) warp_live[warp] = __popc(m);
      __syncthreads();
      int off = n;
      for (int w = 0; w < warp; ++w) off += warp_live[w];
      if (live) list[off + __popc(m & ((1u << lane) - 1u))] = entry;
      for (int w = 0; w < kWarps; ++w) n += warp_live[w];
      __syncthreads();  // the list is complete; warp_live is free again
    }
    n_live = n;
    // On request, head 0's blocks add their list's length and its tiles
    // live throughout (tile_count[0], [1]): the count of what the walk
    // visits, read back by the card's checks.
    if (tile_count != nullptr && h == 0 && tid == 0) {
      int n_full = 0;
      for (int i = 0; i < n; ++i) n_full += (list[i] & kFullBit) != 0;
      atomicAdd(tile_count, n);
      atomicAdd(tile_count + 1, n_full);
    }
  }
  // Key tile of the walk's step i, and whether it needs no segment or
  // position mask.
  auto tile_of = [&](int i) { return kMeta ? list[i] & (kFullBit - 1) : i; };

  // K and V of the tile at key k0 into ring stage st (with masks, also its
  // 64 (segment, position) pairs).
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
    if constexpr (kMeta) {
      if (tid < kMetaBytes / 16)
        fatt::cp_async16(meta_base + st * kMetaBytes + tid * 16,
                         kmeta + (int64_t)b * nk * kBK + k0 + tid * 2, 16);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_live) load_tile(i, tile_of(i) * kBK);
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
  // kMeta: the (segment, position) of this thread's two rows (padded, so
  // rows past Sq read the last row's).
  int2 qm[2] = {make_int2(0, 0), make_int2(0, 0)};
  if constexpr (kMeta) {
    const int2* qrow = qmeta + (int64_t)b * gridDim.z * kBQ;
    qm[0] = qrow[my_row];
    qm[1] = qrow[my_row + 8];
  }

  for (int t = 0; t < n_live; ++t) {
    if (t + kStages - 1 < n_live)
      load_tile((t + kStages - 1) % kStages, tile_of(t + kStages - 1) * kBK);
    fatt::cp_async_commit();
    fatt::cp_async_wait<kStages - 1>();
    fatt::fence_proxy_async();  // cp.async -> wgmma
    __syncthreads();
    const int st = t % kStages;
    const uint32_t ks = kv_base + st * 2 * kTileBytes;
    const uint32_t vs = ks + kTileBytes;
    const int k0 = tile_of(t) * kBK;

    // S = Q K^T: 16 rows x 64 keys as eight n8 tiles.
    float s[kBK / 8][4];
    fatt::attn_qk(s, qf, ks);

    // Mask only where this warp's diagonal or Sk's edge crosses the tile,
    // or, with masks, where the list does not say the tile is live throughout.
    bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > wrow0 + shift);
    if constexpr (kMeta) edge = edge || !(list[t] & kFullBit);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        // keys c and c + 1 of the tile: (segment, position, segment, position)
        int4 km = make_int4(0, 0, 0, 0);
        if constexpr (kMeta)
          km = *reinterpret_cast<const int4*>(meta_s + st * kMetaBytes +
                                              (j * 8 + (lane & 3) * 2) * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int row = my_row + (e >> 1) * 8;
          bool dead = col >= Sk || (causal && col > row + shift);
          if constexpr (kMeta) {
            const int kseg = (e & 1) ? km.z : km.x, kpos = (e & 1) ? km.w : km.y;
            dead = dead || kseg != qm[e >> 1].x || kpos > qm[e >> 1].y;
          }
          if (dead) s[j][e] = kNegInf;
        }
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

template <bool kMeta>
int launch(const void* q, const void* k, const void* v, const void* cosv,
           const void* sinv, void* out, void* lse, const void* qmeta,
           const void* kmeta, const void* qrange, const void* krange, int* tile_count,
           int B, int Sq, int Sk, int H, int Hk, int rope_bstride, float eff_scale,
           int causal, int clamped, cudaStream_t st) {
  static fatt::SmemLimitSet smem_set;
  constexpr int kMaxSmem =
      kSmemBytes + (kMeta ? kStages * kMetaBytes + kMaxListTiles * 4 : 0);
  cudaError_t e = fatt::smem_limit_once(flash_fwd_kernel<kMeta>, kMaxSmem, smem_set);
  if (e != cudaSuccess) return (int)e;
  const int nk = (Sk + kBK - 1) / kBK;
  const int smem = kSmemBytes + (kMeta ? kStages * kMetaBytes + nk * 4 : 0);
  dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<kMeta><<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(cosv),
      static_cast<const float*>(sinv), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), static_cast<const int2*>(qmeta),
      static_cast<const int2*>(kmeta), static_cast<const int4*>(qrange),
      static_cast<const int4*>(krange), tile_count, Sq, Sk, H, Hk, rope_bstride,
      eff_scale, causal, clamped);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Sq, int H, int Hk, int D) {
  // Only head_dim 128 (Llama-3) is built.
  return H % Hk != 0 || D != kD || B > 65535 || (Sq + kBQ - 1) / kBQ > 65535;
}

}  // namespace

// cos/sin: [B or 1, Sq, D/2] fp32 with batch stride rope_bstride (0 when
// shared across the batch), or both null for no rotation.
// Segment ids and positions: qmeta [B, ceil(Sq/64)*64] and kmeta [B,
// ceil(Sk/64)*64] int32 pairs (segment, position), padded by repeating the
// last token; qrange [B, ceil(Sq/64)] and krange [B, ceil(Sk/64)] int32
// quads (least segment, least position, greatest segment, greatest
// position); a mask not given is 0 throughout.  All four null: no masks
// (the instance without them).  tile_count: null, or with masks int32[2]
// that head 0's blocks add their live and unmasked key tiles to.
extern "C" int fatt_flash_fwd(const void* q, const void* k, const void* v,
                              const void* cosv, const void* sinv, void* out,
                              void* lse, const void* qmeta, const void* kmeta,
                              const void* qrange, const void* krange, int* tile_count,
                              int B, int Sq, int Sk, int H, int Hk, int D,
                              int rope_bstride, float eff_scale, int causal,
                              int clamped, void* stream) {
  const int given = (qmeta != nullptr) + (kmeta != nullptr) + (qrange != nullptr) +
                    (krange != nullptr);
  // With masks a block lists at most kMaxListTiles key tiles.
  if (bad_shape(B, Sq, H, Hk, D) ||
      (given != 0 && (given != 4 || (Sk + kBK - 1) / kBK > kMaxListTiles)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (given == 0)
    return launch<false>(q, k, v, cosv, sinv, out, lse, nullptr, nullptr, nullptr,
                         nullptr, nullptr, B, Sq, Sk, H, Hk, rope_bstride, eff_scale,
                         causal, clamped, st);
  return launch<true>(q, k, v, cosv, sinv, out, lse, qmeta, kmeta, qrange, krange,
                      tile_count, B, Sq, Sk, H, Hk, rope_bstride, eff_scale, causal,
                      clamped, st);
}

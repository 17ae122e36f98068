// K1c / K8c: chunk attention over a quantized KV cache, contiguous (BHSD)
// or paged, on wgmma.  T causal query tokens per sequence ride as T*G
// virtual rows per KV head in (t, g) order; row r sees the positions below
// kv_len - (T-1) + r/G.  The same kernel takes decode calls with more query
// heads per KV head than the decode kernels hold (BHSD G > 8, paged G > 16).
//
// Replaces flash_attn_tpu/ops/decode.py:_decode_kernel_bhsd in chunk mode
// (B1, flash_decode_chunk: the speculative verify step) and
// flash_attn_tpu/ops/paged_decode.py:_paged_decode_kernel in chunk mode
// (B8, paged_flash_decode_chunk: the prefix-hit suffix prefill).  The two
// compute one function and differ only in how a position finds its K/V row:
// row (b*Hk + hk)*S + t of a [B, Hk, S, D] cache, or row (page*Hk + hk)*
// page_size + t % page_size of a [P, Hk, page_size, D] pool through the
// block table; the scales sit at the same row index.
//
// Bound on the H100:
//   * the verify step (T = 5, 20 rows per KV head at G = 4, 40 at G = 8) by
//     bytes: each live K/V row is needed once per KV head for 4 flops per
//     element and query row, far below the 295 flop/byte ridge;
//   * the suffix prefill (T = 128, 512 rows per KV head) by operations:
//     each key serves hundreds of rows.
// The design reads each K/V tile from device memory once per block of rows
// and keeps the products on the tensor cores:
//   * a block serves (sequence, KV head, row block, split): one warpgroup of
//     64 rows when R = T*G <= 64 (every verify step: one block reads the
//     cache once per KV head), kWideW warpgroups of 64 above that, so the
//     suffix prefill reads and converts each tile R / (64 kWideW) times;
//   * raw K/V bytes and their scales stream through a cp.async ring of 64-key
//     tiles (16-byte copies, rows past the walk zero-filled); a tile never
//     straddles a page, since a page is a multiple of 64;
//   * once per block, all threads convert a landed int8 or e4m3 tile to bf16
//     (exact) into K4's layout, D / 64 swizzled 64-column parts, then fence the
//     async proxy and meet at one barrier: every warpgroup reads the one copy.
//     bf16 tiles land in that layout directly;
//   * S = Q K^T and O += P V run on wgmma m64n64k16 (fatt::attn_qk,
//     fatt::attn_pv, as K4): Q (pre-scaled, rounded to bf16) and P (p *
//     v_scale rounded to bf16, packed from the score accumulators) from
//     registers, K and V by descriptor.  Scores, softmax statistics and O
//     stay in registers for the whole walk; O is written once;
//   * each score is scaled by its column's K scale after QK^T; only tiles
//     that cross some row's limit in a warp are masked element by element;
//     a row block stops at its highest limit, never past the capacity S or
//     the table's reach;
//   * splits follow the live walk, not the capacity: a block reads kv_len,
//     counts the live tiles n = ceil(min(kv_len, reach) / 64), and split i
//     takes tiles [i*c, (i+1)*c), c = ceil(n / nsplit).  The host picks
//     nsplit from a target of blocks without reading kv_len (no sync, so a
//     CUDA graph can capture the call).  One split writes bf16 out; several
//     write fp32 (out, lse) partials that K1m merges.
// Clamped mode: p = 2^min(s, clamp2) with log2(e) in the q pre-scale, no
// running max; online mode keeps a running max in natural units.  A row
// with no visible key writes out 0 and lse -1e30.
//
// The sliding window and the logit softcap (Mistral, Gemma-2) are built
// into instances of their own (kLocal, entry fatt_chunk_attn_local), so the
// instances without them keep their code, as K4's kLocal ones do
// (flash_attn_tpu/ops/decode.py:835-862, 931-940; paged_decode.py:150-160,
// 224-226, 362-374):
//   * row r also needs positions >= lo(r) = kv_len - (T-1) + r/G - window:
//     the last `window` positions below its limit;
//   * the walk starts at the tile holding the loosest row's (t = 0) lower
//     bound, floor(max(0, kv_len - (T-1) - window) / 64) * 64 (a multiple of
//     64, so a paged tile still never straddles a page), and the splits cut
//     that walk, so the keys below the window are never read;
//   * a tile is masked element by element where some row's limit or window
//     edge in the warp crosses it;
//   * the softcap, s = c * tanh(s / c) on the scores after the K scale and
//     before the mask, c in the scores' units (base 2 when clamped), on
//     fatt::tanh_exp2 as K4's.
//
// Head dim 64 (GPT-2) or 128, a template parameter: at 64 a bf16 tile is
// one swizzled 64-column part (8 KB a K or V tile of 64 keys), a raw
// 1-byte row is 64 bytes (4 chunks, swizzled by raw_pos), QK^T takes 4
// depth steps and PV one n64 product.
#include <climits>

#include "common.cuh"

namespace {

using fatt::kNegInf;

constexpr int kBK = 64;                   // keys per tile
constexpr int kWgRows = 64;               // query rows per warpgroup
constexpr int kWideW = 2;                 // warpgroups a block when R > 64

// Shared memory from a 1024-byte boundary.  1-byte KV: the converted K and
// V tiles, then a ring of three stages of raw K, raw V (kD-byte rows,
// swizzled by raw_pos) and their 64 + 64 scales; 82.5 KB at kD = 128, two
// blocks an SM.  bf16 KV: a ring of two stages of K and V tiles in the
// operand layout; 65 KB at kD = 128.
template <int KV, int kD>
struct Layout {
  static constexpr int kTileBytes = kBK * kD * 2;  // a bf16 K or V tile
  static constexpr int kRawBytes = kBK * kD;       // a 1-byte K or V tile
  static constexpr bool kRaw = KV != fatt::kBf16;
  static constexpr int kStages = kRaw ? 3 : 2;
  static constexpr int kStageBytes = kRaw ? 2 * kRawBytes + 2 * kBK * 4 : 2 * kTileBytes;
  static constexpr int kRing = kRaw ? 2 * kTileBytes : 0;
  static constexpr int kBytes = kRing + kStages * kStageBytes + 1024;
};

struct Params {
  const __nv_bfloat16* q;  // [B, Hk * R, D] virtual rows
  const unsigned char* k;
  const unsigned char* v;
  const float* k_scale;
  const float* v_scale;
  const int* table;  // [B, max_pages] (paged) or null
  const int* kv_len;
  __nv_bfloat16* out;  // [B, Hk * R, D] (one split)
  float* part_out;     // [nsplit, B, Hk * R, D] (several)
  float* part_lse;     // [nsplit, B, Hk * R]
  int B, Hk, R, chunk, S, page, max_pages;
  float qscale, clamp2;
  int clamped;
  int window;     // kLocal: 0 or the positions below its limit a row sees
  float softcap;  // kLocal: 0 or the cap in the scores' units
};

// 16 stored bytes (columns 16c..16c+15) as two 16-byte rows of bf16.
template <int KV>
__device__ __forceinline__ void to_bf16(const uint4& raw, uint4& lo, uint4& hi) {
  uint32_t w[8];
  if constexpr (KV == fatt::kFp8) {
    const auto* p = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const __half2 h(__nv_cvt_fp8x2_to_halfraw2(p[i], __NV_E4M3));
      const float2 f = __half22float2(h);
      w[i] = fatt::pack_bf16(f.x, f.y);
    }
  } else {
    const auto* p = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      w[i] = fatt::pack_bf16(static_cast<float>(p[2 * i]), static_cast<float>(p[2 * i + 1]));
  }
  lo = make_uint4(w[0], w[1], w[2], w[3]);
  hi = make_uint4(w[4], w[5], w[6], w[7]);
}

// Byte offset of 16-byte chunk c of row r in a raw 1-byte tile of kD-byte
// rows: eight consecutive rows at one chunk hit eight distinct bank groups
// (at kD = 64 two rows share a 128-byte line, so the XOR takes r / 2).
template <int kD>
__device__ __forceinline__ int raw_pos(int r, int c) {
  if constexpr (kD == 128) return r * 128 + ((c ^ (r & 7)) << 4);
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

template <int KV, int W, bool kPaged, int kD, bool kLocal>
__global__ void __launch_bounds__(128 * W, W == 1 ? (kD == 64 ? 3 : 2) : 1)
    chunk_attn_kernel(const Params p) {
  using L = Layout<KV, kD>;
  constexpr int kTileBytes = L::kTileBytes;
  constexpr int kRawBytes = L::kRawBytes;
  constexpr int kThreads = 128 * W;
  constexpr int kElem = L::kRaw ? 1 : 2;
  constexpr int kChunks = kD * kElem / 16;  // 16-byte chunks of a K/V row
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_base = fatt::smem_u32(smem);
  const uint32_t base = (s_base + 1023) & ~1023u;
  unsigned char* sm = smem + (base - s_base);
  const uint32_t ring = base + L::kRing;

  const int rb = gridDim.x - 1 - blockIdx.x;  // heavy (later) row blocks first
  const int bh = blockIdx.y, b = bh / p.Hk, hk = bh % p.Hk;
  const int split = blockIdx.z, nsplit = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = p.R, G = R / p.chunk;
  const int r0 = rb * kWgRows * W;
  const int wrow0 = r0 + warp * 16;  // warp w of warpgroup g: rows 64g + 16(w % 4)..
  const int my_row = wrow0 + (lane >> 2);

  // Row r sees positions < lim(r), never past the capacity or the table's
  // reach (an idle slot's length runs past it); rows past R take row R-1's.
  const int len = p.kv_len[b];
  const int cap = kPaged ? p.max_pages * p.page : p.S;
  auto lim = [&](int r) { return min(len - (p.chunk - 1) + min(r, R - 1) / G, cap); };
  // kLocal: row r's lowest position, lim(r) - window before the cap.
  auto lo = [&](int r) { return len - (p.chunk - 1) + min(r, R - 1) / G - p.window; };
  // The split's tiles of the live walk, cut to this block's highest limit;
  // with a window the walk starts at the tile of the loosest row's bound.
  const int t_begin = kLocal && p.window > 0 ? max(0, lo(0)) / kBK : 0;
  const int n_live = max(0, (max(0, min(len, cap)) + kBK - 1) / kBK - t_begin);
  const int per = (n_live + nsplit - 1) / nsplit;
  const int t_lo = t_begin + split * per;
  const int walk_end = max(0, lim(r0 + kWgRows * W - 1));
  const int n_tiles =
      max(0, min(t_begin + (split + 1) * per, (walk_end + kBK - 1) / kBK) - t_lo);

  // Tile i of the split into ring stage i % kStages; rows past walk_end are
  // zero-filled (their scores are masked and p = 0 meets finite V).
  auto load_tile = [&](int i) {
    const uint32_t st = ring + (i % L::kStages) * L::kStageBytes;
    const int k0 = (t_lo + i) * kBK;
    const int nvalid = min(kBK, walk_end - k0);
    int64_t row0;
    if constexpr (kPaged) {
      const int pid = p.table[(int64_t)b * p.max_pages + k0 / p.page];
      row0 = ((int64_t)pid * p.Hk + hk) * p.page + k0 % p.page;
    } else {
      row0 = ((int64_t)b * p.Hk + hk) * p.S + k0;
    }
#pragma unroll
    for (int e = tid; e < kBK * kChunks; e += kThreads) {
      const int r = e / kChunks, c = e % kChunks;
      const bool in = r < nvalid;
      const int64_t off = (row0 + (in ? r : 0)) * (kD * kElem) + c * 16;
      uint32_t dst;
      if constexpr (L::kRaw) {
        dst = st + raw_pos<kD>(r, c);
      } else {
        dst = st + fatt::sw128<kBK>(r, c);
      }
      fatt::cp_async16(dst, p.k + off, in ? 16 : 0);
      fatt::cp_async16(dst + (L::kRaw ? kRawBytes : kTileBytes), p.v + off, in ? 16 : 0);
    }
    if constexpr (L::kRaw) {
      if (tid < 2 * kBK) {
        const int r = tid % kBK;
        const bool in = r < nvalid;
        const float* src = (tid < kBK ? p.k_scale : p.v_scale) + row0 + (in ? r : 0);
        fatt::cp_async4(st + 2 * kRawBytes + tid * 4, src, in ? 4 : 0);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    fatt::cp_async_commit();
  }

  // Q as A fragments, straight from device memory: this thread's rows
  // my_row and my_row + 8, columns 16kk + 2(lane%4) + {0, 1} (+ 8), scaled
  // and rounded to bf16 once.  Rows past R are zero.
  const int64_t qrow0 = (int64_t)bh * R;
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = my_row + hf * 8;
    const bool in = r < R;
    const __nv_bfloat16* src = p.q + (qrow0 + (in ? r : 0)) * kD;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int c = kk * 16 + h8 * 8 + (lane & 3) * 2;
        float2 x = make_float2(0.f, 0.f);
        if (in) x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + c));
        qf[kk][hf + 2 * h8] = fatt::pack_bf16(x.x * p.qscale, x.y * p.qscale);
      }
    }
  }

  const int row_lim[2] = {lim(my_row), lim(my_row + 8)};
  const int warp_lim = lim(wrow0);  // the lowest limit of the warp's rows
  // kLocal: this thread's rows' lowest positions, and the highest of the
  // warp's (INT_MIN without a window, a constant in the other instances:
  // nothing below it is masked)
  const bool windowed = kLocal && p.window > 0;
  const int row_lo[2] = {windowed ? lo(my_row) : INT_MIN, windowed ? lo(my_row + 8) : INT_MIN};
  const int warp_lo = windowed ? lo(wrow0 + 15) : INT_MIN;
  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    fatt::cp_async_wait<L::kStages - 2>();
    if constexpr (!L::kRaw) fatt::fence_proxy_async();  // cp.async -> wgmma
    // Tile t has landed for every thread, and every warpgroup is done with
    // the previous tile's operands (its wgmma waited before this barrier).
    __syncthreads();
    if (t + L::kStages - 1 < n_tiles) load_tile(t + L::kStages - 1);
    fatt::cp_async_commit();
    const uint32_t st = ring + (t % L::kStages) * L::kStageBytes;
    uint32_t kt = st, vt = st + kTileBytes;
    const float* ksc = nullptr;
    const float* vsc = nullptr;
    if constexpr (L::kRaw) {
      // Convert once for the block: 16-byte chunk c of raw row r into bf16
      // chunks 2c, 2c + 1; eight consecutive threads take eight rows, so
      // both the raw reads and the swizzled writes are free of conflicts.
      constexpr int kRawChunks = kD / 16;
      const unsigned char* raw = sm + (st - base);
#pragma unroll
      for (int e = tid; e < 2 * kBK * kRawChunks; e += kThreads) {
        const int half = e / (kBK * kRawChunks), r = e % kBK, c = (e / kBK) % kRawChunks;
        const uint4 x =
            *reinterpret_cast<const uint4*>(raw + half * kRawBytes + raw_pos<kD>(r, c));
        uint4 lo, hi;
        to_bf16<KV>(x, lo, hi);
        unsigned char* dst = sm + half * kTileBytes;
        *reinterpret_cast<uint4*>(dst + fatt::sw128<kBK>(r, 2 * c)) = lo;
        *reinterpret_cast<uint4*>(dst + fatt::sw128<kBK>(r, 2 * c + 1)) = hi;
      }
      fatt::fence_proxy_async();  // st.shared -> wgmma
      __syncthreads();
      kt = base;
      vt = base + kTileBytes;
      ksc = reinterpret_cast<const float*>(raw + 2 * kRawBytes);
      vsc = ksc + kBK;
    }

    float s[kBK / 8][4];
    fatt::attn_qk(s, qf, kt);
    const int k0 = (t_lo + t) * kBK;
    const int cq = (lane & 3) * 2;  // this thread's first column of each n8 block
    if constexpr (L::kRaw) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float2 sc = *reinterpret_cast<const float2*>(ksc + j * 8 + cq);
        s[j][0] *= sc.x;
        s[j][1] *= sc.y;
        s[j][2] *= sc.x;
        s[j][3] *= sc.y;
      }
    }
    if (kLocal && p.softcap > 0.f) {
      const float inv_cap = 1.f / p.softcap;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = p.softcap * fatt::tanh_exp2(s[j][e] * inv_cap);
    }
    if (k0 + kBK > warp_lim || k0 < warp_lo) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + cq + (e & 1);
          if (col >= row_lim[e >> 1] || col < row_lo[e >> 1]) s[j][e] = kNegInf;
        }
    }

    float alpha[2] = {1.f, 1.f};
    if (!p.clamped) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
        const float m_new = fmaxf(m_run[hf], fatt::quad_max(mx));
        alpha[hf] = expf(m_run[hf] - m_new);
        m_run[hf] = m_new;
      }
    }
    uint32_t pf[kBK / 16][4];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      float2 vsj = make_float2(1.f, 1.f);
      if constexpr (L::kRaw) vsj = *reinterpret_cast<const float2*>(vsc + j * 8 + cq);
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = p.clamped ? exp2f(fminf(s[j][e], p.clamp2)) : expf(s[j][e] - m_run[e >> 1]);
        psum[e >> 1] += x;
        pv[e] = L::kRaw ? x * ((e & 1) ? vsj.y : vsj.x) : x;
      }
      fatt::put_p(pf, j, pv);  // p * v_scale rounded to bf16
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l_run[hf] = l_run[hf] * alpha[hf] + psum[hf];
    if (!p.clamped) {
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
    }
    fatt::attn_pv(o, pf, vt);
  }
  fatt::cp_async_wait<0>();

  // A row is valid iff some unmasked score was seen; lse in natural units.
  const int64_t rows = (int64_t)p.B * p.Hk * R;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = my_row + hf * 8;
    const float l = fatt::quad_sum(l_run[hf]);
    const bool valid = l > 0.f && (p.clamped || m_run[hf] > kNegInf / 2);
    if (r >= R) continue;
    const int64_t h = qrow0 + r;
    if ((lane & 3) == 0)
      p.part_lse[split * rows + h] =
          valid ? (p.clamped ? logf(l) : m_run[hf] + logf(l)) : kNegInf;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const float x0 = valid ? o[j][2 * hf] / l : 0.f;
      const float x1 = valid ? o[j][2 * hf + 1] / l : 0.f;
      const int col = j * 8 + (lane & 3) * 2;
      if (nsplit == 1) {
        *reinterpret_cast<uint32_t*>(p.out + h * kD + col) = fatt::pack_bf16(x0, x1);
      } else {
        *reinterpret_cast<float2*>(p.part_out + (split * rows + h) * kD + col) =
            make_float2(x0, x1);
      }
    }
  }
}

template <int KV, int W, bool kPaged, int kD, bool kLocal>
int launch(const Params& p, int nsplit, cudaStream_t st) {
  auto kernel = chunk_attn_kernel<KV, W, kPaged, kD, kLocal>;
  static fatt::SmemLimitSet smem_set;  // one for each instance
  constexpr int kBytes = Layout<KV, kD>::kBytes;
  cudaError_t e = fatt::smem_limit_once(kernel, kBytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((p.R + kWgRows * W - 1) / (kWgRows * W), p.B * p.Hk, nsplit);
  kernel<<<grid, 128 * W, kBytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <int KV, int kD, bool kLocal>
int launch_d(const Params& p, int nsplit, cudaStream_t st) {
  const bool wide = p.R > kWgRows;
  if (p.table != nullptr)
    return wide ? launch<KV, kWideW, true, kD, kLocal>(p, nsplit, st)
                : launch<KV, 1, true, kD, kLocal>(p, nsplit, st);
  return wide ? launch<KV, kWideW, false, kD, kLocal>(p, nsplit, st)
              : launch<KV, 1, false, kD, kLocal>(p, nsplit, st);
}

template <int KV, bool kLocal>
int launch_kv(const Params& p, int D, int nsplit, cudaStream_t st) {
  return D == 64 ? launch_d<KV, 64, kLocal>(p, nsplit, st)
                 : launch_d<KV, 128, kLocal>(p, nsplit, st);
}

template <bool kLocal>
int chunk_attn(const void* q, const void* k, const void* v, const void* ks, const void* vs,
               const void* table, const void* kv_len, void* out, void* part_out,
               void* part_lse, int B, int Hk, int R, int chunk, int S, int page,
               int max_pages, int D, int kv_type, int num_splits, float qscale, int clamped,
               float clamp2, int window, float softcap, void* stream) {
  const bool paged = table != nullptr;
  if ((D != 64 && D != 128) || R < 1 || chunk < 1 || R % chunk != 0 || num_splits < 1 ||
      num_splits > 65535 || B < 1 || Hk < 1 || (int64_t)B * Hk > 65535 ||
      (paged ? (page < kBK || page % kBK != 0 || max_pages < 1) : S < 1) ||
      (kv_type != fatt::kBf16 && (ks == nullptr || vs == nullptr)) || window < 0 ||
      !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  Params p{static_cast<const __nv_bfloat16*>(q),
           static_cast<const unsigned char*>(k),
           static_cast<const unsigned char*>(v),
           static_cast<const float*>(ks),
           static_cast<const float*>(vs),
           static_cast<const int*>(table),
           static_cast<const int*>(kv_len),
           static_cast<__nv_bfloat16*>(out),
           static_cast<float*>(part_out),
           static_cast<float*>(part_lse),
           B, Hk, R, chunk, S, page, max_pages, qscale, clamp2, clamped, window, softcap};
  auto st = static_cast<cudaStream_t>(stream);
  switch (kv_type) {
    case fatt::kBf16:
      return launch_kv<fatt::kBf16, kLocal>(p, D, num_splits, st);
    case fatt::kInt8:
      return launch_kv<fatt::kInt8, kLocal>(p, D, num_splits, st);
    case fatt::kFp8:
      return launch_kv<fatt::kFp8, kLocal>(p, D, num_splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// D: 64 or 128.  q: [B, Hk * R, D] bf16 rows, R = chunk * (H / Hk) per KV head in (t, g)
// order.  table null: k, v a contiguous [B, Hk, S, D] cache (scales
// [B, Hk, S]); else a pool [P, Hk, page, D] (scales [P, Hk, page]) through
// table [B, max_pages] int32, page a multiple of 64.  Scales fp32, null for
// bf16; kv_len [B] int32 includes the chunk.  One split writes out
// [B, Hk * R, D] bf16, several write fp32 partials part_out [n, B, Hk * R, D];
// part_lse [n, B, Hk * R] always.
extern "C" int fatt_chunk_attn(const void* q, const void* k, const void* v, const void* ks,
                               const void* vs, const void* table, const void* kv_len,
                               void* out, void* part_out, void* part_lse, int B, int Hk,
                               int R, int chunk, int S, int page, int max_pages, int D,
                               int kv_type, int num_splits, float qscale, int clamped,
                               float clamp2, void* stream) {
  return chunk_attn<false>(q, k, v, ks, vs, table, kv_len, out, part_out, part_lse, B, Hk, R,
                           chunk, S, page, max_pages, D, kv_type, num_splits, qscale, clamped,
                           clamp2, 0, 0.f, stream);
}

// fatt_chunk_attn's arguments and, before the stream, window (0 or the
// positions below its limit each row sees) and softcap (0 or the cap in
// the scores' units, base 2 when clamped): the kLocal instances.
extern "C" int fatt_chunk_attn_local(const void* q, const void* k, const void* v,
                                     const void* ks, const void* vs, const void* table,
                                     const void* kv_len, void* out, void* part_out,
                                     void* part_lse, int B, int Hk, int R, int chunk, int S,
                                     int page, int max_pages, int D, int kv_type,
                                     int num_splits, float qscale, int clamped, float clamp2,
                                     int window, float softcap, void* stream) {
  return chunk_attn<true>(q, k, v, ks, vs, table, kv_len, out, part_out, part_lse, B, Hk, R,
                          chunk, S, page, max_pages, D, kv_type, num_splits, qscale, clamped,
                          clamp2, window, softcap, stream);
}

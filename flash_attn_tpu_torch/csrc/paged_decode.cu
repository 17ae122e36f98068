// K8: attention over a paged KV pool (bf16, int8 or fp8-e4m3 pages with
// per-(page row, head) fp32 scales) through a block table, in decode mode:
// one query token per sequence, at most 16 query heads per KV head.  Chunk
// mode (T query tokens per sequence) and decode calls with more heads per
// KV head run on the chunk kernel, K8c (csrc/chunk_attn.cu).
//
// Replaces flash_attn_tpu/ops/paged_decode.py:_paged_decode_kernel in
// decode mode (paged_flash_decode).
//
// Bound on the H100: bytes.  Every live page row of K and V is needed once
// per KV head, for 4 flops per element and query row: at most 16 rows is
// far below the 295 flop/byte ridge.  So the design reads each live row
// once, keeps loads in flight the whole walk, keeps the arithmetic off the
// CUDA cores and spends one launch a call:
//   * one block of four warps per (sequence, KV head, split) holds the
//     KV head's R <= 16 query rows, padded to one 16-row tile;
//   * each warp takes 16 keys of every 64-key tile (a tile never straddles
//     a page, since a page is a multiple of 64; its page id comes from the
//     block table) and streams them through its own cp.async ring: raw K and
//     V rows and their scales, three stages for 1-byte pages, two for bf16,
//     rows past the walk zero-filled.  A warp waits only on its own copies,
//     so a tile costs one warp barrier and no block barrier;
//   * S = Q K^T and O += P V run on mma.sync m16n8k16 (bf16, fp32
//     accumulate).  Q sits in registers as A fragments, scaled and rounded
//     to bf16 once.  The product's depth order is free, so each thread's
//     K fragments are consecutive bytes of one key row: 1-byte K converts
//     in registers straight into B fragments.  V's B fragments pair two keys
//     at one column: each thread reads 16 consecutive columns of four key
//     rows and pairs their bytes with byte permutes, so O's columns come
//     out permuted (logical column 8n + c is column 16c + n) and are put
//     back when written.  Rows and chunks are swizzled so that no ring
//     read conflicts;
//   * S and P stay in registers (the S accumulators are P's A fragments).
//     Scores are scaled by their column's K scale, p by the V scale and then
//     rounded to bf16 before PV, as on the TPU;
//   * each warp keeps its own running max, sum and O; the four merge once,
//     at the end of the walk, through shared memory;
//   * splits follow the live walk: a block reads kv_len, counts the live
//     tiles n = ceil(min(kv_len, max_pages * page) / 64) and split i takes
//     tiles [i*c, (i+1)*c), c = ceil(n / nsplit) (ops/decode.py
//     split_bounds).  The host picks nsplit without reading kv_len, so a
//     CUDA graph can capture the call; the walk never passes the table's
//     reach, so an idle slot whose length ran past it reads only its own
//     entries;
//   * the merge is in the kernel: each split writes an fp32 (out, lse)
//     partial and raises a per-(sequence, KV head) arrival counter with an
//     acquire-release atomic;
//     the block that arrives last merges the partials in split order with
//     K1m's row merge (fatt::merge_row), writes bf16 out and fp32 lse, and
//     resets the counter for the next call.  One split writes out directly.
// Clamped mode drops the running max (p = 2^min(s, clamp2), base-2 scores
// with log2(e) folded into the q pre-scale); online mode keeps natural
// units.  A row with no visible key writes out 0 and lse -1e30.
//
// The sliding window and the logit softcap (Mistral, Gemma-2) are built
// into instances of their own (kLocal, entry fatt_paged_decode_local), so
// the instances without them keep their code
// (flash_attn_tpu/ops/paged_decode.py:150-160, 224-226, 362-374):
//   * the query sees positions [kv_len - window, kv_len); the walk starts at
//     the tile that holds kv_len - window, floor(max(0, kv_len - window) /
//     64) * 64, and the splits cut that walk, so no page below the window is
//     read.  A split the window leaves empty still writes its partial (out
//     0, lse -1e30) and arrives, so the arrival counter counts every split;
//   * a warp's 16 keys are masked where the window's edge or kv_len crosses
//     them;
//   * the softcap, s = c * tanh(s / c) on the scores after the K scale and
//     before the mask, c in the scores' units (base 2 when clamped), on
//     fatt::tanh_exp2 as K4's.
//
// Head dim 64 (GPT-2) or 128, a template parameter.  At 64 a thread's K
// fragments are one 16-byte chunk of its key row (1-byte pages) and V's
// pairing reads 8 columns of four key rows, so logical column 8n + c is
// column 8c + n (kD / 8 c + n in general); 64 of the 128 threads merge
// the four warps' columns.
#include <type_traits>

#include "common.cuh"

namespace {

using fatt::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;            // keys per tile
constexpr int kWK = kBK / kWarps;  // keys of a tile per warp
constexpr int kRows = 16;          // query rows a block (R <= 16, padded)

// Per warp: kStages stages of its 16 K rows, 16 V rows (in 16-byte chunks,
// swizzled by chunk_pos) and, for 1-byte pages, their 16 + 16 scales.  The
// warps' O, max and sum reuse the rings at the end.  49.5 KB (1-byte) or
// 64 KB (bf16) a block at head dim kD = 128.
template <int KV, int kD>
struct Ring {
  static constexpr int kOLd = kD + 8;  // fp32 stride of a warp's O rows in the merge
  static constexpr bool kRaw = KV != fatt::kBf16;
  static constexpr int kStages = kRaw ? 3 : 2;
  static constexpr int kChunks = kD * (kRaw ? 1 : 2) / 16;  // 16-byte chunks a row
  static constexpr int kRowBytes = kChunks * 16;
  static constexpr int kSliceBytes = kWK * kRowBytes;  // a warp's K (or V) rows
  static constexpr int kStageBytes = 2 * kSliceBytes + (kRaw ? 2 * kWK * 4 : 0);
  static constexpr int kWarpBytes = kStages * kStageBytes;
  static constexpr int kMergeBytes = kWarps * kRows * (kOLd + 2) * 4;
  static constexpr int kBytes =
      kWarps * kWarpBytes > kMergeBytes ? kWarps * kWarpBytes : kMergeBytes;
};

struct Params {
  const __nv_bfloat16* q;  // [B, Hk * R, D]
  const unsigned char* k;  // [P, Hk, page, D]
  const unsigned char* v;
  const float* k_scale;  // [P, Hk, page] (null for bf16)
  const float* v_scale;
  const int* table;   // [B, max_pages]
  const int* kv_len;  // [B]
  __nv_bfloat16* out;  // [B, Hk * R, D]
  float* lse;          // [B, Hk * R]
  float* part_out;     // [nsplit, B, Hk * R, D] (nsplit > 1)
  float* part_lse;     // [nsplit, B, Hk * R]
  int* arrivals;       // [B * Hk], 0 between calls
  int B, Hk, R, page, max_pages;
  float qscale, clamp2;
  int clamped;
};

// The kLocal instances' parameters.  The other instances keep Params as it
// was: with the two fields added to it (136 bytes of kernel parameters
// instead of 128) they ran 5-11 % slower, 0.0216-0.0220 ms against
// 0.0200-0.0201 at phase 2's bf16 point (chip_tools/k8_probe.py turns
// against the parent's source and a copy of it with the fields added;
// NVIDIA H100 80GB HBM3, 700 W).
struct LocalParams : Params {
  int window;     // 0 or the positions below kv_len the query sees
  float softcap;  // 0 or the cap in the scores' units
};

template <bool kLocal>
using ParamsOf = std::conditional_t<kLocal, LocalParams, Params>;

// Stored position of 16-byte chunk c of ring row r: the K reads (a quarter
// warp takes two consecutive rows at four chunks) and the V reads (four
// rows of one parity at two chunks) both hit eight distinct bank groups
// (at kD = 64 1-byte rows are 64 bytes, and the V reads are two-way).
template <int KV, int kD>
__device__ __forceinline__ int chunk_pos(int r, int c) {
  if constexpr (KV != fatt::kBf16) {
    return kD == 128 ? c ^ (r & 7) : c ^ ((r >> 1) & 3);
  } else {
    return c ^ (((r >> 1) & 1) | ((((r >> 2) ^ r) & 1) << 2));
  }
}

// The first of the four head-dim columns that depth step kk of this
// thread's fragments holds (a0/b0: +0, +1; a2/b1: +2, +3): the thread's K
// fragments are then consecutive bytes of its key row.
template <int KV, int kD>
__device__ __forceinline__ int kdim(int q4, int kk) {
  if constexpr (KV != fatt::kBf16) {
    return kD / 4 * q4 + 4 * kk;  // chunks kD/64 q4 .. of a kD-byte row
  } else {
    return 32 * (kk >> 1) + 8 * q4 + 4 * (kk & 1);  // chunks q4, q4 + 4, ...
  }
}

// Stored byte kA of a and byte kB of b as a bf16 pair (a's in the lower
// half), exact.  e4m3 pairs convert to f16 in one instruction, then through
// fp32; int8 bytes avoid the integer conversion instructions (a quarter of
// the fp32 rate): 2^23 + (b ^ 0x80) as fp32 bits, less 2^23 + 128, is b,
// and its upper 16 bits are its bf16 (8 significant bits at most).
template <int KV, int kA, int kB>
__device__ __forceinline__ uint32_t pair_bf16(uint32_t a, uint32_t b) {
  if constexpr (KV == fatt::kFp8) {
    const uint32_t x = __byte_perm(a, b, kA | ((4 + kB) << 4));
    const __half2 h(__nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(x & 0xffffu),
                                               __NV_E4M3));
    const float2 f = __half22float2(h);
    return fatt::pack_bf16(f.x, f.y);
  } else {
    const float lo =
        __int_as_float(__byte_perm(a ^ 0x80808080u, 0x4B000000u, 0x7540 + kA)) - 8388736.f;
    const float hi =
        __int_as_float(__byte_perm(b ^ 0x80808080u, 0x4B000000u, 0x7540 + kB)) - 8388736.f;
    return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
  }
}

// d (16 x 8 fp32) += a (16 x 16 bf16) * b (16 x 8 bf16).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KV, int kD, bool kLocal>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const ParamsOf<kLocal> p) {
  using L = Ring<KV, kD>;
  constexpr int kOLd = L::kOLd;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int bh = blockIdx.x, b = bh / p.Hk, hk = bh % p.Hk;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int R = p.R;
  const unsigned char* ring = smem + warp * L::kWarpBytes;
  const uint32_t ring_s = fatt::smem_u32(ring);

  // The sequence's page ids, 32 at a time, entry j in lane j % 32: the
  // first 32 load beside kv_len, and the walk reads the table only past
  // them.
  const int* trow = p.table + (int64_t)b * p.max_pages;
  int pids = lane < p.max_pages ? trow[lane] : 0, pids_from = 0;

  // The split's tiles of the live walk, never past the table's reach.
  const int walk_end = max(0, min(p.kv_len[b], p.max_pages * p.page));
  // kLocal with a window: the walk starts t_begin tiles in, at the tile that
  // holds kv_len - window, and the keys below walk_lo are masked
  int walk_lo = 0, t_begin = 0;
  if constexpr (kLocal) {
    if (p.window > 0) {
      walk_lo = p.kv_len[b] - p.window;
      t_begin = min(max(0, walk_lo), walk_end) / kBK;
    }
  }
  const int n_live = (walk_end + kBK - 1) / kBK - t_begin;
  const int per = (n_live + nsplit - 1) / nsplit;
  const int t_lo = split * per;
  const int n_tiles = max(0, min(per, n_live - t_lo));

  auto page_of = [&](int i) {  // i: a tile of the split, in increasing order
    const int j = (t_begin + t_lo + i) * kBK / p.page;
    if (j - pids_from >= 32) {
      pids_from = j & ~31;
      pids = pids_from + lane < p.max_pages ? trow[pids_from + lane] : 0;
    }
    return __shfl_sync(0xffffffffu, pids, j & 31);
  };

  // This warp's 16 keys of tile i into its ring stage i % kStages.
  auto load_tile = [&](int i) {
    const uint32_t st = ring_s + (i % L::kStages) * L::kStageBytes;
    const int k0 = (t_begin + t_lo + i) * kBK;
    const int pid = page_of(i);
    const int key0 = k0 + warp * kWK;
    const int64_t row0 = ((int64_t)pid * p.Hk + hk) * p.page + key0 % p.page;
    const int nvalid = walk_end - key0;  // rows from here are zero-filled
#pragma unroll
    for (int u = 0; u < kWK * L::kChunks / 32; ++u) {
      const int e = lane + 32 * u, r = e / L::kChunks, c = e % L::kChunks;
      const bool in = r < nvalid;
      const int64_t off = (row0 + (in ? r : 0)) * L::kRowBytes + c * 16;
      const uint32_t dst = st + r * L::kRowBytes + chunk_pos<KV, kD>(r, c) * 16;
      fatt::cp_async16(dst, p.k + off, in ? 16 : 0);
      fatt::cp_async16(dst + L::kSliceBytes, p.v + off, in ? 16 : 0);
    }
    if constexpr (L::kRaw) {
      const int r = lane % kWK;
      const bool in = r < nvalid;
      const float* src = (lane < kWK ? p.k_scale : p.v_scale) + row0 + (in ? r : 0);
      fatt::cp_async4(st + 2 * L::kSliceBytes + lane * 4, src, in ? 4 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    fatt::cp_async_commit();
  }

  // Q as A fragments: rows g and g + 8 (zero past R), depth step kk at
  // columns kdim(q4, kk) + {0, 1} (a0, a1) and + {2, 3} (a2, a3).
  const int64_t qrow0 = (int64_t)bh * R;
  uint32_t qf[kD / 16][4];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = g + 8 * hf;
    const bool in = r < R;
    const __nv_bfloat16* src = p.q + (qrow0 + (in ? r : 0)) * kD;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        float2 x = make_float2(0.f, 0.f);
        if (in)
          x = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(src + kdim<KV, kD>(q4, kk) + 2 * h2));
        qf[kk][hf + 2 * h2] = fatt::pack_bf16(x.x * p.qscale, x.y * p.qscale);
      }
    }
  }

  // o[n]: this thread's rows g, g + 8 at logical columns 8n + 2 q4 + {0, 1}.
  float o[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    fatt::cp_async_wait<L::kStages - 2>();
    // The warp's slice of tile t has landed for every lane, and every lane
    // is done with the stage the next copy refills.
    __syncwarp();
    if (t + L::kStages - 1 < n_tiles) load_tile(t + L::kStages - 1);
    fatt::cp_async_commit();
    const unsigned char* st = ring + (t % L::kStages) * L::kStageBytes;
    const unsigned char* vt = st + L::kSliceBytes;
    auto chunk = [&](const unsigned char* tile, int r, int c) {
      return *reinterpret_cast<const uint4*>(tile + r * L::kRowBytes +
                                             chunk_pos<KV, kD>(r, c) * 16);
    };

    // S = Q K^T: s[j] holds keys 8j + 2 q4 + {0, 1} of the warp's 16.
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const int r = 8 * j + g;  // the key whose B fragment this thread holds
      if constexpr (L::kRaw) {
        uint4 x[kD / 64];
#pragma unroll
        for (int i = 0; i < kD / 64; ++i) x[i] = chunk(st, r, kD / 64 * q4 + i);
        const uint32_t* w = reinterpret_cast<const uint32_t*>(x);
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk)
          mma16816(s[j], qf[kk], pair_bf16<KV, 0, 1>(w[kk], w[kk]),
                   pair_bf16<KV, 2, 3>(w[kk], w[kk]));
      } else {
#pragma unroll
        for (int i = 0; i < kD / 32; ++i) {
          const uint4 x = chunk(st, r, 4 * i + q4);
          mma16816(s[j], qf[2 * i], x.x, x.y);
          mma16816(s[j], qf[2 * i + 1], x.z, x.w);
        }
      }
    }
    const int key0 = (t_begin + t_lo + t) * kBK + warp * kWK;
    const float* ksc = reinterpret_cast<const float*>(vt + L::kSliceBytes);
    const float* vsc = ksc + kWK;
    if constexpr (L::kRaw) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float2 sc = *reinterpret_cast<const float2*>(ksc + 8 * j + 2 * q4);
        s[j][0] *= sc.x;
        s[j][1] *= sc.y;
        s[j][2] *= sc.x;
        s[j][3] *= sc.y;
      }
    }
    if constexpr (kLocal) {
      if (p.softcap > 0.f) {
        const float inv_cap = 1.f / p.softcap;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = p.softcap * fatt::tanh_exp2(s[j][e] * inv_cap);
      }
      if (key0 + kWK > walk_end || key0 < walk_lo) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * j + 2 * q4 + (e & 1);
            if (key >= walk_end || key < walk_lo) s[j][e] = kNegInf;
          }
      }
    } else if (key0 + kWK > walk_end) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * j + 2 * q4 + (e & 1) >= walk_end) s[j][e] = kNegInf;
    }

    float alpha[2] = {1.f, 1.f};
    if (!p.clamped) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float mx = fmaxf(fmaxf(s[0][2 * hf], s[0][2 * hf + 1]),
                               fmaxf(s[1][2 * hf], s[1][2 * hf + 1]));
        const float m_new = fmaxf(m_run[hf], fatt::quad_max(mx));
        alpha[hf] = expf(m_run[hf] - m_new);
        m_run[hf] = m_new;
      }
    }
    // P (p * v_scale rounded to bf16) as the A fragments of PV.
    uint32_t pf[4];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float2 vsj = make_float2(1.f, 1.f);
      if constexpr (L::kRaw) vsj = *reinterpret_cast<const float2*>(vsc + 8 * j + 2 * q4);
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = p.clamped ? exp2f(fminf(s[j][e], p.clamp2)) : expf(s[j][e] - m_run[e >> 1]);
        psum[e >> 1] += x;
        pv[e] = L::kRaw ? x * ((e & 1) ? vsj.y : vsj.x) : x;
      }
      pf[2 * j] = fatt::pack_bf16(pv[0], pv[1]);
      pf[2 * j + 1] = fatt::pack_bf16(pv[2], pv[3]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l_run[hf] = l_run[hf] * alpha[hf] + psum[hf];
    if (!p.clamped) {
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }

    // O += P V: B fragment n pairs keys (2 q4, 2 q4 + 1) and (2 q4 + 8,
    // 2 q4 + 9) at column kD / 8 g + n.
    if constexpr (L::kRaw) {
      // this thread's kD / 8 bytes of V row r: columns kD / 8 g ..
      constexpr int kVW = kD / 32;
      auto vrow = [&](int r, uint32_t (&w)[kVW]) {
        if constexpr (kD == 128) {
          const uint4 x = chunk(vt, r, g);
          w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
        } else {
          const uint2 x = *reinterpret_cast<const uint2*>(
              vt + r * L::kRowBytes + chunk_pos<KV, kD>(r, g >> 1) * 16 + (g & 1) * 8);
          w[0] = x.x, w[1] = x.y;
        }
      };
      uint32_t a[kVW], bb[kVW], c[kVW], d[kVW];
      vrow(2 * q4, a);
      vrow(2 * q4 + 1, bb);
      vrow(2 * q4 + 8, c);
      vrow(2 * q4 + 9, d);
#pragma unroll
      for (int w = 0; w < kVW; ++w) {
        mma16816(o[4 * w], pf, pair_bf16<KV, 0, 0>(a[w], bb[w]), pair_bf16<KV, 0, 0>(c[w], d[w]));
        mma16816(o[4 * w + 1], pf, pair_bf16<KV, 1, 1>(a[w], bb[w]),
                 pair_bf16<KV, 1, 1>(c[w], d[w]));
        mma16816(o[4 * w + 2], pf, pair_bf16<KV, 2, 2>(a[w], bb[w]),
                 pair_bf16<KV, 2, 2>(c[w], d[w]));
        mma16816(o[4 * w + 3], pf, pair_bf16<KV, 3, 3>(a[w], bb[w]),
                 pair_bf16<KV, 3, 3>(c[w], d[w]));
      }
    } else {
#pragma unroll
      for (int h = 0; h < kD / 64; ++h) {
        const int cv = kD / 64 * g + h;
        const uint4 va = chunk(vt, 2 * q4, cv), vb = chunk(vt, 2 * q4 + 1, cv);
        const uint4 vc = chunk(vt, 2 * q4 + 8, cv), vd = chunk(vt, 2 * q4 + 9, cv);
        const uint32_t* a = reinterpret_cast<const uint32_t*>(&va);
        const uint32_t* bb = reinterpret_cast<const uint32_t*>(&vb);
        const uint32_t* c = reinterpret_cast<const uint32_t*>(&vc);
        const uint32_t* d = reinterpret_cast<const uint32_t*>(&vd);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int n = 8 * h + 2 * w;
          mma16816(o[n], pf, __byte_perm(a[w], bb[w], 0x5410), __byte_perm(c[w], d[w], 0x5410));
          mma16816(o[n + 1], pf, __byte_perm(a[w], bb[w], 0x7632), __byte_perm(c[w], d[w], 0x7632));
        }
      }
    }
  }
  fatt::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: the merge reuses it

  // The four warps' states into shared memory, O in logical column order.
  float* Os = reinterpret_cast<float*>(smem);  // [kWarps][kRows][kOLd]
  float* Ms = Os + kWarps * kRows * kOLd;      // [kWarps][kRows]
  float* Ls = Ms + kWarps * kRows;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = warp * kRows + g + 8 * hf;
    const float l = fatt::quad_sum(l_run[hf]);
    if (q4 == 0) {
      Ms[r] = m_run[hf];
      Ls[r] = l;
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<float2*>(Os + r * kOLd + 8 * n + 2 * q4) =
          make_float2(o[n][2 * hf], o[n][2 * hf + 1]);
  }
  __syncthreads();

  // Thread tid < kD merges logical column tid (head-dim column kD / 8
  // (tid % 8) + tid / 8) of every row; a row is valid iff some unmasked
  // score was seen.
  const int64_t rows = (int64_t)p.B * p.Hk * R;
  const int col = kD / 8 * (tid % 8) + tid / 8;
  for (int r = 0; r < R && tid < kD; ++r) {
    float m = kNegInf;
    if (!p.clamped) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, Ms[w * kRows + r]);
    }
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = p.clamped ? 1.f : expf(Ms[w * kRows + r] - m);
      l += a * Ls[w * kRows + r];
      acc += a * Os[(w * kRows + r) * kOLd + tid];
    }
    const bool valid = l > 0.f && (p.clamped || m > kNegInf / 2);
    const float x = valid ? acc / l : 0.f;
    const float lse = valid ? (p.clamped ? logf(l) : m + logf(l)) : kNegInf;
    const int64_t h = qrow0 + r;
    if (nsplit == 1) {
      p.out[h * kD + col] = __float2bfloat16(x);
      if (tid == 0) p.lse[h] = lse;
    } else {
      p.part_out[(split * rows + h) * kD + col] = x;
      if (tid == 0) p.part_lse[split * rows + h] = lse;
    }
  }
  if (nsplit == 1) return;

  // The last split of this (sequence, KV head) to arrive merges them all.
  // The barrier orders every thread's partial before thread 0's arrival, an
  // acquire-release atomic (release: the partials are visible before the
  // count; acquire: in the last block, every split's partial is visible
  // after it, and to the other threads after the barrier).
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(prev)
                 : "l"(p.arrivals + bh)
                 : "memory");
    last = prev == nsplit - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int r = warp; r < R; r += kWarps)
    fatt::merge_row(p.part_out, p.part_lse, p.out, p.lse, nsplit, rows, qrow0 + r, kD, lane);
  if (tid == 0) p.arrivals[bh] = 0;
}

template <int KV, int kD, bool kLocal>
int launch_d(const ParamsOf<kLocal>& p, int nsplit, cudaStream_t st) {
  auto kernel = paged_decode_kernel<KV, kD, kLocal>;
  static fatt::SmemLimitSet smem_set;  // one for each instance
  constexpr int kBytes = Ring<KV, kD>::kBytes;
  cudaError_t e = fatt::smem_limit_once(kernel, kBytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(p.B * p.Hk, nsplit);
  kernel<<<grid, kThreads, kBytes, st>>>(p);
  return (int)cudaGetLastError();
}

template <int KV, bool kLocal>
int launch(const ParamsOf<kLocal>& p, int D, int nsplit, cudaStream_t st) {
  return D == 64 ? launch_d<KV, 64, kLocal>(p, nsplit, st)
                 : launch_d<KV, 128, kLocal>(p, nsplit, st);
}

template <bool kLocal>
int paged_decode(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                 const void* table, const void* kv_len, void* out, void* lse, void* part_out,
                 void* part_lse, void* arrivals, int B, int Hk, int R, int page, int max_pages,
                 int D, int kv_type, int num_splits, float qscale, int clamped, float clamp2,
                 int window, float softcap, void* stream) {
  if ((D != 64 && D != 128) || R < 1 || R > kRows || page < kBK || page % kBK != 0 || max_pages < 1 ||
      B < 1 || Hk < 1 || (int64_t)B * Hk > 0x7fffffff || num_splits < 1 ||
      num_splits > 65535 ||
      (num_splits > 1 && (part_out == nullptr || part_lse == nullptr || arrivals == nullptr)) ||
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
           static_cast<float*>(lse),
           static_cast<float*>(part_out),
           static_cast<float*>(part_lse),
           static_cast<int*>(arrivals),
           B, Hk, R, page, max_pages, qscale, clamp2, clamped};
  ParamsOf<kLocal> pk;
  static_cast<Params&>(pk) = p;
  if constexpr (kLocal) {
    pk.window = window;
    pk.softcap = softcap;
  }
  auto st = static_cast<cudaStream_t>(stream);
  switch (kv_type) {
    case fatt::kBf16:
      return launch<fatt::kBf16, kLocal>(pk, D, num_splits, st);
    case fatt::kInt8:
      return launch<fatt::kInt8, kLocal>(pk, D, num_splits, st);
    case fatt::kFp8:
      return launch<fatt::kFp8, kLocal>(pk, D, num_splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: [B, Hk * R, D] bf16 (D 64 or 128), R = H / Hk <= 16 rows per KV head; pages
// [P, Hk, page, D], page a multiple of 64; scales [P, Hk, page] fp32 (null
// for bf16 pages); block_table [B, max_pages] int32; kv_len [B] int32.
// Writes out [B, Hk * R, D] bf16 and lse [B, Hk * R] fp32.  With
// num_splits > 1 the splits also write their fp32 partials part_out
// [n, B, Hk * R, D] and part_lse [n, B, Hk * R], merged in the kernel;
// arrivals [B * Hk] int32 must be 0 and is 0 again after the launch.
extern "C" int fatt_paged_decode(const void* q, const void* k, const void* v,
                                 const void* ks, const void* vs, const void* table,
                                 const void* kv_len, void* out, void* lse, void* part_out,
                                 void* part_lse, void* arrivals, int B, int Hk, int R,
                                 int page, int max_pages, int D, int kv_type, int num_splits,
                                 float qscale, int clamped, float clamp2, void* stream) {
  return paged_decode<false>(q, k, v, ks, vs, table, kv_len, out, lse, part_out, part_lse,
                             arrivals, B, Hk, R, page, max_pages, D, kv_type, num_splits,
                             qscale, clamped, clamp2, 0, 0.f, stream);
}

// fatt_paged_decode's arguments and, before the stream, window (0 or the
// positions below kv_len the query sees) and softcap (0 or the cap in the
// scores' units, base 2 when clamped): the kLocal instances.
extern "C" int fatt_paged_decode_local(const void* q, const void* k, const void* v,
                                       const void* ks, const void* vs, const void* table,
                                       const void* kv_len, void* out, void* lse,
                                       void* part_out, void* part_lse, void* arrivals, int B,
                                       int Hk, int R, int page, int max_pages, int D,
                                       int kv_type, int num_splits, float qscale, int clamped,
                                       float clamp2, int window, float softcap, void* stream) {
  return paged_decode<true>(q, k, v, ks, vs, table, kv_len, out, lse, part_out, part_lse,
                            arrivals, B, Hk, R, page, max_pages, D, kv_type, num_splits,
                            qscale, clamped, clamp2, window, softcap, stream);
}

// K1: decode attention over a contiguous KV cache (bf16, int8 or fp8-e4m3
// with per-(position, head) fp32 scales): one query token per sequence and
// at most 8 query heads per KV head, head_dim up to 256, over a BHSD or a
// BSHD cache, with an optional sliding window and logit softcap (Gemma-2).
// Chunk mode (T query tokens per sequence) and decode calls with more heads
// per KV head run on the chunk kernel, K1c (csrc/chunk_attn.cu).
//
// Replaces flash_attn_tpu/ops/decode.py:_decode_kernel_bhsd in decode mode
// (B1) and _decode_kernel (the BSHD-layout decode, B12).  One kernel
// template serves both layouts: a K/V row (D elements) of position t of KV
// head hk in sequence b is row (b*Hk + hk)*S + t for BHSD and
// (b*S + t)*Hk + hk for BSHD; scales sit at the same row index ([B, Hk, S]
// or [B, S, Hk] fp32).  The layout is a template parameter, so the decode
// step's instance carries no strides: as runtime values they made it 1.3x
// slower.
//
// Bound on the H100: bytes.  Each step reads every live K/V row once
// (B*Hk*kv_len*D*2 elements) and does 4 flops per element and query row;
// at 1-2 bytes per element and at most 8 rows per block that is far below
// the 295 flop/byte ridge.  The design therefore only has to read each
// byte once per block and keep enough loads in flight:
//   * one block serves the up to 8 query rows of one KV head (its GQA
//     group), so each K/V tile is read from device memory once per KV
//     head, not once per row;
//   * 64-row K and V tiles and their scales stream through a ring of three
//     stages (two for bf16) in shared memory, filled by cp.async (16 bytes
//     a copy, rows past the walk zero-filled), so later tiles are in flight
//     while the scores and PV of the current one run; stored values are converted to fp32
//     in registers as they are read from the ring: scores by two threads
//     per key, PV by one thread per head-dim column;
//   * every row sees kv_len positions, never past S; tiles at or beyond it
//     are never read.  With a window (decode.py:858-862, 931-940) it sees
//     the last `window` of them, [max(0, kv_len - window), kv_len): the
//     walk starts there, so the keys below the window are never read
//     either;
//   * a split-KV grid axis (blockIdx.y) cuts the sequence so that B*Hk
//     blocks (64 at batch 8) become enough to fill 132 SMs; each split
//     writes an fp32 (out, lse) partial that the wrapper merges with the
//     LSE rule in one launch of K1m (csrc/lse_merge.cu); since a merge is
//     one launch, the wrapper aims at six blocks an SM (ops/decode.py).
//     Splits are fixed runs of split_len positions, or (split_len 0, the
//     windowed calls) each sequence's live walk cut in gridDim.y runs of
//     whole tiles, so the count stays fixed by the shapes (one captured
//     grid for every length) and no split walks dead positions.
// Shard views (kView, entry fatt_decode_view): the sequence-sharded
// decode runs K1 on each rank's run of S positions of the engine's one
// [B, Hk, capacity, D] cache buffer, read in place: kv_cap is the position
// stride between consecutive (b, hk) rows (BHSD) or sequences (BSHD) of
// K and V, sc_cap the scales'.  Its calls always write fp32 partials, a
// single split too, since the caller merges every shard's splits in one
// K1m launch.  The view instances are separate, so the contiguous calls'
// instances keep their code.
// Head dim 256 (Gemma-2-9B) is a second instance of every KV type and
// layout: the ring rows and q widen to 256 and each thread takes two
// head-dim columns in PV; the ring keeps two stages at that width (71 KB
// for 1-byte tiles: two blocks an SM).  The softcap, s = c * tanh(s / c)
// in the scores' units after the K scale (decode.py:835-838), uses the
// accurate tanhf.
// Dequantization is fused: scores are scaled by the K scale of their
// position and p by the V scale before the PV product, as on the TPU.  The
// softmax scale rides on q (qscale, rounded to bf16 as B1 folds it) or on
// the scores (sscale, as B12 applies it); the wrapper sets one to 1.
#include "common.cuh"

namespace {

using fatt::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr int kMaxRows = 8;  // query rows per block

// Ring layout of one KV type at head dims up to kMaxD: per stage a K tile,
// a V tile (rows padded so that the two threads of a key and the keys of a
// quarter warp hit distinct banks), then the K and V scales of the tile's
// positions.  At kMaxD 128 three stages of 1-byte tiles (63 KB a block with
// q and the scores, three blocks an SM), two of bf16 tiles (81 KB, two
// blocks an SM); at 256 two stages of either.
template <int KV, int kMaxD>
struct Ring {
  static constexpr int kStages = KV == fatt::kBf16 || kMaxD > 128 ? 2 : 3;
  static constexpr int kElem = KV == fatt::kBf16 ? 2 : 1;
  static constexpr int kRowBytes = kMaxD * kElem + (KV == fatt::kBf16 ? 32 : 16);
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes + 2 * kTile * 4;
  static constexpr int kBytes = kStages * kStageBytes;
};

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

// kBshd: the BSHD layout (else BHSD); kMaxD: the widest head dim served;
// kView: K/V and scales are runs of buffers of kv_cap / sc_cap positions,
// and every split writes its partial.  window: 0, or the positions below
// kv_len a row sees; softcap: the cap in the scores' units, 0 for none;
// split_len 0: splits cut the live walk.
template <int KV, bool kBshd, int kMaxD, bool kView>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
    const void* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ kv_len,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part_out,
    float* __restrict__ part_lse, int B, int Hk, int R, int S, int D,
    int split_len, float qscale, float sscale, int clamped, float clamp2, int window,
    float softcap, int kv_cap, int sc_cap) {
  using L = Ring<KV, kMaxD>;
  constexpr int kCols = kMaxD / kThreads;  // head-dim columns a thread in PV
  constexpr int kElem = L::kElem;
  constexpr int kRowBytes = L::kRowBytes;
  const int b = blockIdx.x / Hk;
  const int hk = blockIdx.x % Hk;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t qrow0 = ((int64_t)b * Hk + hk) * R;  // this block's row 0

  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ float q_s[kMaxRows][kMaxD];
  __shared__ float s_s[kMaxRows][kTile];
  __shared__ float m_s[kMaxRows], l_s[kMaxRows], a_s[kMaxRows];

  // q pre-scaled in bf16, as the TPU kernel folds the softmax scale into
  // its bf16 q block (qscale is already rounded to bf16 by the wrapper;
  // it is 1 when the scale rides on the scores).
  for (int i = tid; i < R * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float x = __bfloat162float(q[(qrow0 + g) * D + d]);
    q_s[g][d] = fatt::bf16_round(x * qscale);
  }
  if (tid < kMaxRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    a_s[tid] = 1.f;
  }
  float acc[kCols][kMaxRows];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
#pragma unroll
    for (int g = 0; g < kMaxRows; ++g) acc[c][g] = 0.f;

  // Every row sees positions < kv_len, never past S (an idle slot's length
  // runs past the capacity), and with a window none below kv_len - window.
  const int len = kv_len[b];
  const int walk_end = min(len, S);
  const int walk_lo = window > 0 ? max(0, len - window) : 0;
  int lo, hi;
  if (split_len > 0) {
    lo = max(split * split_len, walk_lo);
    hi = min(split * split_len + split_len, walk_end);
  } else {  // the live walk in nsplit runs of whole tiles
    const int n = walk_end > walk_lo ? (walk_end - walk_lo + kTile - 1) / kTile : 0;
    const int per = (n + nsplit - 1) / nsplit * kTile;
    lo = walk_lo + split * per;
    hi = min(lo + per, walk_end);
  }
  // row index of position t: row0 + t * t_stride (srow0 for the scales)
  const int cap = kView ? kv_cap : S;
  const int64_t row0 = kBshd ? (int64_t)b * cap * Hk + hk : ((int64_t)b * Hk + hk) * cap;
  const int64_t srow0 =
      kView ? (kBshd ? (int64_t)b * sc_cap * Hk + hk : ((int64_t)b * Hk + hk) * sc_cap) : row0;
  const int t_stride = kBshd ? Hk : 1;
  const int row_bytes = D * kElem;
  const int chunks = row_bytes / 16;  // 16-byte chunks per row
  const unsigned char* kb = static_cast<const unsigned char*>(k);
  const unsigned char* vb = static_cast<const unsigned char*>(v);

  const int n_tiles = hi > lo ? (hi - lo + kTile - 1) / kTile : 0;

  // Tile i of this split into ring stage i % kStages (rows past the walk
  // zero-filled; their scores are masked and their p is 0).
  auto load_tile = [&](int i) {
    unsigned char* st = ring + (i % L::kStages) * L::kStageBytes;
    const int t0 = lo + i * kTile;
    const int nvalid = min(kTile, hi - t0);
    for (int e = tid; e < kTile * chunks; e += kThreads) {
      const int r = e / chunks, c = e % chunks;
      const bool in = r < nvalid;
      const int64_t off = (row0 + (int64_t)(in ? t0 + r : lo) * t_stride) * row_bytes + c * 16;
      fatt::cp_async16(fatt::smem_u32(st + r * kRowBytes + c * 16), kb + off, in ? 16 : 0);
      fatt::cp_async16(fatt::smem_u32(st + L::kTileBytes + r * kRowBytes + c * 16), vb + off,
                       in ? 16 : 0);
    }
    if constexpr (KV != fatt::kBf16) {
      const int r = tid % kTile;
      const bool in = r < nvalid;
      const int64_t row = srow0 + (int64_t)(in ? t0 + r : lo) * t_stride;
      const float* src = tid < kTile ? ks + row : vs + row;
      fatt::cp_async4(fatt::smem_u32(st + 2 * L::kTileBytes + (tid / kTile) * kTile * 4 + r * 4),
                      src, in ? 4 : 0);
    }
  };
#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    fatt::cp_async_commit();
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = lo + it * kTile;
    const int nvalid = min(kTile, hi - t0);
    fatt::cp_async_wait<L::kStages - 2>();
    __syncthreads();  // tile it has landed; tile it-1 is consumed; q_s/stats are set
    if (it + L::kStages - 1 < n_tiles) load_tile(it + L::kStages - 1);
    fatt::cp_async_commit();
    const unsigned char* k_s = ring + (it % L::kStages) * L::kStageBytes;
    const unsigned char* v_s = k_s + L::kTileBytes;
    const float* ks_s = reinterpret_cast<const float*>(k_s + 2 * L::kTileBytes);
    const float* vs_s = ks_s + kTile;

    // Phase 1: s[g][j] = (q_g . k_j) * k_scale_j * sscale, masked past the
    // row's limit; two threads per key j, each taking alternate 8-element
    // chunks of the head dim.
    {
      const int j = tid >> 1, h = tid & 1;
      float dots[kMaxRows];
#pragma unroll
      for (int g = 0; g < kMaxRows; ++g) dots[g] = 0.f;
      for (int cc = h; cc < D / 8; cc += 2) {
        float kf[8];
        load8<KV>(k_s + j * kRowBytes + cc * 8 * kElem, kf);
#pragma unroll
        for (int g = 0; g < kMaxRows; ++g) {
          if (g < R) {
#pragma unroll
            for (int e = 0; e < 8; ++e) dots[g] += q_s[g][cc * 8 + e] * kf[e];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxRows; ++g)
        dots[g] += __shfl_xor_sync(0xffffffffu, dots[g], 1);
      if (h == 0) {
#pragma unroll
        for (int g = 0; g < kMaxRows; ++g)
          if (g < R) {
            const bool keep = j < nvalid;
            float s = KV != fatt::kBf16 ? dots[g] * ks_s[j] : dots[g];
            if constexpr (kBshd) s *= sscale;
            if (softcap > 0.f) s = softcap * tanhf(s / softcap);
            s_s[g][j] = keep ? s : kNegInf;
          }
      }
    }
    __syncthreads();

    // Phase 2: softmax statistics, one warp per query row; p * v_scale is
    // rounded to bf16 as the TPU kernel feeds it to the PV product.
    for (int g = warp; g < R; g += kWarps) {
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

    // Phase 3: acc[c][g] (column d = tid + 128c) = acc * alpha +
    // sum_j p[g][j] v[j][d].
    if (tid < D) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
#pragma unroll
        for (int g = 0; g < kMaxRows; ++g)
          if (g < R) acc[c][g] *= a_s[g];
      for (int j = 0; j < nvalid; ++j) {
        float vv[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          vv[c] = tid + c * kThreads < D
                      ? fatt::load_kv<KV>(v_s + j * kRowBytes, tid + c * kThreads)
                      : 0.f;
#pragma unroll
        for (int g = 0; g < kMaxRows; ++g)
          if (g < R) {
            const float pg = s_s[g][j];
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[c][g] += pg * vv[c];
          }
      }
    }
  }
  fatt::cp_async_wait<0>();
  __syncthreads();

  // Finalize: a row is valid iff some unmasked score was seen.
  const int64_t rows = (int64_t)B * Hk * R;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int d = tid + c * kThreads;
    if (d >= D) continue;
#pragma unroll
    for (int g = 0; g < kMaxRows; ++g) {
      if (g >= R) continue;
      const float l = l_s[g];
      const bool valid = l > 0.f && (clamped || m_s[g] > kNegInf / 2);
      const float o = valid ? acc[c][g] / l : 0.f;
      const int64_t h = qrow0 + g;
      if (!kView && nsplit == 1) {
        out[h * D + d] = __float2bfloat16(o);
      } else {
        part_out[(split * rows + h) * D + d] = o;
      }
    }
  }
  if (tid < R) {
    const float l = l_s[tid];
    const bool valid = l > 0.f && (clamped || m_s[tid] > kNegInf / 2);
    const float lse = valid ? (clamped ? logf(l) : m_s[tid] + logf(l)) : kNegInf;
    part_lse[split * rows + qrow0 + tid] = lse;
  }
}

template <int KV, bool kBshd, int kMaxD, bool kView>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* kv_len, void* out, void* part_out,
           void* part_lse, int B, int Hk, int R, int S, int D, int num_splits,
           int split_len, float qscale, float sscale, int clamped,
           float clamp2, int window, float softcap, int kv_cap, int sc_cap,
           cudaStream_t st) {
  auto kernel = decode_kernel<KV, kBshd, kMaxD, kView>;
  constexpr int kBytes = Ring<KV, kMaxD>::kBytes;
  static fatt::SmemLimitSet smem_set;  // one for each instance
  cudaError_t e = fatt::smem_limit_once(kernel, kBytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * Hk, num_splits);
  kernel<<<grid, kThreads, kBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(kv_len),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_out),
      static_cast<float*>(part_lse), B, Hk, R, S, D, split_len, qscale, sscale,
      clamped, clamp2, window, softcap, kv_cap, sc_cap);
  return (int)cudaGetLastError();
}

template <int KV, bool kView>
int launch_layout(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, const void* kv_len, void* out, void* part_out,
                  void* part_lse, int B, int Hk, int R, int S, int D, int bshd,
                  int num_splits, int split_len, float qscale, float sscale,
                  int clamped, float clamp2, int window, float softcap, int kv_cap,
                  int sc_cap, cudaStream_t st) {
  auto fn = D > 128 ? (bshd ? launch<KV, true, 256, kView> : launch<KV, false, 256, kView>)
                    : (bshd ? launch<KV, true, 128, kView> : launch<KV, false, 128, kView>);
  return fn(q, k, v, ks, vs, kv_len, out, part_out, part_lse, B, Hk, R, S, D,
            num_splits, split_len, qscale, sscale, clamped, clamp2, window, softcap, kv_cap,
            sc_cap, st);
}

template <bool kView>
int launch_kv(const void* q, const void* k, const void* v, const void* ks, const void* vs,
              const void* kv_len, void* out, void* part_out, void* part_lse, int B, int Hk,
              int R, int S, int D, int bshd, int kv_type, int num_splits, int split_len,
              float qscale, float sscale, int clamped, float clamp2, int window,
              float softcap, int kv_cap, int sc_cap, void* stream) {
  if (R < 1 || R > kMaxRows || D > 256 || D % 32 != 0 || num_splits < 1 ||
      split_len < 0 || split_len % kTile != 0 || window < 0 || !(softcap >= 0.f))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto fn = kv_type == fatt::kBf16   ? launch_layout<fatt::kBf16, kView>
            : kv_type == fatt::kInt8 ? launch_layout<fatt::kInt8, kView>
            : kv_type == fatt::kFp8  ? launch_layout<fatt::kFp8, kView>
                                     : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, k, v, ks, vs, kv_len, out, part_out, part_lse, B, Hk, R, S, D, bshd, num_splits,
            split_len, qscale, sscale, clamped, clamp2, window, softcap, kv_cap, sc_cap, st);
}

}  // namespace

// q: [B, Hk * R, D] bf16 rows, R = H / Hk <= 8, D <= 256; k, v: BHSD
// [B, Hk, S, D] (bshd 0) or BSHD [B, S, Hk, D] (bshd 1); scales fp32 at the
// rows' indices (null for bf16); kv_len [B] int32.  One split writes out
// [B, Hk * R, D] bf16, several write fp32 partials part_out
// [n, B, Hk * R, D]; part_lse [n, B, Hk * R] always.  split_len: positions
// a split, or 0 to cut each sequence's live walk in num_splits runs of
// whole tiles.  window: 0 or the positions below kv_len each row sees;
// softcap: 0 or the cap in the scores' units (base 2 when clamped).
extern "C" int fatt_decode(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs, const void* kv_len,
                           void* out, void* part_out, void* part_lse, int B,
                           int Hk, int R, int S, int D, int bshd, int kv_type,
                           int num_splits, int split_len, float qscale,
                           float sscale, int clamped, float clamp2, int window,
                           float softcap, void* stream) {
  return launch_kv<false>(q, k, v, ks, vs, kv_len, out, part_out, part_lse, B, Hk, R, S, D,
                          bshd, kv_type, num_splits, split_len, qscale, sscale, clamped,
                          clamp2, window, softcap, S, S, stream);
}

// fatt_decode on shard views: K, V (and scales) are runs of S positions of
// buffers whose sequence axis holds kv_cap (sc_cap) positions; every split,
// a single one too, writes its fp32 partial to part_out, and out is unused.
extern "C" int fatt_decode_view(const void* q, const void* k, const void* v,
                                const void* ks, const void* vs, const void* kv_len,
                                void* part_out, void* part_lse, int B, int Hk, int R, int S,
                                int kv_cap, int sc_cap, int D, int bshd, int kv_type,
                                int num_splits, int split_len, float qscale, float sscale,
                                int clamped, float clamp2, int window, float softcap,
                                void* stream) {
  if (kv_cap < S || sc_cap < S || part_out == nullptr) return (int)cudaErrorInvalidValue;
  return launch_kv<true>(q, k, v, ks, vs, kv_len, nullptr, part_out, part_lse, B, Hk, R, S, D,
                         bshd, kv_type, num_splits, split_len, qscale, sscale, clamped,
                         clamp2, window, softcap, kv_cap, sc_cap, stream);
}


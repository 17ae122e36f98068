// Quantized matmuls on Hopper's warpgroup products, out[M, N] = x[M, K] @
// W[K, N] with the scales folded out of the product:
//
//   K3  float x @ int8 W, scales [N]     replaces flash_attn_tpu/ops/matmul.py:
//                                        _int8_kernel
//   K3g float x @ int8 W, scales [K/g, N] the grouped `kern` in matmul_int8
//   K6  float x @ packed int4 W          _int4_kernel and _int4_plane_kernel
//       (per-(group, N) scales)
//   K5  int8 x @ packed int4 W (W4A8)    _w4a8_kernel
//   K7  int8 x @ int8 W (W8A8)           _w8a8_kernel
//
// "float x" is bf16, or fp32 (the LM head's activations): fp32 x is split
// exactly into three bf16 parts (hi + mid + lo, 8 significant bits each),
// each multiplied on the tensor cores; integer weights are exact in bf16,
// so every product is exact and the sum is an fp32 sum, as the TPU kernel's
// HIGHEST-precision f32 dot.  Output bf16 or fp32.
//
// Packed int4 is the halves layout: packed row j of group i holds value
// row i*g + j (low nibble) and i*g + g/2 + j (high nibble), n = q + 8.
//
// Bound on the H100: at decode (M = batch <= 16) bytes -- the weight
// stream (0.5 or 1 byte per element plus the scales) is everything; at a
// prompt bucket (M = 32 .. 511 for the int4 kinds, up to 2048 for the
// int8 ones) operations on the tensor cores (bf16 for K3/K3g/K6, three
// times as many for fp32 x; int8 for K5/K7).  One design for both:
//   * the product runs transposed, out^T = W^T x^T, on wgmma m64nBMk16
//     (bf16, fp32 accumulate) or m64nBMk32 (int8, exact int32): a block is
//     two warpgroups, each owning 64 of the block's 128 columns as the A
//     operand in registers, and x's BM rows (16 at decode, 64 or 128 at a
//     prompt bucket) are the B operand, read by descriptor from shared
//     memory in the 128-byte swizzle.  Each weight is decoded once per
//     block, by one thread, straight into its A fragment (ldmatrix.trans
//     gives a thread two adjacent columns of two k-rows), and never
//     touches shared memory decoded;
//   * the raw weight bytes and the tile's scale rows arrive by cp.async
//     (16-byte copies, 4-byte ones where N % 16 != 0), and x's tile by TMA
//     at the prompt sizes (by cp.async at decode and for fp32 x), in a
//     ring of 3-6 stages, tile after tile of 128 k-rows, rows past M and
//     columns past N zero-filled; so a prompt block's loads hide behind its
//     products and a decode block keeps tens of KB of weights in flight;
//   * the k order inside one product step (16 k for bf16, 32 for int8) is
//     free as long as A and B agree: for packed int4 a step takes the low
//     nibbles of 8 (16) packed rows, then their high nibbles -- value rows
//     g/2 further on -- and x's 16-byte chunks are placed to match, so the
//     halves layout needs no shuffle across k;
//   * each group's partial sum starts fresh (scale-d 0) in its own
//     registers and is folded into the fp32 total times its scale row when
//     the group ends, so a scale multiplies O(M*N) values per group, never
//     the K*N weights; per-column scales (K3) multiply the finished sum,
//     each tile's partial folded in unscaled, so no chain of the tensor
//     cores' fp32 accumulation (which truncates) is longer than one tile;
//   * K6 decodes n - 8 exactly (bf16 0x4300 | n is 128 + n, minus 136), K5
//     n - 8 as int8; K7's int32 sum covers the whole K, and
//     float(acc) * sx * sw is rounded exactly as its plain version does,
//     so the two agree bit for bit;
//   * K is split across blockIdx.z when the output tiles alone do not fill
//     the card (ops/matmul.py:_q_plan); partials (fp32, or int32 for K7,
//     whose sum then stays exact) are summed by a second small kernel.
// Measured at the prompt buckets (PERF.md): not the tensor cores but the
// copies from L2 set the time -- every 128-column block reads x's whole
// tile, 32 KB of bf16 for each 8 KB of int4 weights (TMA moves it faster
// than 16-byte cp.async copies).
#include <cuda.h>
#include <cudaTypedefs.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kBK = 128;  // k-rows (value rows) per tile
constexpr int kBN = 128;  // columns per block, 64 per warpgroup
constexpr int kThreads = 256;

enum WKind { kW8 = 0, kW4 = 1 };

// One instance: weight kind, per-column scales (K3, K7), x's type, x rows
// a block.
template <int KIND, bool kCol, typename XT, int BM>
struct Cfg {
  static constexpr bool kS8 = sizeof(XT) == 1;   // K5, K7
  static constexpr bool kF32 = sizeof(XT) == 4;  // fp32 x in three bf16 parts
  static constexpr bool kWhole = kS8 && kCol;    // K7: one int32 sum over K
  // x's tile by TMA at the prompt sizes (bf16 or int8 x); by cp.async at
  // decode, where TMA measured slower, and for fp32 x, which is converted
  static constexpr bool kTmaX = !kF32 && BM > 16;
  static constexpr int kParts = kF32 ? 3 : 1;
  static constexpr int kStepK = kS8 ? 32 : 16;   // k per product step
  static constexpr int kSteps = kBK / kStepK;
  static constexpr int kWRows = KIND == kW4 ? kBK / 2 : kBK;  // stored rows a tile
  static constexpr int kMats = kWRows / 8;       // ldmatrix 8x8 matrices a warp
  static constexpr int kXBytes = BM * kBK * (int)sizeof(XT);
  static constexpr int kWBytes = kWRows * kBN;
  static constexpr int kSBytes = kCol ? 0 : (kBK / 32) * kBN * 4;  // g >= 32
  static constexpr int kStage = kXBytes + kWBytes + kSBytes;
  static constexpr int kPartTile = BM * kBK * 2;  // one bf16 operand tile
  static constexpr int kPartsBytes = kF32 ? 3 * kPartTile : 0;
  // decode: two blocks an SM, each with up to six tiles in flight; prompt:
  // one block an SM, four stages
  static constexpr int kBudget = (BM <= 16 ? 96 : 200) * 1024 - kPartsBytes;
  static constexpr int kFit = kBudget / kStage;
  static constexpr int kMaxStages = BM <= 16 ? 6 : 4;
  static constexpr int kStages = kFit < 3 ? 3 : (kFit > kMaxStages ? kMaxStages : kFit);
  // + 1024: the ring starts at the next 1024-byte boundary (the swizzle atom)
  static constexpr int kSmem = 1024 + kStages * kStage + kPartsBytes + kStages * 8;
  static constexpr int kAcc = BM / 2;  // accumulator registers a thread
};

// Position of chunk c (16 bytes) of a raw weight row r in the ring: the
// chunks of the 8 rows one ldmatrix reads fall in 8 distinct bank groups,
// both for 8 consecutive rows and for the s8 kinds' rows {4q, 4q + 1} and
// {4q + 2, 4q + 3} of a 16-row chunk (mat_row).
__device__ __forceinline__ uint32_t w_off(int r, int c) {
  return r * kBN + ((c ^ ((r ^ ((r >> 2) & 2)) & 7)) << 4);
}

// Stored row of row i (0..7) of a warp's ldmatrix matrix mi in a tile.
// bf16 kinds: rows 8mi .. 8mi + 7 (16 stored rows 16j .. are matrices 2j
// and 2j + 1).  s8 kinds: a 16-row chunk is two matrices, giving thread
// quad q rows 4q, 4q + 1, then 4q + 2, 4q + 3.
template <bool kS8>
__device__ __forceinline__ int mat_row(int mi, int i) {
  if constexpr (!kS8) return 8 * mi + i;
  return 16 * (mi >> 1) + 2 * (mi & 1) + 4 * (i >> 1) + (i & 1);
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// A register r from ldmatrix.trans holds bytes (k, c), (k, c + 1),
// (k + 1, c), (k + 1, c + 1): two k-rows of this thread's two columns.

// Nibbles n at bit `sh` of bytes 0 and 2 of r as the bf16 pair n - 8:
// 0x4300 | n is 128 + n exactly, and 136 is exact.
__device__ __forceinline__ uint32_t nib_bf16(uint32_t r, int sh) {
  const uint32_t v = ((r >> sh) & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 d =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&d);
}

// Signed bytes j and j + 2 of r as a bf16 pair (exact): 0x4B0000 | (b ^ 0x80)
// is 2^23 + 128 + b in fp32.
__device__ __forceinline__ uint32_t s8_bf16(uint32_t r, int j) {
  const uint32_t u = r ^ 0x80808080u;
  const float lo = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) - 8388736.f;
  const float hi = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7542 + j)) - 8388736.f;
  return fatt::pack_bf16(lo, hi);
}

// Nibbles n (low nibble of each byte of w) as the int8 values n - 8.
__device__ __forceinline__ uint32_t nib_s8(uint32_t w) {
  return ((w & 0x0F0F0F0Fu) + 0x78787878u) ^ 0x80808080u;
}

// Column c's (and c + 1's) bytes of k-rows 4q .. 4q + 3 of an s8 kinds'
// 16-row chunk c16, k-row 4q in the low byte.
template <int kMats>
__device__ __forceinline__ uint32_t col4(const uint32_t (&r)[kMats], int c16, int hi) {
  return __byte_perm(r[2 * c16], r[2 * c16 + 1], hi ? 0x7531 : 0x6420);
}

// This thread's A fragment of product step s (x's k-rows s*kStepK .. of the
// tile, in order) from its ldmatrix registers; LG = log2(g).  A rows gid
// and gid + 8 of the warp's 16 are its columns c and c + 1.
template <int KIND, bool kS8, int LG, int kMats>
__device__ __forceinline__ void decode_a(uint32_t (&a)[4], const uint32_t (&r)[kMats], int s) {
  if constexpr (!kS8 && KIND == kW8) {  // K3, K3g: k-rows 16s + (2q, 2q+1), then + 8
    a[0] = s8_bf16(r[2 * s], 0);
    a[1] = s8_bf16(r[2 * s], 1);
    a[2] = s8_bf16(r[2 * s + 1], 0);
    a[3] = s8_bf16(r[2 * s + 1], 1);
  } else if constexpr (!kS8) {
    // K6: a step is the low or the high nibbles of 16 packed rows 16j ..; a
    // group's g/32 low steps come first, then its high ones
    constexpr int lh = LG - 5;
    const int half = (s >> lh) & 1;
    const int j = ((s >> (lh + 1)) << lh) + (s & ((1 << lh) - 1));
    a[0] = nib_bf16(r[2 * j], 4 * half);
    a[1] = nib_bf16(r[2 * j], 8 + 4 * half);
    a[2] = nib_bf16(r[2 * j + 1], 4 * half);
    a[3] = nib_bf16(r[2 * j + 1], 8 + 4 * half);
  } else if constexpr (KIND == kW8) {  // K7: 16-row chunks 2s and 2s + 1
    a[0] = col4(r, 2 * s, 0);
    a[1] = col4(r, 2 * s, 1);
    a[2] = col4(r, 2 * s + 1, 0);
    a[3] = col4(r, 2 * s + 1, 1);
  } else if constexpr (LG == 5) {  // K5, g = 32: chunk s's low nibbles, then high
    const uint32_t c0 = col4(r, s, 0), c1 = col4(r, s, 1);
    a[0] = nib_s8(c0);
    a[1] = nib_s8(c1);
    a[2] = nib_s8(c0 >> 4);
    a[3] = nib_s8(c1 >> 4);
  } else {  // K5: the low or high nibbles of 32 packed rows 32j .. (chunks 2j, 2j + 1)
    const int half = LG == 7 ? s >> 1 : s & 1, j = LG == 7 ? s & 1 : s >> 1;
    a[0] = nib_s8(col4(r, 2 * j, 0) >> (4 * half));
    a[1] = nib_s8(col4(r, 2 * j, 1) >> (4 * half));
    a[2] = nib_s8(col4(r, 2 * j + 1, 0) >> (4 * half));
    a[3] = nib_s8(col4(r, 2 * j + 1, 1) >> (4 * half));
  }
}

// An int32 group partial (|v| < 2^22) as float, exactly: 0x4B400000 + v is
// 1.5 * 2^23 + v.
__device__ __forceinline__ float i2f_small(int v) {
  return __int_as_float(0x4B400000 + v) - 12582912.f;
}

// At the prompt sizes x's tile (bf16 or int8) arrives by TMA, one box of
// 128 bytes a row per 64 (bf16) or 128 (int8) k, in the 128-byte swizzle,
// rows past M zero-filled; one barrier a stage counts its bytes.
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

template <typename T, int N>
__device__ __forceinline__ void zero(T (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0;
}

// Two outputs (row, col) and (row, col + 1) at element o of dst: fp32, or
// bf16 when as_bf16; int32 for K7's partials.
__device__ __forceinline__ void store_pair(void* dst, int64_t o, float v0, float v1, int as_bf16) {
  if (as_bf16)
    *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(dst) + o) = fatt::pack_bf16(v0, v1);
  else
    *reinterpret_cast<float2*>(static_cast<float*>(dst) + o) = make_float2(v0, v1);
}

__device__ __forceinline__ void store_pair(void* dst, int64_t o, int v0, int v1) {
  *reinterpret_cast<int2*>(static_cast<int*>(dst) + o) = make_int2(v0, v1);
}

// ---------------------------------------------------------------------------
// The kernel.  Float x (XT bf16 or fp32): K3 (KIND = kW8, kCol), K3g (kW8),
// K6 (kW4).  int8 x (XT int8, sx per row): K5 (kW4), K7 (kW8, kCol).  g is
// a power of two in 32..128 (0 for kCol).
// ---------------------------------------------------------------------------

template <int KIND, bool kCol, typename XT, int BM>
__global__ void __launch_bounds__(kThreads, BM <= 16 ? 2 : 1)
q_kernel(const XT* __restrict__ x, const float* __restrict__ sx,
         const uint8_t* __restrict__ w, const float* __restrict__ scales,
         void* __restrict__ out, void* __restrict__ part, int M, int K, int N,
         int g, int out_bf16, int k_per_split, const __grid_constant__ CUtensorMap x_map) {
  using C = Cfg<KIND, kCol, XT, BM>;
  using Acc = typename std::conditional<C::kS8, int, float>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_base = fatt::smem_u32(smem);
  const uint32_t ring = (s_base + 1023) & ~1023u;
  const uint32_t parts = ring + C::kStages * C::kStage;
  const uint32_t xbar = parts + C::kPartsBytes;  // x's tile landed, a barrier a stage
  unsigned char* ring_p = smem + (ring - s_base);

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const int gid = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * k_per_split;
  const int n_tiles = (min(K, kbeg + k_per_split) - kbeg) / kBK;
  const int wchunk = 4 * wg + warp;          // this warp's 16 columns of a row
  const int cl = 16 * wchunk + 2 * gid;      // this thread's columns cl, cl + 1
  const int lg = kCol ? 7 : __ffs(g) - 1;  // log2 of k-rows a fold (a tile for kCol)

  // A thread's x chunks (cp.async: decode, fp32 x) lie at one chunk column
  // pc, every kXRows-th row from r0: their places, and their rows' swizzle,
  // are the same in every tile.  So are its weight chunks (column wc, every
  // 32nd row from wr0).
  constexpr int kRowChunks = kBK * (int)sizeof(XT) / 16;
  constexpr int kXRows = kThreads / kRowChunks;
  const int pc = tid % kRowChunks, r0 = tid / kRowChunks;
  const uint32_t x_dst = C::kF32 ? r0 * kBK * 4 + pc * 16 : fatt::sw128<BM>(r0, pc);
  constexpr int kXStride = C::kF32 ? kXRows * kBK * 4 : kXRows * 128;
  const XT* x_src = x + (int64_t)(m0 + r0) * K + pc * (16 / (int)sizeof(XT));
  const int wc = tid & 7, wr0 = tid >> 3;
  const uint32_t w_dst = w_off(wr0, wc);
  const bool w_in = n0 + wc * 16 < N;
  const uint8_t* w_src = w + (int64_t)wr0 * N + (w_in ? n0 + wc * 16 : 0);

  auto load_tile = [&](int st, int k0) {
    const uint32_t xs = ring + st * C::kStage, ws = xs + C::kXBytes, ss = ws + C::kWBytes;
    if constexpr (!C::kTmaX) {
#pragma unroll
      for (int j = 0; j * kXRows < BM; ++j) {
        if (r0 + j * kXRows >= BM) break;
        const bool in = m0 + r0 + j * kXRows < M;
        fatt::cp_async16(xs + x_dst + j * kXStride,
                         in ? x_src + (int64_t)j * kXRows * K + k0 : x, in ? 16 : 0);
      }
    } else if (tid == 0) {
      bar_expect(xbar + st * 8, C::kXBytes);
#pragma unroll
      for (int h = 0; h < C::kXBytes / (BM * 128); ++h)
        tma_load_2d(xs + h * BM * 128, &x_map, k0 + h * (128 / (int)sizeof(XT)), m0,
                    xbar + st * 8);
    }
    const int64_t wk = (int64_t)(KIND == kW4 ? k0 / 2 : k0) * N;
    if (N % 16 == 0) {
#pragma unroll
      for (int j = 0; j < C::kWRows / 32; ++j)
        fatt::cp_async16(ws + w_dst + j * 32 * kBN, w_src + wk + (int64_t)j * 32 * N,
                         w_in ? 16 : 0);
    } else {  // rows are 4-byte aligned only
      for (int i = tid; i < C::kWRows * 32; i += kThreads) {
        const int r = i >> 5, q = i & 31, n = n0 + q * 4;
        fatt::cp_async4(ws + w_off(r, q >> 2) + (q & 3) * 4,
                        w + wk + (int64_t)r * N + (n < N ? n : 0), n < N ? 4 : 0);
      }
    }
    if constexpr (!kCol) {
      if (tid < (32 << (7 - lg))) {  // the tile's 128 / g scale rows
        const int r = tid >> 5, c = tid & 31, n = n0 + c * 4;
        fatt::cp_async16(ss + r * kBN * 4 + c * 16,
                         scales + (int64_t)((k0 >> lg) + r) * N + (n < N ? n : 0),
                         n < N ? 16 : 0);
      }
    }
  };
  if constexpr (C::kTmaX) {
    if (tid == 0) {
      for (int i = 0; i < C::kStages; ++i) bar_init(xbar + i * 8, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i, kbeg + i * kBK);
    fatt::cp_async_commit();
  }

  float acc[C::kAcc];  // fp32 total (all but K7)
  Acc prt[C::kAcc];    // the group's partial (K7: the whole int32 sum)
  zero(acc);
  zero(prt);

  for (int t = 0; t < n_tiles; ++t) {
    fatt::cp_async_wait<C::kStages - 2>();
    if constexpr (!C::kTmaX) fatt::fence_proxy_async();  // cp.async -> wgmma
    __syncthreads();  // tile t's cp.async data is in; every thread is done with t - 1
    const int st = t % C::kStages;
    if constexpr (C::kTmaX) bar_wait(xbar + st * 8, (t / C::kStages) & 1);
    const uint32_t xs = ring + st * C::kStage, ws = xs + C::kXBytes, ss = ws + C::kWBytes;
    // the next tile into the stage of t - 1, issued once this tile's
    // products are under way
    auto refill = [&]() {
      if (t + C::kStages - 1 < n_tiles)
        load_tile((t + C::kStages - 1) % C::kStages, kbeg + (t + C::kStages - 1) * kBK);
      fatt::cp_async_commit();
    };

    if constexpr (C::kF32) {
      // fp32 x -> three bf16 operand tiles whose sum is x exactly: each part
      // is the bf16 rounding of what the earlier parts left, and that
      // remainder is exact in fp32
      const unsigned char* raw = ring_p + (xs - ring);
      unsigned char* pt = ring_p + (parts - ring);
      for (int i = tid; i < BM * (kBK / 4); i += kThreads) {
        const int r = i / (kBK / 4), q = i % (kBK / 4);  // k 4q .. 4q + 3
        float v[4];
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(raw + r * kBK * 4 + q * 16);
        const uint32_t o = fatt::sw128<BM>(r, q >> 1) + (q & 1) * 8;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          v[0] -= __low2float(lo);
          v[1] -= __high2float(lo);
          v[2] -= __low2float(hi);
          v[3] -= __high2float(hi);
          *reinterpret_cast<uint2*>(pt + p * C::kPartTile + o) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                         *reinterpret_cast<const uint32_t*>(&hi));
        }
      }
      fatt::fence_proxy_async();
      __syncthreads();
    }
    const uint32_t xop = C::kF32 ? parts : xs;

    // this thread's pairs of raw weight bytes of the tile
    uint32_t r[C::kMats];
#pragma unroll
    for (int h = 0; h < C::kMats / 4; ++h) {
      const int row = mat_row<C::kS8>(4 * h + (lane >> 3), lane & 7);
      ldsm_x4_t(reinterpret_cast<uint32_t(&)[4]>(r[4 * h]), ws + w_off(row, wchunk));
    }

    // Product step s reads x's k-rows s*kStepK .. of the tile; a group
    // (LG = log2 g; a tile for K3) is kSpg consecutive steps, whose partial
    // is folded into acc times its scale row when they are done.
    auto products = [&](auto lg_c) {
      constexpr int LG = decltype(lg_c)::value;
      constexpr int kSpg = C::kWhole ? C::kSteps : 1 << (LG - (C::kS8 ? 5 : 4));
      uint32_t a[C::kSteps][4];
#pragma unroll
      for (int s = 0; s < C::kSteps; ++s) {
        decode_a<KIND, C::kS8, LG, C::kMats>(a[s], r, s);
        fatt::pin(prt);
        fatt::wg_fence();
#pragma unroll
        for (int p = 0; p < C::kParts; ++p) {
          const uint64_t desc = fatt::wg_desc(fatt::kmajor<BM>(xop + p * C::kPartTile, s));
          const int scale_d = C::kWhole ? (t > 0 || s > 0) : (p > 0 || s % kSpg != 0);
          if constexpr (C::kS8)
            fatt::wgmma_rs_s8(prt, a[s], desc, scale_d);
          else
            fatt::wgmma_rs<0>(prt, a[s], desc, scale_d);
        }
        if (s % kSpg != kSpg - 1) continue;
        fatt::wg_commit();
        if (s == C::kSteps - 1) refill();
        fatt::wg_wait_all();
        fatt::pin(prt);
        if constexpr (!C::kWhole) {
          float s0 = 1.f, s1 = 1.f;
          if constexpr (!kCol) {
            const float2 sc = *reinterpret_cast<const float2*>(
                ring_p + (ss - ring) + (s / kSpg) * kBN * 4 + cl * 4);
            s0 = sc.x;
            s1 = sc.y;
          }
#pragma unroll
          for (int j = 0; j < C::kAcc; j += 4) {
            if constexpr (C::kS8) {
              acc[j] = fmaf(i2f_small(prt[j]), s0, acc[j]);
              acc[j + 1] = fmaf(i2f_small(prt[j + 1]), s0, acc[j + 1]);
              acc[j + 2] = fmaf(i2f_small(prt[j + 2]), s1, acc[j + 2]);
              acc[j + 3] = fmaf(i2f_small(prt[j + 3]), s1, acc[j + 3]);
            } else {
              acc[j] = fmaf(prt[j], s0, acc[j]);
              acc[j + 1] = fmaf(prt[j + 1], s0, acc[j + 1]);
              acc[j + 2] = fmaf(prt[j + 2], s1, acc[j + 2]);
              acc[j + 3] = fmaf(prt[j + 3], s1, acc[j + 3]);
            }
          }
        }
      }
    };
    if constexpr (kCol) {
      products(std::integral_constant<int, 7>());
    } else {
      if (lg == 7)
        products(std::integral_constant<int, 7>());
      else if (lg == 6)
        products(std::integral_constant<int, 6>());
      else
        products(std::integral_constant<int, 5>());
    }
  }
  fatt::cp_async_wait<0>();

  // Accumulator entry 4j + e (e = 0, 1) is column cl, 4j + 2 + e column
  // cl + 1, both of x row 8j + 2 tq + e.
  const int col = n0 + cl;
  if (col >= N) return;
  const bool split = gridDim.z > 1;
  float cs0 = 1.f, cs1 = 1.f;  // per-column scales (K3, K7)
  if constexpr (kCol) {
    cs0 = __ldg(scales + col);
    cs1 = __ldg(scales + col + 1);
  }
#pragma unroll
  for (int j = 0; j < C::kAcc / 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * j + 2 * tq + e;
      if (row >= M) continue;
      const int64_t o = (int64_t)row * N + col;
      const int64_t po = (int64_t)blockIdx.z * M * N + o;
      if constexpr (C::kWhole) {  // K7
        const int i0 = prt[4 * j + e], i1 = prt[4 * j + 2 + e];
        if (split) {
          store_pair(part, po, i0, i1);
        } else {
          const float r0 = sx[row];
          store_pair(out, o, __fmul_rn(__fmul_rn(__int2float_rn(i0), r0), cs0),
                            __fmul_rn(__fmul_rn(__int2float_rn(i1), r0), cs1), out_bf16);
        }
      } else {
        float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
        if constexpr (kCol) {  // K3
          v0 *= cs0;
          v1 *= cs1;
        }
        if (split) {
          store_pair(part, po, v0, v1, 0);
        } else {
          if constexpr (C::kS8) {  // K5
            v0 = __fmul_rn(v0, sx[row]);
            v1 = __fmul_rn(v1, sx[row]);
          }
          store_pair(out, o, v0, v1, out_bf16);
        }
      }
    }
}

// Sum of the K splits.  fp32 partials (K3, K3g, K6: sx null; K5: times sx) or
// int32 partials (K7: float(sum) * sx * sw).
__global__ void reduce_f32_kernel(const float* __restrict__ part,
                                  const float* __restrict__ sx, void* out,
                                  int M, int N, int splits, int out_bf16) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)M * N;
  if (i >= total) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * total + i];
  if (sx) s = __fmul_rn(s, sx[i / N]);
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(s);
  else
    static_cast<float*>(out)[i] = s;
}

__global__ void reduce_s32_kernel(const int* __restrict__ part,
                                  const float* __restrict__ sx,
                                  const float* __restrict__ sw, void* out,
                                  int M, int N, int splits, int out_bf16) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)M * N;
  if (i >= total) return;
  int s = 0;
  for (int z = 0; z < splits; ++z) s += part[z * total + i];
  const float v = __fmul_rn(__fmul_rn(__int2float_rn(s), sx[i / N]), sw[i % N]);
  if (out_bf16)
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(out)[i] = v;
}

// The driver's cuTensorMapEncodeTiled, found once through the runtime (the
// library links no libcuda).
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// x [M, K] (bf16 or int8) as boxes of 128 bytes x BM rows, 128-byte
// swizzle, rows past M read as zero.
template <typename XT, int BM>
cudaError_t x_tensor_map(CUtensorMap* map, const void* x, int M, int K) {
  const auto encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(XT)};
  const cuuint32_t box[2] = {128 / (cuuint32_t)sizeof(XT), (cuuint32_t)BM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, sizeof(XT) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
      const_cast<void*>(x), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int KIND, bool kCol, typename XT, int BM>
cudaError_t launch(const void* x, const void* sx, const void* w, const void* scales, void* out,
                   void* part, int M, int K, int N, int g, int out_bf16, int kps, int splits,
                   cudaStream_t st) {
  using C = Cfg<KIND, kCol, XT, BM>;
  auto kern = q_kernel<KIND, kCol, XT, BM>;
  static fatt::SmemLimitSet smem_set;
  cudaError_t e = fatt::smem_limit_once(kern, C::kSmem, smem_set);
  if (e != cudaSuccess) return e;
  CUtensorMap x_map{};
  if constexpr (C::kTmaX) {
    e = x_tensor_map<XT, BM>(&x_map, x, M, K);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((M + BM - 1) / BM, (N + kBN - 1) / kBN, splits);
  kern<<<grid, kThreads, C::kSmem, st>>>(
      static_cast<const XT*>(x), static_cast<const float*>(sx), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scales), out, part, M, K, N, g, out_bf16, kps, x_map);
  return cudaSuccess;
}

// x rows a block: 16 at decode, else 64 up to M = 64 (and for fp32 x,
// whose three bf16 parts take shared memory), else 128.
template <int KIND, bool kCol, typename XT>
cudaError_t launch_m(const void* x, const void* sx, const void* w, const void* scales, void* out,
                     void* part, int M, int K, int N, int g, int out_bf16, int kps, int splits,
                     cudaStream_t st) {
  if (M <= 16)
    return launch<KIND, kCol, XT, 16>(x, sx, w, scales, out, part, M, K, N, g, out_bf16, kps,
                                      splits, st);
  if constexpr (sizeof(XT) != 4) {
    if (M > 64)
      return launch<KIND, kCol, XT, 128>(x, sx, w, scales, out, part, M, K, N, g, out_bf16, kps,
                                         splits, st);
  }
  return launch<KIND, kCol, XT, 64>(x, sx, w, scales, out, part, M, K, N, g, out_bf16, kps,
                                    splits, st);
}

// The split count of k_per_split, or 0 for a shape the kernels do not take.
int splits_of(int M, int K, int N, int kps, const void* part) {
  if (M < 1 || K % kBK != 0 || N % 4 != 0 || kps < kBK || kps % kBK != 0) return 0;
  const int splits = (K + kps - 1) / kps;
  return splits > 1 && !part ? 0 : splits;
}

}  // namespace

// K6 (int4 = 1: packed halves [K/2, N] uint8, g in {32, 64, 128}), K3
// grouped (int4 = 0: int8 [K, N], same g) or K3 (int4 = 0, g = 0: scales
// [N]); x [M, K] bf16 (x_f32 = 0) or fp32; fp32 scales [K/g, N]; out
// [M, N] bf16 (out_bf16 = 1) or fp32.  k_per_split: k-rows a split, a
// multiple of 128; more than one split needs part: fp32 scratch of
// splits * M * N.
extern "C" int fatt_matmul_float_q(const void* x, const void* w, const void* scales,
                                   void* out, void* part, int M, int K, int N,
                                   int g, int int4, int x_f32, int out_bf16,
                                   int k_per_split, void* stream) {
  const int splits = splits_of(M, K, N, k_per_split, part);
  if (!splits || (g != 32 && g != 64 && g != 128 && !(g == 0 && !int4)))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define FATT_FLOAT_Q(KIND, COL)                                                             \
  (x_f32 ? launch_m<KIND, COL, float>(x, nullptr, w, scales, out, part, M, K, N, g,          \
                                      out_bf16, k_per_split, splits, st)                     \
         : launch_m<KIND, COL, __nv_bfloat16>(x, nullptr, w, scales, out, part, M, K, N, g,  \
                                              out_bf16, k_per_split, splits, st))
  if (int4)
    e = FATT_FLOAT_Q(kW4, false);
  else if (g)
    e = FATT_FLOAT_Q(kW8, false);
  else
    e = FATT_FLOAT_Q(kW8, true);
#undef FATT_FLOAT_Q
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    const int64_t total = (int64_t)M * N;
    reduce_f32_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        static_cast<const float*>(part), nullptr, out, M, N, splits, out_bf16);
  }
  return (int)cudaGetLastError();
}

// K5 (int4 = 1: packed halves, fp32 scales [K/g, N]) or K7 (int4 = 0: int8
// [K, N], fp32 scales [N]); int8 x [M, K] with fp32 sx [M]; out [M, N] fp32
// or bf16.  k_per_split as above; more than one split needs part: splits *
// M * N of fp32 (K5) or int32 (K7).
extern "C" int fatt_matmul_s8_q(const void* x, const void* sx, const void* w,
                                const void* scales, void* out, void* part, int M,
                                int K, int N, int g, int int4, int out_bf16,
                                int k_per_split, void* stream) {
  const int splits = splits_of(M, K, N, k_per_split, part);
  if (!splits || (int4 && g != 32 && g != 64 && g != 128))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      int4 ? launch_m<kW4, false, int8_t>(x, sx, w, scales, out, part, M, K, N, g, out_bf16,
                                          k_per_split, splits, st)
           : launch_m<kW8, true, int8_t>(x, sx, w, scales, out, part, M, K, N, 0, out_bf16,
                                         k_per_split, splits, st);
  if (e != cudaSuccess) return (int)e;
  if (splits > 1) {
    const int64_t total = (int64_t)M * N;
    const unsigned blocks = (unsigned)((total + 255) / 256);
    if (int4)
      reduce_f32_kernel<<<blocks, 256, 0, st>>>(static_cast<const float*>(part),
                                                static_cast<const float*>(sx), out,
                                                M, N, splits, out_bf16);
    else
      reduce_s32_kernel<<<blocks, 256, 0, st>>>(static_cast<const int*>(part),
                                                static_cast<const float*>(sx),
                                                static_cast<const float*>(scales),
                                                out, M, N, splits, out_bf16);
  }
  return (int)cudaGetLastError();
}

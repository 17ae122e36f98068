// Quantized matmuls on mma.sync, out[M, N] = x[M, K] @ W[K, N] with the
// scales folded out of the product:
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
// times as many for fp32 x; int8 for K5/K7).
// The design, simple first:
//   * a block owns 128 columns and BM rows (16 at decode, else 64) and
//     walks K in tiles of 128 k-rows; each tile of weights is read once
//     from device memory as 4-byte words (4 k-rows x 4 columns per thread,
//     128 contiguous bytes per warp and row), transposed in registers with
//     byte permutes and decoded into shared memory as one word per (k-pair
//     or k-quad, column), so an mma B fragment is one conflict-free 32-bit
//     load and four columns are one 16-byte store; at decode the next
//     tile's words are fetched into registers while the mma runs;
//   * the bf16 kernel runs mma.sync m16n8k16 (fp32 accumulate), the int8
//     kernel m16n8k32 (exact int32 accumulate); each group's partial sum
//     stays in its own registers and is folded into the fp32 accumulator
//     with its scale row when the group ends, so a scale multiplies
//     O(M*N) values per group, never the K*N weights; per-column scales
//     (K3) multiply the finished sum, each tile's partial folded in
//     unscaled;
//   * K6 keeps the nibble n (0..15, exact in bf16) and subtracts 8 * sum(x)
//     per group as the TPU kernel does; K5 decodes n - 8 to int8 with one
//     SIMD byte subtract and needs no offset; K7's int32 sum covers the
//     whole K, and float(acc) * sx * sw is rounded exactly as its plain
//     version does, so the two agree bit for bit;
//   * at decode K is split across blockIdx.z so that a projection's N/128
//     column blocks still fill the 132 SMs; partials (fp32, or int32 for
//     K7, whose sum then stays exact) are summed by a second small kernel.
#include "common.cuh"

namespace {

constexpr int kBK = 128;  // k-rows (value rows) per tile
constexpr int kBN = 128;  // columns per block
constexpr int kThreads = 128;

enum WKind { kW8 = 0, kW4 = 1 };

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Byte c of each of four words (k-rows 0..3 of one column quad) as one
// word, k-row 0 in the low byte.
__device__ __forceinline__ uint32_t gather_col(const uint32_t (&r)[4], int c) {
  const uint32_t sel = c | ((c + 4) << 4);
  const uint32_t t01 = __byte_perm(r[0], r[1], sel);
  const uint32_t t23 = __byte_perm(r[2], r[3], sel);
  return __byte_perm(t01, t23, 0x5410);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Bytes (2h, 2h + 1) of `word`, signed int8, as a bf16 pair (exact).
__device__ __forceinline__ uint32_t s8_pair(uint32_t word, int h) {
  return bits(__floats2bfloat162_rn((float)(int8_t)(word >> (16 * h)),
                                    (float)(int8_t)(word >> (16 * h + 8))));
}

// Nibbles n in bytes (2h, 2h + 1) of `word` as the bf16 pair (n, n): one
// byte permute puts n in the mantissa under the exponent of 128 (bf16
// 0x4300 | n == 128 + n exactly), one subtract removes the 128.
__device__ __forceinline__ uint32_t nib_pair(uint32_t word, int h) {
  const uint32_t v = __byte_perm(word, 0x43434343u, h ? 0x4342u : 0x4140u);
  return bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                      __floats2bfloat162_rn(128.f, 128.f)));
}

// Shared-memory weight layout, for both operand types: 32-bit words
// ws[kg][n], where word (kg, n) holds the P consecutive k-values
// kg*P .. kg*P + P - 1 of column n (P = 2 bf16 or 4 int8) -- exactly one
// mma B-fragment register.  A row holds kBN + 8 words, so the eight
// columns and four k-groups one fragment load touches fall in 32
// distinct banks, and four columns' words are one 16-byte store.
constexpr int kLDW = kBN + 8;

// The raw words of one weight tile (4 stored rows x 4 columns per item),
// fetched from device memory ahead of their decode.
template <int KIND>
struct WFrag {
  static constexpr int kRows = KIND == kW4 ? kBK / 2 : kBK;  // stored rows
  static constexpr int kItems = (kRows / 4) * (kBN / 4) / kThreads;
  uint32_t r[kItems][4];
};

// Item it of a thread: k-quad kq = warp + 4 * it, column quad = lane, so a
// warp reads 128 contiguous bytes of each stored row.  Columns >= N
// (N % 4 == 0: whole quads) read as zero; their outputs are never written.
template <int KIND>
__device__ __forceinline__ void fetch_w(WFrag<KIND>& f, const uint8_t* __restrict__ w,
                                        int k0, int n0, int N) {
  const int row0 = KIND == kW4 ? k0 / 2 : k0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = n0 + lane * 4;
#pragma unroll
  for (int it = 0; it < WFrag<KIND>::kItems; ++it) {
    const int kq = warp + it * (kThreads / 32);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f.r[it][j] = n < N ? __ldg(reinterpret_cast<const uint32_t*>(
                               w + (int64_t)(row0 + kq * 4 + j) * N + n))
                         : 0u;
  }
}

// Decode a fetched tile into ws (layout above) as the kernel's operand
// type T: bf16 (int8 values, or nibbles n for K6, which subtracts 8 sum(x)
// per group) or int8 (int8 values, or n - 8 for K5).
template <int KIND, typename T>
__device__ __forceinline__ void stash_w(uint32_t* ws, const WFrag<KIND>& f, int g) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int it = 0; it < WFrag<KIND>::kItems; ++it) {
    const int kq = warp + it * (kThreads / 32);
    uint32_t c[4];  // per column: its 4 k-values, k-row 0 in the low byte
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) c[cc] = gather_col(f.r[it], cc);
    uint32_t* dst = ws + lane * 4;
    if constexpr (sizeof(T) == 1) {
      if constexpr (KIND == kW8) {
        *reinterpret_cast<uint4*>(dst + kq * kLDW) = make_uint4(c[0], c[1], c[2], c[3]);
      } else {
        const int half = g / 2, pr = kq * 4;  // packed row; g/2 % 4 == 0
        const int klo = (pr / half) * g + pr % half;
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          lo[cc] = __vsub4(c[cc] & 0x0F0F0F0Fu, 0x08080808u);
          hi[cc] = __vsub4((c[cc] >> 4) & 0x0F0F0F0Fu, 0x08080808u);
        }
        *reinterpret_cast<uint4*>(dst + (klo / 4) * kLDW) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(dst + ((klo + half) / 4) * kLDW) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
    } else {
      if constexpr (KIND == kW8) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint4*>(dst + (kq * 2 + h) * kLDW) =
              make_uint4(s8_pair(c[0], h), s8_pair(c[1], h), s8_pair(c[2], h), s8_pair(c[3], h));
      } else {
        const int half = g / 2, pr = kq * 4;
        const int klo = (pr / half) * g + pr % half;
#pragma unroll
        for (int part = 0; part < 2; ++part) {  // low nibbles, then high
          uint32_t n4[4];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) n4[cc] = (c[cc] >> (4 * part)) & 0x0F0F0F0Fu;
          const int kp = (klo + part * half) / 2;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint4*>(dst + (kp + h) * kLDW) =
                make_uint4(nib_pair(n4[0], h), nib_pair(n4[1], h), nib_pair(n4[2], h),
                           nib_pair(n4[3], h));
        }
      }
    }
  }
}

// The x tile [BM, kBK], 16 bytes per item; rows >= M read as zero.
template <typename T, int BM>
struct XFrag {
  static constexpr int kPer = 16 / sizeof(T);  // elements per item
  static constexpr int kChunks = kBK / kPer;   // items per row
  static constexpr int kItems = BM * kChunks / kThreads;
  uint4 v[kItems];
};

template <typename T, int BM>
__device__ __forceinline__ void fetch_x(XFrag<T, BM>& f, const T* __restrict__ x,
                                        int m0, int k0, int M, int K) {
  using F = XFrag<T, BM>;
#pragma unroll
  for (int it = 0; it < F::kItems; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / F::kChunks, c = (i % F::kChunks) * F::kPer;
    f.v[it] = m0 + r < M ? __ldg(reinterpret_cast<const uint4*>(x + (int64_t)(m0 + r) * K + k0 + c))
                         : make_uint4(0, 0, 0, 0);
  }
}

template <typename T, int BM, int LD>
__device__ __forceinline__ void stash_x(T* xs, const XFrag<T, BM>& f) {
  using F = XFrag<T, BM>;
#pragma unroll
  for (int it = 0; it < F::kItems; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / F::kChunks, c = (i % F::kChunks) * F::kPer;
    *reinterpret_cast<uint4*>(xs + r * LD + c) = f.v[it];
  }
}

// An fp32 x tile as three bf16 tiles (xs + p * BM * LD, p = 0, 1, 2) whose
// sum is x exactly: each part is the bf16 rounding of what the earlier
// parts left, and that remainder is exact in fp32.
template <int BM, int LD>
__device__ __forceinline__ void stash_x_parts(__nv_bfloat16* xs, const XFrag<float, BM>& f) {
  using F = XFrag<float, BM>;
#pragma unroll
  for (int it = 0; it < F::kItems; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / F::kChunks, c = (i % F::kChunks) * F::kPer;
    float v[4];
    *reinterpret_cast<uint4*>(v) = f.v[it];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      v[0] -= __low2float(lo);
      v[1] -= __high2float(lo);
      v[2] -= __low2float(hi);
      v[3] -= __high2float(hi);
      *reinterpret_cast<uint2*>(xs + p * BM * LD + r * LD + c) = make_uint2(bits(lo), bits(hi));
    }
  }
}

template <int BM, int WARPS_M>
struct Tile {
  static constexpr int kWarpsN = 4 / WARPS_M;
  static constexpr int kWM = BM / WARPS_M;  // rows per warp
  static constexpr int kMT = kWM / 16;      // m16 tiles per warp
  static constexpr int kWN = kBN / kWarpsN; // columns per warp
  static constexpr int kNT = kWN / 8;       // n8 tiles per warp
};

// ---------------------------------------------------------------------------
// float activations (XT = bf16, or fp32 in three bf16 parts): K3 (KIND =
// kW8, kCol: per-column scales [N]), K3 grouped (kW8) and K6 (kW4); g is a
// power of two
// ---------------------------------------------------------------------------

template <int KIND, bool kCol, typename XT, int BM, int WARPS_M>
__global__ void __launch_bounds__(kThreads)
float_q_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
               const float* __restrict__ scales, void* __restrict__ out,
               float* __restrict__ part, int M, int K, int N, int g,
               int out_bf16, int k_per_split) {
  using TL = Tile<BM, WARPS_M>;
  constexpr int kParts = sizeof(XT) == 4 ? 3 : 1;
  constexpr int LD = kBK + 8;  // bf16 row stride of the x tile
  constexpr bool kAhead = BM <= 16;  // fetch the next tile during the mma
  extern __shared__ __align__(16) unsigned char smem[];
  auto xs = reinterpret_cast<__nv_bfloat16*>(smem);
  auto ws = reinterpret_cast<uint32_t*>(xs + kParts * BM * LD);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int wm0 = (warp / TL::kWarpsN) * TL::kWM;
  const int wn0 = (warp % TL::kWarpsN) * TL::kWN;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  float acc[TL::kMT][TL::kNT][4];
  float prt[TL::kMT][TL::kNT][4];
  float xsum[TL::kMT][2];
#pragma unroll
  for (int i = 0; i < TL::kMT; ++i) {
    xsum[i][0] = xsum[i][1] = 0.f;
#pragma unroll
    for (int j = 0; j < TL::kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = prt[i][j][r] = 0.f;
  }

  WFrag<KIND> wf;
  XFrag<XT, BM> xf;
  if constexpr (kAhead) {
    fetch_w<KIND>(wf, w, kbeg, n0, N);
    fetch_x<XT, BM>(xf, x, m0, kbeg, M, K);
  }
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    if constexpr (!kAhead) {
      fetch_w<KIND>(wf, w, k0, n0, N);
      fetch_x<XT, BM>(xf, x, m0, k0, M, K);
    }
    if constexpr (kParts == 1)
      stash_x<XT, BM, LD>(xs, xf);
    else
      stash_x_parts<BM, LD>(xs, xf);
    stash_w<KIND, __nv_bfloat16>(ws, wf, g);
    __syncthreads();
    if (kAhead && k0 + kBK < kend) {
      fetch_w<KIND>(wf, w, k0 + kBK, n0, N);
      fetch_x<XT, BM>(xf, x, m0, k0 + kBK, M, K);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[kParts][TL::kMT][4];
#pragma unroll
      for (int p = 0; p < kParts; ++p)
#pragma unroll
        for (int i = 0; i < TL::kMT; ++i) {
          const __nv_bfloat16* xr = xs + p * BM * LD + (wm0 + i * 16 + gid) * LD + kk + tq * 2;
          a[p][i][0] = lds32(xr);
          a[p][i][1] = lds32(xr + 8 * LD);
          a[p][i][2] = lds32(xr + 8);
          a[p][i][3] = lds32(xr + 8 * LD + 8);
          if constexpr (KIND == kW4) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t u = a[p][i][h], v = a[p][i][h + 2];
              xsum[i][h] += (__uint_as_float(u << 16) + __uint_as_float(u & 0xFFFF0000u)) +
                            (__uint_as_float(v << 16) + __uint_as_float(v & 0xFFFF0000u));
            }
          }
        }
#pragma unroll
      for (int j = 0; j < TL::kNT; ++j) {
        const uint32_t* wr = ws + (kk / 2 + tq) * kLDW + wn0 + j * 8 + gid;
        const uint32_t b0 = wr[0], b1 = wr[4 * kLDW];
#pragma unroll
        for (int p = 0; p < kParts; ++p)
#pragma unroll
          for (int i = 0; i < TL::kMT; ++i) mma_bf16(prt[i][j], a[p][i], b0, b1);
      }
      // a group ends: fold its partial into acc times its scale row.  With
      // per-column scales every tile folds unscaled and the scale
      // multiplies the finished sum, so no chain of the tensor cores' fp32
      // accumulation (which truncates) is longer than one tile
      if (kCol ? kk + 16 == kBK : ((k0 + kk + 16) & (g - 1)) == 0) {
        const int grp = kCol ? 0 : (k0 + kk) / g;
        float xg[TL::kMT][2];
#pragma unroll
        for (int i = 0; i < TL::kMT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = xsum[i][h];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            xg[i][h] = v;
            xsum[i][h] = 0.f;
          }
#pragma unroll
        for (int j = 0; j < TL::kNT; ++j) {
          const int col = n0 + wn0 + j * 8 + tq * 2;
          float s0 = 1.f, s1 = 1.f;
          if (!kCol && col < N) {
            s0 = __ldg(scales + (int64_t)grp * N + col);
            s1 = __ldg(scales + (int64_t)grp * N + col + 1);
          }
#pragma unroll
          for (int i = 0; i < TL::kMT; ++i)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float p = prt[i][j][r];
              if constexpr (KIND == kW4) p -= 8.f * xg[i][r >> 1];
              acc[i][j][r] += p * ((r & 1) ? s1 : s0);
              prt[i][j][r] = 0.f;
            }
        }
      }
    }
    __syncthreads();
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < TL::kMT; ++i)
#pragma unroll
    for (int j = 0; j < TL::kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm0 + i * 16 + gid + (r >> 1) * 8;
        const int col = n0 + wn0 + j * 8 + tq * 2 + (r & 1);
        if (row >= M || col >= N) continue;
        const int64_t o = (int64_t)row * N + col;
        const float v = kCol ? acc[i][j][r] * __ldg(scales + col) : acc[i][j][r];
        if (split)
          part[(int64_t)blockIdx.z * M * N + o] = v;
        else if (out_bf16)
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
        else
          static_cast<float*>(out)[o] = v;
      }
}

// ---------------------------------------------------------------------------
// int8 activations: K5 (KIND = kW4, grouped scales) and K7 (KIND = kW8,
// per-column scales after the whole int32 sum)
// ---------------------------------------------------------------------------

template <int KIND, int BM, int WARPS_M>
__global__ void __launch_bounds__(kThreads)
s8_q_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
            const uint8_t* __restrict__ w, const float* __restrict__ scales,
            void* __restrict__ out, void* __restrict__ part, int M, int K,
            int N, int g, int out_bf16, int k_per_split) {
  using TL = Tile<BM, WARPS_M>;
  constexpr int LD = kBK + 16;  // byte row stride of the x tile
  constexpr bool kAhead = BM <= 16;  // fetch the next tile during the mma
  extern __shared__ __align__(16) unsigned char smem[];
  auto xs = reinterpret_cast<int8_t*>(smem);
  auto ws = reinterpret_cast<uint32_t*>(xs + BM * LD);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tq = lane & 3;
  const int wm0 = (warp / TL::kWarpsN) * TL::kWM;
  const int wn0 = (warp % TL::kWarpsN) * TL::kWN;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  int iacc[TL::kMT][TL::kNT][4];
  float facc[TL::kMT][TL::kNT][4];
#pragma unroll
  for (int i = 0; i < TL::kMT; ++i)
#pragma unroll
    for (int j = 0; j < TL::kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        iacc[i][j][r] = 0;
        facc[i][j][r] = 0.f;
      }

  WFrag<KIND> wf;
  XFrag<int8_t, BM> xf;
  if constexpr (kAhead) {
    fetch_w<KIND>(wf, w, kbeg, n0, N);
    fetch_x<int8_t, BM>(xf, x, m0, kbeg, M, K);
  }
  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
    if constexpr (!kAhead) {
      fetch_w<KIND>(wf, w, k0, n0, N);
      fetch_x<int8_t, BM>(xf, x, m0, k0, M, K);
    }
    stash_x<int8_t, BM, LD>(xs, xf);
    stash_w<KIND, int8_t>(ws, wf, g);
    __syncthreads();
    if (kAhead && k0 + kBK < kend) {
      fetch_w<KIND>(wf, w, k0 + kBK, n0, N);
      fetch_x<int8_t, BM>(xf, x, m0, k0 + kBK, M, K);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[TL::kMT][4];
#pragma unroll
      for (int i = 0; i < TL::kMT; ++i) {
        const int8_t* xr = xs + (wm0 + i * 16 + gid) * LD + kk + tq * 4;
        a[i][0] = lds32(xr);
        a[i][1] = lds32(xr + 8 * LD);
        a[i][2] = lds32(xr + 16);
        a[i][3] = lds32(xr + 8 * LD + 16);
      }
#pragma unroll
      for (int j = 0; j < TL::kNT; ++j) {
        const uint32_t* wr = ws + (kk / 4 + tq) * kLDW + wn0 + j * 8 + gid;
        const uint32_t b0 = wr[0], b1 = wr[4 * kLDW];
#pragma unroll
        for (int i = 0; i < TL::kMT; ++i) mma_s8(iacc[i][j], a[i], b0, b1);
      }
      if (KIND == kW4 && ((k0 + kk + 32) & (g - 1)) == 0) {  // fold the group
        const int grp = (k0 + kk) / g;
#pragma unroll
        for (int j = 0; j < TL::kNT; ++j) {
          const int col = n0 + wn0 + j * 8 + tq * 2;
          float s0 = 0.f, s1 = 0.f;
          if (col < N) {
            s0 = __ldg(scales + (int64_t)grp * N + col);
            s1 = __ldg(scales + (int64_t)grp * N + col + 1);
          }
#pragma unroll
          for (int i = 0; i < TL::kMT; ++i)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              facc[i][j][r] += (float)iacc[i][j][r] * ((r & 1) ? s1 : s0);
              iacc[i][j][r] = 0;
            }
        }
      }
    }
    __syncthreads();
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < TL::kMT; ++i)
#pragma unroll
    for (int j = 0; j < TL::kNT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm0 + i * 16 + gid + (r >> 1) * 8;
        const int col = n0 + wn0 + j * 8 + tq * 2 + (r & 1);
        if (row >= M || col >= N) continue;
        const int64_t o = (int64_t)row * N + col;
        float v;
        if constexpr (KIND == kW8) {
          if (split) {
            static_cast<int*>(part)[(int64_t)blockIdx.z * M * N + o] = iacc[i][j][r];
            continue;
          }
          v = __fmul_rn(__fmul_rn(__int2float_rn(iacc[i][j][r]), sx[row]), scales[col]);
        } else {
          if (split) {
            static_cast<float*>(part)[(int64_t)blockIdx.z * M * N + o] = facc[i][j][r];
            continue;
          }
          v = __fmul_rn(facc[i][j][r], sx[row]);
        }
        if (out_bf16)
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v);
        else
          static_cast<float*>(out)[o] = v;
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

// k-rows per split: whole tiles (so whole groups); returns the split count.
int plan_splits(int K, int splits, int* k_per_split) {
  int kps = (K + splits - 1) / splits;
  kps = (kps + kBK - 1) / kBK * kBK;
  *k_per_split = kps;
  return (K + kps - 1) / kps;
}

template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int KIND, bool kCol, typename XT, int BM, int WARPS_M>
cudaError_t launch_float(const void* x, const void* w, const void* scales, void* out,
                         void* part, int M, int K, int N, int g, int out_bf16,
                         int splits, int kps, cudaStream_t st) {
  constexpr int kParts = sizeof(XT) == 4 ? 3 : 1;
  constexpr int smem = kParts * BM * (kBK + 8) * 2 + (kBK / 2) * kLDW * 4;
  auto kern = float_q_kernel<KIND, kCol, XT, BM, WARPS_M>;
  static const cudaError_t attr = allow_smem(kern, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const XT*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scales), out, static_cast<float*>(part), M, K, N,
      g, out_bf16, kps);
  return cudaSuccess;
}

// M <= 16: 16-row tiles and the K splits; else 64-row tiles, one split.
template <int KIND, bool kCol, typename XT>
cudaError_t launch_float_m(const void* x, const void* w, const void* scales, void* out,
                           void* part, int M, int K, int N, int g, int out_bf16,
                           int splits, int kps, cudaStream_t st) {
  if (M <= 16)
    return launch_float<KIND, kCol, XT, 16, 1>(x, w, scales, out, part, M, K, N, g, out_bf16,
                                         splits, kps, st);
  return launch_float<KIND, kCol, XT, 64, 2>(x, w, scales, out, part, M, K, N, g, out_bf16, 1,
                                       K, st);
}

template <int KIND, int BM, int WARPS_M>
cudaError_t launch_s8(const void* x, const void* sx, const void* w, const void* scales,
                      void* out, void* part, int M, int K, int N, int g,
                      int out_bf16, int splits, int kps, cudaStream_t st) {
  constexpr int smem = BM * (kBK + 16) + (kBK / 4) * kLDW * 4;
  auto kern = s8_q_kernel<KIND, BM, WARPS_M>;
  static const cudaError_t attr = allow_smem(kern, smem);
  if (attr != cudaSuccess) return attr;
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(sx),
      static_cast<const uint8_t*>(w), static_cast<const float*>(scales), out,
      part, M, K, N, g, out_bf16, kps);
  return cudaSuccess;
}

bool bad_shape(int M, int K, int N, int splits, const void* part) {
  return M < 1 || K % kBK != 0 || N % 4 != 0 || splits < 1 ||
         (splits > 1 && (!part || M > 16));
}

}  // namespace

// K6 (int4 = 1: packed halves [K/2, N] uint8, g in {32, 64, 128}), K3
// grouped (int4 = 0: int8 [K, N], same g) or K3 (int4 = 0, g = 0: scales
// [N]); x [M, K] bf16 (x_f32 = 0) or fp32; fp32 scales [K/g, N]; out
// [M, N] bf16 (out_bf16 = 1) or fp32.  splits > 1 (M <= 16 only) needs
// part: fp32 scratch of splits * M * N.
extern "C" int fatt_matmul_float_q(const void* x, const void* w, const void* scales,
                                   void* out, void* part, int M, int K, int N,
                                   int g, int int4, int x_f32, int out_bf16,
                                   int splits, void* stream) {
  if (bad_shape(M, K, N, splits, part) ||
      (g != 32 && g != 64 && g != 128 && !(g == 0 && !int4)))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  int kps;
  splits = plan_splits(K, splits, &kps);
  cudaError_t e;
#define FATT_FLOAT_Q(KIND, COL)                                                        \
  (x_f32 ? launch_float_m<KIND, COL, float>(x, w, scales, out, part, M, K, N, g, out_bf16, \
                                            splits, kps, st)                              \
         : launch_float_m<KIND, COL, __nv_bfloat16>(x, w, scales, out, part, M, K, N, g,  \
                                                    out_bf16, splits, kps, st))
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
// or bf16.  splits > 1 (M <= 16 only) needs part: splits * M * N of fp32
// (K5) or int32 (K7).
extern "C" int fatt_matmul_s8_q(const void* x, const void* sx, const void* w,
                                const void* scales, void* out, void* part, int M,
                                int K, int N, int g, int int4, int out_bf16,
                                int splits, void* stream) {
  if (bad_shape(M, K, N, splits, part) ||
      (int4 && g != 32 && g != 64 && g != 128))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  int kps;
  splits = plan_splits(K, splits, &kps);
  cudaError_t e;
  if (M <= 16) {
    e = int4 ? launch_s8<kW4, 16, 1>(x, sx, w, scales, out, part, M, K, N, g, out_bf16, splits, kps, st)
             : launch_s8<kW8, 16, 1>(x, sx, w, scales, out, part, M, K, N, g, out_bf16, splits, kps, st);
  } else {
    e = int4 ? launch_s8<kW4, 64, 2>(x, sx, w, scales, out, part, M, K, N, g, out_bf16, 1, K, st)
             : launch_s8<kW8, 64, 2>(x, sx, w, scales, out, part, M, K, N, g, out_bf16, 1, K, st);
    splits = 1;
  }
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

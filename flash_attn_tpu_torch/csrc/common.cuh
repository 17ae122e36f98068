// Shared helpers for the port's Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <atomic>

namespace fatt {

// Large-negative score for masked entries (the JAX kernels' NEG_INF): it
// exp()s to exactly 0 and keeps fully-masked rows NaN-free.
constexpr float kNegInf = -1e30f;

// KV storage types, as the wrappers pass them.
enum KvType { kBf16 = 0, kInt8 = 1, kFp8 = 2 };

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Copy primitives (sm_80+), shared by K1 and K4.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copy of 16 bytes; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

// The same for 4 bytes (through L1).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

// The same for 8 bytes (through L1).
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The widest cp.async piece, in floats, that every staged row of the
// bias plane at bb takes: 4 (16 bytes) or 2 where the keys are contiguous
// and each row starts 16- or 8-byte aligned (a stage's rows start at keys
// that are multiples of 64), else 1.
__device__ __forceinline__ int bias_piece(const float* bb, int64_t bs_q, int64_t bs_k) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(bb);
  if (bs_k != 1) return 1;
  if (a % 16 == 0 && bs_q % 4 == 0) return 4;
  if (a % 8 == 0 && bs_q % 2 == 0) return 2;
  return 1;
}

// A kR (queries) x kC (keys) fp32 tile of the bias into shared memory
// at dst, rows kPitch floats apart, by cp.async in pieces of kVec floats:
// element (r, c) from src + r bs_q + c bs_k; rows from r_live and keys from
// c_live on are zero-filled.  A thread keeps one piece's column and walks
// rows kThreads / (kC / kVec) apart, so a row's address is one add.
template <int kR, int kC, int kPitch, int kThreads, int kVec>
__device__ __forceinline__ void load_bias_vec(uint32_t dst, const float* src, int64_t bs_q,
                                              int64_t bs_k, int r_live, int c_live) {
  constexpr int kPerRow = kC / kVec, kStep = kThreads / kPerRow;
  static_assert(kThreads % kPerRow == 0 && kR % kStep == 0, "whole rounds of rows");
  const int r0 = threadIdx.x / kPerRow, c = threadIdx.x % kPerRow * kVec;
  const int bytes = 4 * max(0, min(kVec, c_live - c));
  const float* p = src + r0 * bs_q + c * bs_k;
  dst += (r0 * kPitch + c) * 4;
#pragma unroll
  for (int i = 0; i < kR / kStep; ++i, p += kStep * bs_q) {
    const int n = r0 + i * kStep < r_live ? bytes : 0;
    const uint32_t d = dst + i * kStep * kPitch * 4;
    const void* s = n ? p : src;  // a zero-filled piece reads nothing
    if constexpr (kVec == 4)
      cp_async16(d, s, n);
    else if constexpr (kVec == 2)
      cp_async8(d, s, n);
    else
      cp_async4(d, s, n);
  }
}

template <int kR, int kC, int kPitch, int kThreads>
__device__ __forceinline__ void load_bias(uint32_t dst, const float* src, int64_t bs_q,
                                          int64_t bs_k, int r_live, int c_live, int vec) {
  if (vec == 4)
    load_bias_vec<kR, kC, kPitch, kThreads, 4>(dst, src, bs_q, bs_k, r_live, c_live);
  else if (vec == 2)
    load_bias_vec<kR, kC, kPitch, kThreads, 2>(dst, src, bs_q, bs_k, r_live, c_live);
  else
    load_bias_vec<kR, kC, kPitch, kThreads, 1>(dst, src, bs_q, bs_k, r_live, c_live);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One stored KV element as float.  int8 and e4m3 values are exact in bf16,
// so this equals the JAX kernel's cast into its bf16 compute type.
template <int KV>
__device__ __forceinline__ float load_kv(const void* p, int64_t i) {
  if constexpr (KV == kBf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  } else if constexpr (KV == kInt8) {
    return static_cast<float>(static_cast<const int8_t*>(p)[i]);
  } else {
    __nv_fp8_e4m3 x;
    x.__x = static_cast<const __nv_fp8_storage_t*>(p)[i];
    return static_cast<float>(x);
  }
}

// Warpgroup products (sm_90a), shared by K4, K9, K10 and the quantized
// GEMMs.  An operand in shared memory is a tile of kRows rows in the
// 128-byte swizzle that wgmma reads: [part][row][128 bytes], 16-byte chunk
// c of row r stored at chunk (c & 7) ^ (r & 7) of part c / 8, whose 8-row
// groups lie 1024 bytes apart.  Every operand an instruction reads spans
// one swizzle atom in its contiguous dimension (K-major: 32 bytes of 128;
// N-major: 64 bf16 of 64), so only that 1024-byte stride enters the
// descriptor; the leading offset is unused.

// Byte offset of 16-byte chunk c of row r in such a tile.
template <int kRows>
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (c >> 3) * (kRows * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// The K-major operand of depth step kk (32 bytes: 16 bf16 or 32 int8) of
// such a tile.
template <int kRows>
__device__ __forceinline__ uint32_t kmajor(uint32_t tile, int kk) {
  return tile + (kk >> 2) * (kRows * 128) + (kk & 3) * 32;
}

__device__ __forceinline__ uint64_t wg_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Generic-proxy writes to shared memory (cp.async, st.shared) before the
// async proxy's reads (wgmma): each writer fences, then the block syncs.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keep the compiler from moving accumulators across an asynchronous product.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define FATT_D8(c, i)                                                                   \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), \
      c(d[i + 7])

// d (64 x N fp32, this thread's N / 2) = a (64 x 16 bf16 from registers,
// the mma.sync A layout per warp) * B (16 x N from shared memory) +
// (scale_d ? d : 0).  kTransB 0: B K-major; 1: B N-major.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : FATT_D8("+f", 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : FATT_D8("+f", 0), FATT_D8("+f", 8), FATT_D8("+f", 16), FATT_D8("+f", 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : FATT_D8("+f", 0), FATT_D8("+f", 8), FATT_D8("+f", 16), FATT_D8("+f", 24),
        FATT_D8("+f", 32), FATT_D8("+f", 40), FATT_D8("+f", 48), FATT_D8("+f", 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(kTransB));
}

// d (64 x 64 fp32, this thread's 32) = A (64 x 16, K-major in shared
// memory) * B (16 x 64, K-major in shared memory) + (scale_d ? d : 0).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FATT_D8("+f", 0), FATT_D8("+f", 8), FATT_D8("+f", 16), FATT_D8("+f", 24)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N int32) = a (64 x 32 int8 from registers, the mma.sync m16n8k32
// A layout per warp) * B (32 x N int8, K-major in shared memory) +
// (scale_d ? d : 0); exact.
__device__ __forceinline__ void wgmma_rs_s8(int (&d)[8], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : FATT_D8("+r", 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_s8(int (&d)[32], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : FATT_D8("+r", 0), FATT_D8("+r", 8), FATT_D8("+r", 16), FATT_D8("+r", 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_s8(int (&d)[64], const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : FATT_D8("+r", 0), FATT_D8("+r", 8), FATT_D8("+r", 16), FATT_D8("+r", 24),
        FATT_D8("+r", 32), FATT_D8("+r", 40), FATT_D8("+r", 48), FATT_D8("+r", 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// d (64 x N fp32, this thread's N / 2) += a (64 x 8 tf32 from registers,
// the mma.sync m16n8k8 A layout per warp) * B (8 x N tf32, K-major in
// shared memory: TF32 takes no transpose), N = 64 or 128.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : FATT_D8("+f", 0), FATT_D8("+f", 8), FATT_D8("+f", 16), FATT_D8("+f", 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : FATT_D8("+f", 0), FATT_D8("+f", 8), FATT_D8("+f", 16), FATT_D8("+f", 24),
        FATT_D8("+f", 32), FATT_D8("+f", 40), FATT_D8("+f", 48), FATT_D8("+f", 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

#undef FATT_D8

// Attention on wgmma over 64-key tiles at head dim 64 or 128 (K4 also 256),
// shared by K4 and the chunk kernel (K1c/K8c).  A warpgroup holds 64 query
// rows; warp w of it rows 16w.. , and this thread rows lane/4 and lane/4 + 8
// of those.  A K or V tile is 64 keys x D bf16 columns as D / 64 64-column
// parts in the 128-byte swizzle (sw128<64>), 8 KB each.

// S (64 x 64 fp32: s[j][e] is key 8j + 2(lane%4) + (e&1) of row lane/4 +
// 8(e>>1)) = Q K^T, Q as A fragments (qf[kk]: columns 16kk..16kk+15, kK =
// D / 16 of them), K read by descriptor from the tile at shared address kt.
template <int kK>
__device__ __forceinline__ void attn_qk(float (&s)[8][4], const uint32_t (&qf)[kK][4],
                                        uint32_t kt) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  auto& sd = reinterpret_cast<float(&)[32]>(s);
  pin(sd);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) wgmma_rs<0>(sd, qf[kk], wg_desc(kmajor<64>(kt, kk)), kk > 0);
  wg_commit();
  wg_wait_all();
  pin(sd);
}

// The four values of score block j (as attn_qk lays them out) into P's A
// fragments: pf[c] covers keys 16c..16c+15.
__device__ __forceinline__ void put_p(uint32_t (&pf)[4][4], int j, const float (&p)[4]) {
  pf[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
  pf[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
}

// O (64 x 8kN fp32: o[j] columns 8j.., rows as s) += P V, V (a tile of
// kN / 8 64-column parts) read N-major by descriptor from the tile at
// shared address vt.  kN = 8 (head dim 64), 16 (128) or 32 (256).
template <int kN>
__device__ __forceinline__ void attn_pv(float (&o)[kN][4], const uint32_t (&pf)[4][4],
                                        uint32_t vt) {
  constexpr int kParts = kN / 8;
#pragma unroll
  for (int p = 0; p < kParts; ++p) pin(reinterpret_cast<float(&)[32]>(o[8 * p]));
  wg_fence();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int p = 0; p < kParts; ++p)
      wgmma_rs<1>(reinterpret_cast<float(&)[32]>(o[8 * p]), pf[kc],
                  wg_desc(vt + p * 64 * 128 + kc * 16 * 128), 1);
  }
  wg_commit();
  wg_wait_all();
#pragma unroll
  for (int p = 0; p < kParts; ++p) pin(reinterpret_cast<float(&)[32]>(o[8 * p]));
}

// tanh(x) as 1 - 2 / (2^(2x log2 e) + 1): exp2f and a fast reciprocal, the
// Gemma-2 logit softcap of K4 and its recompute in K9/K10 (one tanh for
// both, so the backward's P rows sum to 1 against the forward's lse).
// |x| is clamped to 9, where tanh rounds to +-1 in fp32, so 2^(...) stays
// finite.
__device__ __forceinline__ float tanh_exp2(float x) {
  const float e = exp2f(fminf(fmaxf(x, -9.f), 9.f) * 2.8853900817779268f);
  return 1.f - __fdividef(2.f, e + 1.f);
}

// Dropout: the JAX package's counter-based keep mask (flash_attn_tpu/ops/
// flash_fwd.py:_mix_seed, dropout_keep_mask), an integer hash of the seed,
// the batch index b, the query head h and the element's absolute (row,
// column), kept where its 32 bits are >= threshold = min(rate 2^32,
// 2^32 - 1).  JAX computes it in int32 with wraparound and logical shifts,
// which are these uint32 operations bit for bit, so K4, K9 and K10 replay
// one mask whatever their tiles.  About 10 integer operations an element.
__device__ __forceinline__ uint32_t drop_mix(uint32_t seed, int b, int h) {
  return seed ^ ((uint32_t)b * 0x9E3779B1u) ^ ((uint32_t)h * 0x85EBCA77u);
}

// The row's part of the hash's sum: mix + row * m1.
__device__ __forceinline__ uint32_t drop_row(uint32_t mix, int row) {
  return mix + (uint32_t)row * 0x9E3779B9u;
}

__device__ __forceinline__ bool drop_keep(uint32_t row_part, int col, uint32_t threshold) {
  uint32_t x = row_part + (uint32_t)col * 0x7FEB352Du;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= threshold;
}

// Reductions over the four threads (a quad) that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The split-KV combine of one row by one warp (K1m's arithmetic, also the
// merge at the end of K8): partials out_i [n, rows, D] fp32 and lse_i
// [n, rows] fp32 over disjoint key sets give
//     lse = logsumexp_i(lse_i),  out = sum_i exp(lse_i - lse) * out_i
// for row r, as ops/lse.py:lse_merge forms them: partials at -inf or at the
// kernels' finite -1e30 weigh exp(lse_i - lse) (0 beside a live partial; a
// row whose partials are all -1e30 sums them with weight 1, all zeros); a
// row whose partials are all -inf gives lse -inf and out 0.  The lanes
// read the row's LSE values together and pass them round by shuffles, then
// each lane merges 4 consecutive columns per 128 with 16-byte loads, eight
// partials in flight.  The loads go through L2 (ld.global.cg), so a block
// that merges partials other blocks of its grid wrote never reads a stale
// L1 line.  All 32 lanes of the warp call it for one row; D % 4 == 0.
template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 x);

template <>
__device__ __forceinline__ void store4<float>(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* dst, float4 x) {
  uint2 w;
  w.x = pack_bf16(x.x, x.y);
  w.y = pack_bf16(x.z, x.w);
  *reinterpret_cast<uint2*>(dst) = w;
}

template <typename T>
__device__ __forceinline__ void merge_row(const float* part_out, const float* part_lse, T* out,
                                          float* lse, int n, int64_t rows, int64_t r, int D,
                                          int lane) {
  // lse_i sits in lane i % 32 of the chunk of 32 from i - i % 32 (all
  // loads of a chunk in flight at once); the sums below still run i = 0,
  // 1, ... n - 1 in order.
  auto chunk = [&](int i0) {
    const int i = i0 + lane;
    return i < n ? __ldcg(part_lse + i * rows + r) : -CUDART_INF_F;
  };
  const float first = chunk(0);
  // the first eight partials' columns load beside the LSE values
  float4 x0[8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
    x0[u] = u < n && lane * 4 < D
                ? __ldcg(reinterpret_cast<const float4*>(part_out + (u * rows + r) * D + lane * 4))
                : make_float4(0.f, 0.f, 0.f, 0.f);
  // logsumexp as torch forms it: the max, then log of the shifted sum; an
  // all -inf row stays -inf.
  float m = -CUDART_INF_F;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const float mine = i0 == 0 ? first : chunk(i0);
    for (int j = 0; j < min(32, n - i0); ++j) m = fmaxf(m, __shfl_sync(0xffffffffu, mine, j));
  }
  float total = -CUDART_INF_F;
  if (m != -CUDART_INF_F) {
    float s = 0.f;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const float mine = i0 == 0 ? first : chunk(i0);
      for (int j = 0; j < min(32, n - i0); ++j) s += expf(__shfl_sync(0xffffffffu, mine, j) - m);
    }
    total = m + logf(s);
  }
  const float safe = isfinite(total) ? total : 0.f;
  for (int c0 = 0; c0 < D; c0 += 128) {
    const int c = c0 + lane * 4;
    const bool in = c < D;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i0 = 0; i0 < n; i0 += 32) {
      const float mine = i0 == 0 ? first : chunk(i0);
      const float w_mine = isfinite(mine) ? expf(mine - safe) : 0.f;
      const int cnt = min(32, n - i0);
      // eight partials' loads in flight, then their sums in order
      for (int j0 = 0; j0 < cnt; j0 += 8) {
        float4 x[8];
        float w[8];
        const bool loaded = c0 == 0 && i0 == 0 && j0 == 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = j0 + u;
          w[u] = __shfl_sync(0xffffffffu, w_mine, j & 31);
          x[u] = loaded ? x0[u]
                 : in && j < cnt ? __ldcg(reinterpret_cast<const float4*>(
                                       part_out + ((i0 + j) * rows + r) * D + c))
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (j0 + u < cnt) {
            acc.x += x[u].x * w[u];
            acc.y += x[u].y * w[u];
            acc.z += x[u].z * w[u];
            acc.w += x[u].w * w[u];
          }
        }
      }
    }
    if (in) store4<T>(out + r * D + c, acc);
  }
  if (lane == 0) lse[r] = total;
}

// Host side.  A kernel's dynamic shared-memory limit is raised once on each
// device, not before every launch: a launcher keeps one SmemLimitSet (a
// function-local static, so one for each kernel instance) and calls
// smem_limit_once before its launch.  Two first calls that race only repeat
// the same attribute call.
constexpr int kMaxDevices = 64;
using SmemLimitSet = std::atomic<bool>[kMaxDevices];

template <typename Kernel>
inline cudaError_t smem_limit_once(Kernel kernel, int bytes, SmemLimitSet& set) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev >= 0 && dev < kMaxDevices;
  if (kept && set[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && kept) set[dev].store(true, std::memory_order_relaxed);
  return e;
}

}  // namespace fatt

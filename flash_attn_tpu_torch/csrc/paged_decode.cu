// K8: attention over a paged KV pool (bf16, int8 or fp8-e4m3 pages with
// per-(page row, head) fp32 scales) through a block table, in decode mode:
// one query token per sequence, at most 16 query heads per KV head.  Chunk
// mode (T query tokens per sequence) and decode calls with more heads per
// KV head run on the chunk kernel, K8c (csrc/chunk_attn.cu).
//
// Replaces flash_attn_tpu/ops/paged_decode.py:_paged_decode_kernel in
// decode mode (paged_flash_decode).
//
// Bound on the H100: bytes, like K1: every live page row of K and V is
// needed once, for 4 flops per element per query row.  The design:
//   * one block per (sequence, KV head, KV split).  All query rows of a KV
//     head share each K/V tile, so a page row is read from device memory
//     once;
//   * the block reads its sequence's page ids from the block table (the
//     counterpart of the TPU's scalar prefetch) and walks 64-key tiles,
//     which never straddle a page, up to kv_len and never past the table's
//     reach (max_pages * page), so an idle slot whose length ran past its
//     capacity reads only its own entries;
//   * int8 and e4m3 K/V convert exactly to bf16 while they are staged in
//     shared memory; scores are scaled by the K scale per column after
//     QK^T and p by the V scale (then rounded to bf16) before PV, as on
//     the TPU;
//   * QK^T and PV run on the tensor cores (WMMA bf16, fp32 accumulate).
//     The rows are padded to one 16-row tile and the four warps split the
//     keys (QK^T) and the head dim (PV).  The softmax runs on fp32 scores
//     in shared memory, each row's statistics held by the threads that own
//     its columns;
//   * a split-KV grid axis cuts the walk so that 64 (sequence, KV head)
//     blocks at batch 8 become enough to fill 132 SMs; each split writes
//     an fp32 (out, lse) partial merged with the LSE rule (ops/lse.py).
// Clamped mode drops the running max (p = 2^min(s, clamp2), base-2 scores
// with log2(e) folded into the q pre-scale); online mode keeps natural
// units, as K1 does.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using fatt::kNegInf;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;        // keys per tile
constexpr int kD = 128;        // head dim
constexpr int kLd = kD + 8;    // bf16 stride of the Q/K/V tiles
constexpr int kSLd = kBK + 4;  // fp32 stride of the scores
constexpr int kPLd = kBK + 8;  // bf16 stride of p
constexpr int kOLd = kD + 4;   // fp32 stride of the accumulator

// One 16-row group per block.
struct Tile {
  static constexpr int kRows = 16;
  static constexpr int kCW = kWarps;             // warps per row group
  static constexpr int kJPW = kBK / 16 / kCW;    // 16-key blocks per warp
  static constexpr int kNPW = kD / 16 / kCW;     // 16-column blocks per warp
  static constexpr int kTPR = kThreads / kRows;  // threads per row
  static constexpr int kCPT = kBK / kTPR;        // score columns per thread
  static constexpr int kDPT = kD / kTPR;         // output columns per thread
  static constexpr size_t kQ = 0;
  static constexpr size_t kK = kQ + (size_t)kRows * kLd * 2;
  static constexpr size_t kV = kK + (size_t)kBK * kLd * 2;
  static constexpr size_t kS = kV + (size_t)kBK * kLd * 2;
  static constexpr size_t kP = kS + (size_t)kRows * kSLd * 4;
  static constexpr size_t kO = kP + (size_t)kRows * kPLd * 2;
  static constexpr size_t kSc = kO + (size_t)kRows * kOLd * 4;
  static constexpr size_t kBytes = kSc + 2 * kBK * 4;
};

// Reduce across the kTPR consecutive lanes that own one row.
template <int TPR>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int KV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pages,
    const void* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ block_table,
    const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ out,
    float* __restrict__ part_out, float* __restrict__ part_lse, int B, int Hk,
    int R, int page, int max_pages, int split_len, float qscale, int clamped,
    float clamp2) {
  using L = Tile;
  extern __shared__ __align__(128) unsigned char smem[];
  auto Qs = reinterpret_cast<__nv_bfloat16*>(smem + L::kQ);
  auto Ks = reinterpret_cast<__nv_bfloat16*>(smem + L::kK);
  auto Vs = reinterpret_cast<__nv_bfloat16*>(smem + L::kV);
  auto Ss = reinterpret_cast<float*>(smem + L::kS);
  auto Ps = reinterpret_cast<__nv_bfloat16*>(smem + L::kP);
  auto Os = reinterpret_cast<float*>(smem + L::kO);
  auto ks_s = reinterpret_cast<float*>(smem + L::kSc);
  auto vs_s = ks_s + kBK;

  const int b = blockIdx.x / Hk, hk = blockIdx.x % Hk;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int cw = warp;
  const int len = kv_len[b];
  const int64_t qrow0 = ((int64_t)b * Hk + hk) * R;  // query head of row 0

  // q pre-scaled in bf16, as the TPU kernel folds the softmax scale into
  // its q block (qscale is already rounded to bf16); rows past R are 0.
  for (int i = tid; i < L::kRows * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    float x = 0.f;
    if (r < R) x = fatt::bf16_round(__bfloat162float(q[(qrow0 + r) * kD + d]) * qscale);
    Qs[r * kLd + d] = __float2bfloat16(x);
    Os[r * kOLd + d] = 0.f;
  }

  // This thread's row and its slice of the score and output columns.
  const int my_row = tid / L::kTPR, part = tid % L::kTPR;
  // every row sees kv_len positions; padding rows see nothing
  const int limit = my_row < R ? len : 0;
  // the walk ends at kv_len, and at the table's reach
  const int walk_end = min(len, max_pages * page);
  const int lo = split * split_len;
  const int hi = min(lo + split_len, walk_end);
  float m_run = kNegInf, l_run = 0.f;
  const unsigned char* kb = static_cast<const unsigned char*>(k_pages);
  const unsigned char* vb = static_cast<const unsigned char*>(v_pages);

  for (int t0 = lo; t0 < hi; t0 += kBK) {
    const int nvalid = min(kBK, hi - t0);
    const int pid = block_table[(int64_t)b * max_pages + t0 / page];
    const int64_t row_base = ((int64_t)pid * Hk + hk) * page + t0 % page;
    __syncthreads();  // the previous tile is consumed; Q/O are set
    // Stage K and V as bf16 (rows past nvalid are zero, so no stale bits
    // reach the products).
    if constexpr (KV == fatt::kBf16) {
      const auto* k16 = static_cast<const __nv_bfloat16*>(k_pages);
      const auto* v16 = static_cast<const __nv_bfloat16*>(v_pages);
      for (int i = tid; i < kBK * kD / 8; i += kThreads) {
        const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
        uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
        if (r < nvalid) {
          const int64_t off = (row_base + r) * kD + c;
          kv4 = *reinterpret_cast<const uint4*>(k16 + off);
          vv4 = *reinterpret_cast<const uint4*>(v16 + off);
        }
        *reinterpret_cast<uint4*>(Ks + r * kLd + c) = kv4;
        *reinterpret_cast<uint4*>(Vs + r * kLd + c) = vv4;
      }
    } else {
      for (int i = tid; i < kBK * kD / 16; i += kThreads) {
        const int r = i / (kD / 16), c = (i % (kD / 16)) * 16;
        uint4 kraw = make_uint4(0, 0, 0, 0), vraw = make_uint4(0, 0, 0, 0);
        if (r < nvalid) {
          const int64_t off = (row_base + r) * kD + c;
          kraw = *reinterpret_cast<const uint4*>(kb + off);
          vraw = *reinterpret_cast<const uint4*>(vb + off);
        }
        __align__(16) __nv_bfloat16 kt[16], vt[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          kt[e] = __float2bfloat16(fatt::load_kv<KV>(&kraw, e));
          vt[e] = __float2bfloat16(fatt::load_kv<KV>(&vraw, e));
        }
        *reinterpret_cast<uint4*>(Ks + r * kLd + c) = *reinterpret_cast<uint4*>(kt);
        *reinterpret_cast<uint4*>(Ks + r * kLd + c + 8) = *reinterpret_cast<uint4*>(kt + 8);
        *reinterpret_cast<uint4*>(Vs + r * kLd + c) = *reinterpret_cast<uint4*>(vt);
        *reinterpret_cast<uint4*>(Vs + r * kLd + c + 8) = *reinterpret_cast<uint4*>(vt + 8);
      }
    }
    if (tid < kBK) {
      const bool in = KV != fatt::kBf16 && tid < nvalid;
      ks_s[tid] = in ? k_scale[row_base + tid] : 1.f;
      vs_s[tid] = in ? v_scale[row_base + tid] : 1.f;
    }
    __syncthreads();

    // S = Q K^T: warp cw takes its 16-key blocks.
#pragma unroll
    for (int jj = 0; jj < L::kJPW; ++jj) {
      const int j = cw * L::kJPW + jj;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, Qs + kk, kLd);
        wmma::load_matrix_sync(bt, Ks + j * 16 * kLd + kk, kLd);
        wmma::mma_sync(sf, a, bt, sf);
      }
      wmma::store_matrix_sync(Ss + j * 16, sf, kSLd, wmma::mem_row_major);
    }
    __syncthreads();

    // Softmax on this thread's columns of its row: K scale, causal mask,
    // then p * v_scale rounded to bf16 for the PV product.
    const int c0 = part * L::kCPT;
    const int cmax = min(limit, t0 + nvalid);  // columns from here are masked
    float* srow = Ss + my_row * kSLd + c0;
    float mx = kNegInf;
#pragma unroll 8
    for (int c = 0; c < L::kCPT; ++c) {
      float s = srow[c] * ks_s[c0 + c];
      if (t0 + c0 + c >= cmax) s = kNegInf;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    float alpha = 1.f, m_new = 0.f;
    if (!clamped) {
      m_new = fmaxf(m_run, row_max<L::kTPR>(mx));
      alpha = expf(m_run - m_new);
      m_run = m_new;
    }
    float psum = 0.f;
    __nv_bfloat16* prow = Ps + my_row * kPLd + c0;
#pragma unroll 8
    for (int c = 0; c < L::kCPT; ++c) {
      const float p = clamped ? exp2f(fminf(srow[c], clamp2)) : expf(srow[c] - m_new);
      psum += p;
      prow[c] = __float2bfloat16(p * vs_s[c0 + c]);
    }
    l_run = l_run * alpha + row_sum<L::kTPR>(psum);
    if (!clamped) {
      float* orow = Os + my_row * kOLd + part * L::kDPT;
#pragma unroll 8
      for (int c = 0; c < L::kDPT; ++c) orow[c] *= alpha;
    }
    __syncthreads();

    // O += P V: warp cw takes its 16-column blocks, accumulated through
    // shared memory.
#pragma unroll
    for (int nn = 0; nn < L::kNPW; ++nn) {
      const int n = cw * L::kNPW + nn;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      float* optr = Os + n * 16;
      wmma::load_matrix_sync(of, optr, kOLd, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
        wmma::load_matrix_sync(a, Ps + kk, kPLd);
        wmma::load_matrix_sync(bv, Vs + kk * kLd + n * 16, kLd);
        wmma::mma_sync(of, a, bv, of);
      }
      wmma::store_matrix_sync(optr, of, kOLd, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // Finalize: a row is valid iff some unmasked score was seen.
  if (my_row < R) {
    const bool valid = l_run > 0.f && (clamped || m_run > kNegInf / 2);
    const int64_t h = qrow0 + my_row;
    const float* orow = Os + my_row * kOLd + part * L::kDPT;
    const int64_t rows = (int64_t)B * Hk * R;
    for (int c = 0; c < L::kDPT; ++c) {
      const float o = valid ? orow[c] / l_run : 0.f;
      const int64_t idx = h * kD + part * L::kDPT + c;
      if (nsplit == 1) {
        out[idx] = __float2bfloat16(o);
      } else {
        part_out[split * rows * kD + idx] = o;
      }
    }
    if (part == 0) {
      const float lse = valid ? (clamped ? logf(l_run) : m_run + logf(l_run)) : kNegInf;
      part_lse[split * rows + h] = lse;
    }
  }
}

template <int KV>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, const void* table, const void* kv_len, void* out,
           void* part_out, void* part_lse, int B, int Hk, int R, int page,
           int max_pages, int num_splits, int split_len, float qscale,
           int clamped, float clamp2, cudaStream_t st) {
  const size_t bytes = Tile::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * Hk, num_splits);
  paged_decode_kernel<KV><<<grid, kThreads, bytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(table),
      static_cast<const int*>(kv_len), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part_out), static_cast<float*>(part_lse), B, Hk, R,
      page, max_pages, split_len, qscale, clamped, clamp2);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, Hk * R, D] bf16, R = H / Hk <= 16 rows per KV head; pages
// [P, Hk, page, D]; scales [P, Hk, page] fp32
// (null for bf16 pages); block_table [B, max_pages] int32; kv_len [B]
// int32.  One split writes out [B, Hk * R, D] bf16, several write fp32
// partials part_out [n, B, Hk * R, D]; part_lse [n, B, Hk * R] always.
extern "C" int fatt_paged_decode(const void* q, const void* k, const void* v,
                                 const void* ks, const void* vs,
                                 const void* table, const void* kv_len,
                                 void* out, void* part_out, void* part_lse,
                                 int B, int Hk, int R, int page, int max_pages,
                                 int D, int kv_type, int num_splits,
                                 int split_len, float qscale, int clamped,
                                 float clamp2, void* stream) {
  if (D != kD || R < 1 || R > Tile::kRows || page % kBK != 0 || num_splits < 1 ||
      split_len % kBK != 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (kv_type) {
    case fatt::kBf16:
      return launch<fatt::kBf16>(q, k, v, ks, vs, table, kv_len, out, part_out,
                                  part_lse, B, Hk, R, page, max_pages, num_splits,
                                  split_len, qscale, clamped, clamp2, st);
    case fatt::kInt8:
      return launch<fatt::kInt8>(q, k, v, ks, vs, table, kv_len, out, part_out,
                                  part_lse, B, Hk, R, page, max_pages, num_splits,
                                  split_len, qscale, clamped, clamp2, st);
    case fatt::kFp8:
      return launch<fatt::kFp8>(q, k, v, ks, vs, table, kv_len, out, part_out,
                                  part_lse, B, Hk, R, page, max_pages, num_splits,
                                  split_len, qscale, clamped, clamp2, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

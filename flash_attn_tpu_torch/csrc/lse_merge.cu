// K1m: the split-KV combine.  Partials out_i [n, rows, D] fp32 and lse_i
// [n, rows] fp32 over disjoint key sets merge by the LSE rule
//     lse = logsumexp_i(lse_i),  out = sum_i exp(lse_i - lse) * out_i
// into out [rows, D] (bf16 or fp32) and lse [rows] fp32, in one launch.
// K1 (over a BHSD or BSHD cache) and the chunk kernel (as K1c and K8c)
// merge their split-KV partials through it; K8 merges its own at the end of
// its walk with the same row merge.
//
// Replaces the eager flash_attn_tpu_torch/ops/lse.py:lse_merge on CUDA
// tensors; the JAX package leaves the same merge to XLA
// (flash_attn_tpu/ops/lse.py), so there is no Pallas kernel behind it.
//
// Bound on the H100: bytes.  It reads each partial once (n*rows*(D+1)*4
// bytes) and writes the result once, with 2 flops per partial element.
// One warp per row, through fatt::merge_row (common.cuh), the merge K8
// also runs at the end of its walk: the lanes read the row's n LSE values
// together, then each lane merges 4 consecutive columns per 128 with
// 16-byte loads, eight partials in flight, so a warp reads 512 contiguous
// bytes of a partial at a time.  The arithmetic is lse_merge's, case for
// case.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;

template <typename T>
__global__ void __launch_bounds__(kThreads) lse_merge_kernel(
    const float* __restrict__ part_out, const float* __restrict__ part_lse,
    T* __restrict__ out, float* __restrict__ lse, int n, int64_t rows, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (r >= rows) return;
  fatt::merge_row(part_out, part_lse, out, lse, n, rows, r, D, lane);
}

}  // namespace

// part_out [n, rows, D] fp32, part_lse [n, rows] fp32 -> out [rows, D]
// (out_fp32 1: fp32, 0: bf16), lse [rows] fp32.  D % 4 == 0.
extern "C" int fatt_lse_merge(const void* part_out, const void* part_lse,
                              void* out, void* lse, int n, int64_t rows, int D,
                              int out_fp32, void* stream) {
  if (n < 1 || rows < 1 || D < 4 || D % 4 != 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto po = static_cast<const float*>(part_out);
  const auto pl = static_cast<const float*>(part_lse);
  if (out_fp32) {
    lse_merge_kernel<float><<<(unsigned)blocks, kThreads, 0, st>>>(
        po, pl, static_cast<float*>(out), static_cast<float*>(lse), n, rows, D);
  } else {
    lse_merge_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, st>>>(
        po, pl, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), n, rows, D);
  }
  return (int)cudaGetLastError();
}

// K11: ring attention, the whole ring of n ranks in one cooperative launch.
//
// Replaces flash_attn_tpu/parallel/rdma_ring.py:_kernel (B11, its
// pallas_call at :239): each rank r holds queries q_r [B, S, H, D] and a KV
// shard k_r, v_r [B, S, Hk, D]; out_r is the softmax of q_r k^T * scale over
// all n shards, times v, in fp32 (inputs taken to fp32, products in full
// fp32), written back in q's dtype.  Causal means the contiguous layout:
// earlier shards in full, the diagonal shard causal, later shards dead.
//
// The TPU runs one pallas_call a device with the ring step as its outer
// grid axis and pushes the KV shard to the right neighbour with a remote
// DMA under the step's compute.  Here the ranks are logical ranks of one
// card and the rank is a coordinate of the work: one launch runs every
// rank.  Each rank has two fp32 KV slots in device memory ([2 slots, 2 (k,
// v), B, S, Hk, D], JAX's VMEM double buffer); slot 0 is staged from the
// local shard.  At step t (cur = t % 2) each rank's slot cur is copied into
// the right neighbour's slot 1 - cur by the blocks themselves, in chunks of
// 64 KB, before they compute on slot cur.  Counters in global memory keep
// JAX's protocol (rdma_ring.py:85-136), each raised with a release (every
// thread's __threadfence, the barrier, one atomicAdd) and awaited with an
// acquire spin of one thread before a barrier:
//   arrive[r][t]  chunks of rank r's step-t slot written (staged at t = 0,
//                 pushed from rank r - 1 at step t - 1);
//   done[r][t]    rank r's work items of step t finished and its step-t
//                 push chunks copied: everything that reads rank r's slot
//                 (t % 2) at step t.
// A push at step t waits arrive[src][t] (its source slot is whole) and
// done[dst][t - 1] (the slot it overwrites is no longer read: the
// neighbour's compute and its own push of step t - 1, JAX's send drain and
// neighbour barrier); a work item waits arrive[r][t].  Every block walks its
// tasks in the order (step, staging < pushes < items), and every wait is on
// tasks earlier in that order, so with every block resident (a cooperative
// launch, sized by the occupancy) nothing deadlocks.  The counters are
// zeroed on the stream before each launch; slots are read with ld.global.cg
// (L2), so no block sees a stale L1 line of a slot written again.  A wait
// that lasts 20 s traps, so that a protocol fault fails the launch instead
// of hanging the card.
//
// A work item is 64 query rows of one (rank, batch, head); the same block
// takes the same items at every step, so its fp32 accumulators and LSE,
// kept in device memory between steps (JAX keeps them in VMEM scratch),
// are read and written only by it.  Within a step the item streams 64-key
// tiles of K and V through shared memory with an online softmax (row max,
// row sum, unnormalised O in registers); at the end of the step it merges
// (m + log l, O) into the running (lse, acc) by rdma_ring.py:168-201 case
// for case: a dead row or a skipped step adds exactly nothing and no
// exp(-inf - -inf) is formed.  The last step writes out_r.
//
// Bound on the H100: operations.  4 * D flops a live (query, key) pair in
// fp32 on the CUDA cores (67 TFLOP/s), against reading q, k, v and writing
// out once.  Each thread computes a 4 x 4 block of S and a 4 x D/16 block
// of O from 16-byte shared-memory loads (8 FMAs a load for S, 10.7 for PV).
// Tensor cores (TF32 would change the function) and a producer warp are for
// later.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;            // query rows a work item
constexpr int kKeys = 64;            // keys a tile
constexpr int kChunk = 16384;        // floats a staging or push task (64 KB)

struct Args {
  const void* const* q;              // n pointers, [B, S, H, D] each
  const void* const* k;              // n pointers, [B, S, Hk, D]
  const void* const* v;
  void* const* out;                  // n pointers, [B, S, H, D]
  float* slots;                      // [n, 2, 2, B, S, Hk, D]
  float* acc;                        // [n, B, H, S, D]
  float* lse;                        // [n, B, H, S]
  unsigned* arrive;                  // [n, n]
  unsigned* done;                    // [n, n]
  int n, B, S, H, Hk, causal;
  float scale;
};

template <int D>
constexpr int smem_floats() {
  // Q and K tiles row-major with 4 floats of padding a row, V unpadded;
  // P (64 x 68) reuses K's tile once S is computed
  return 2 * kRows * (D + 4) + kKeys * D;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A wait that has not ended after kWaitNs traps: the launch fails and the
// wrapper raises, where a protocol fault would otherwise hang the card.
constexpr uint64_t kWaitNs = 20ull * 1000 * 1000 * 1000;

__device__ __forceinline__ void wait_ge(const unsigned* p, unsigned want) {
  if (threadIdx.x == 0) {
    const uint64_t t0 = global_ns();
    unsigned v;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
      if (v >= want) break;
      if (global_ns() - t0 > kWaitNs) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void release_add(unsigned* p) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(p, 1u);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

// Stage rank r's local shard (k then v, cast to fp32) into its slot 0:
// floats [c * kChunk, (c + 1) * kChunk) of the slot.
template <typename T>
__device__ void stage(const Args& a, int r, int c, int64_t kv_elems) {
  float* dst = a.slots + (int64_t)r * 2 * 2 * kv_elems;
  const T* k = static_cast<const T*>(a.k[r]);
  const T* v = static_cast<const T*>(a.v[r]);
  const int64_t end = (int64_t)(c + 1) * kChunk < 2 * kv_elems ? (int64_t)(c + 1) * kChunk
                                                                : 2 * kv_elems;
  for (int64_t e = (int64_t)c * kChunk + threadIdx.x * 4; e < end; e += kThreads * 4) {
    const float4 x = e < kv_elems ? load4(k + e) : load4(v + (e - kv_elems));
    __stcg(reinterpret_cast<float4*>(dst + e), x);
  }
}

// Push chunk c of rank r's slot ``cur`` into rank dst's slot 1 - cur.
__device__ void push(const Args& a, int r, int dst, int cur, int c, int64_t kv_elems) {
  const float* from = a.slots + ((int64_t)r * 2 + cur) * 2 * kv_elems;
  float* to = a.slots + ((int64_t)dst * 2 + (cur ^ 1)) * 2 * kv_elems;
  const int64_t end = (int64_t)(c + 1) * kChunk < 2 * kv_elems ? (int64_t)(c + 1) * kChunk
                                                                : 2 * kv_elems;
  for (int64_t e = (int64_t)c * kChunk + threadIdx.x * 4; e < end; e += kThreads * 4)
    __stcg(reinterpret_cast<float4*>(to + e), __ldcg(reinterpret_cast<const float4*>(from + e)));
}

// One work item at step t: rows [r0, r0 + 64) of (rank r, batch b, head h)
// against rank r's slot ``cur`` (source shard src), merged into acc / lse.
template <int D, typename T>
__device__ void attend(const Args& a, float* smem, int t, int cur, int r, int b, int h, int r0,
                       bool live, bool diag, int64_t kv_elems) {
  constexpr int QS = D + 4;          // padded row stride of the Q and K tiles
  constexpr int PS = kKeys + 4;      // padded row stride of P
  constexpr int C4 = D / 64;         // float4 column groups a thread holds in O
  float* qs = smem;
  float* ks = qs + kRows * QS;
  float* vs = ks + kKeys * QS;
  float* ps = ks;                    // P reuses K's tile
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int S = a.S, H = a.H;
  const int64_t row_base = (((int64_t)r * a.B + b) * H + h) * S;  // into acc / lse rows
  const bool last = t == a.n - 1;

  float o[4][C4][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][c][e] = 0.f;
  }

  if (live) {
    const T* q = static_cast<const T*>(a.q[r]);
    // Q tile, fp32, rows past S zero
    for (int idx = tid; idx < kRows * (D / 4); idx += kThreads) {
      const int i = idx / (D / 4), d4 = idx % (D / 4);
      const int row = r0 + i;
      const float4 x = row < S ? load4(q + (((int64_t)b * S + row) * H + h) * D + d4 * 4)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      store4(qs + i * QS + d4 * 4, x);
    }
    const int hk = h / (H / a.Hk);
    const float* kslot = a.slots + ((int64_t)r * 2 + cur) * 2 * kv_elems;
    const float* vslot = kslot + kv_elems;
    const int tiles = diag ? min((r0 + kRows - 1) / kKeys + 1, (S + kKeys - 1) / kKeys)
                           : (S + kKeys - 1) / kKeys;
    for (int tile = 0; tile < tiles; ++tile) {
      const int k0 = tile * kKeys;
      __syncthreads();  // the previous tile's P and V are read
      for (int idx = tid; idx < kKeys * (D / 4); idx += kThreads) {
        const int j = idx / (D / 4), d4 = idx % (D / 4);
        const int key = k0 + j;
        float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
        if (key < S) {
          const int64_t off = (((int64_t)b * S + key) * a.Hk + hk) * D + d4 * 4;
          kx = __ldcg(reinterpret_cast<const float4*>(kslot + off));
          vx = __ldcg(reinterpret_cast<const float4*>(vslot + off));
        }
        store4(ks + j * QS + d4 * 4, kx);
        store4(vs + j * D + d4 * 4, vx);
      }
      __syncthreads();
      // S = Q K^T: rows ty + 16 i, keys tx + 16 j
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 qa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = load4(qs + (ty + 16 * i) * QS + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 kb = load4(ks + (tx + 16 * j) * QS + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = fmaf(qa[i].x, kb.x, s[i][j]);
            s[i][j] = fmaf(qa[i].y, kb.y, s[i][j]);
            s[i][j] = fmaf(qa[i].z, kb.z, s[i][j]);
            s[i][j] = fmaf(qa[i].w, kb.w, s[i][j]);
          }
        }
      }
      // mask, online softmax; a row's 64 keys lie in the 16 lanes of its ty
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + ty + 16 * i;
        float mt = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int key = k0 + tx + 16 * j;
          const bool dead = key >= S || (diag && key > row);
          s[i][j] = dead ? -CUDART_INF_F : s[i][j] * a.scale;
          mt = fmaxf(mt, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float mn = fmaxf(m[i], mt);
        const bool any = mn > -CUDART_INF_F;
        const float alpha = any && m[i] > -CUDART_INF_F ? expf(m[i] - mn) : (any ? 0.f : 1.f);
        float ls = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[i][j] = any && s[i][j] > -CUDART_INF_F ? expf(s[i][j] - mn) : 0.f;
          ls += p[i][j];
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) ls += __shfl_xor_sync(0xffffffffu, ls, off);
        l[i] = l[i] * alpha + ls;
        m[i] = mn;
#pragma unroll
        for (int c = 0; c < C4; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][c][e] *= alpha;
      }
      __syncthreads();  // every thread is done with K
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[(ty + 16 * i) * PS + tx + 16 * j] = p[i][j];
      __syncthreads();
      // O += P V: rows ty + 16 i, columns tx * 4 + 64 c
#pragma unroll 2
      for (int j = 0; j < kKeys; j += 4) {
        float4 pa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[i] = load4(ps + (ty + 16 * i) * PS + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int c = 0; c < C4; ++c) {
            const float4 vb = load4(vs + (j + jj) * D + tx * 4 + 64 * c);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pv = jj == 0 ? pa[i].x : jj == 1 ? pa[i].y : jj == 2 ? pa[i].z : pa[i].w;
              o[i][c][0] = fmaf(pv, vb.x, o[i][c][0]);
              o[i][c][1] = fmaf(pv, vb.y, o[i][c][1]);
              o[i][c][2] = fmaf(pv, vb.z, o[i][c][2]);
              o[i][c][3] = fmaf(pv, vb.w, o[i][c][3]);
            }
          }
        }
      }
    }
  }

  // merge into (lse, acc) by rdma_ring.py:168-201; write out at the last step
  T* out = static_cast<T*>(a.out[r]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= S) continue;
    const int64_t ar = row_base + row;
    const float lse_prev = t == 0 ? -CUDART_INF_F : a.lse[ar];
    const bool step_live = live && m[i] > -CUDART_INF_F && l[i] > 0.f;
    const float lse_i = step_live ? m[i] + logf(l[i]) : -CUDART_INF_F;
    float lse_new = lse_prev, w_prev = 1.f, w_i = 0.f;
    if (step_live) {
      const float hi = fmaxf(lse_prev, lse_i), lo = fminf(lse_prev, lse_i);
      lse_new = hi + log1pf(expf(lo - hi));
      w_prev = lse_prev > -CUDART_INF_F ? expf(lse_prev - lse_new) : 0.f;
      w_i = expf(m[i] - lse_new);
    }
#pragma unroll
    for (int c = 0; c < C4; ++c) {
      const int col = tx * 4 + 64 * c;
      float4 prev = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t > 0) prev = load4(a.acc + ar * D + col);
      const float4 x = make_float4(prev.x * w_prev + o[i][c][0] * w_i,
                                   prev.y * w_prev + o[i][c][1] * w_i,
                                   prev.z * w_prev + o[i][c][2] * w_i,
                                   prev.w * w_prev + o[i][c][3] * w_i);
      if (last)
        store4(out + (((int64_t)b * S + row) * H + h) * D + col, x);
      else
        store4(a.acc + ar * D + col, x);
    }
    if (!last && tx == 0) a.lse[ar] = lse_new;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2) ring_attn_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = a.n;
  const int64_t kv_elems = (int64_t)a.B * a.S * a.Hk * D;
  const int chunks = (int)((2 * kv_elems + kChunk - 1) / kChunk);
  const int nqb = (a.S + kRows - 1) / kRows;
  const int per_rank = a.B * a.H * nqb;
  const int items = n * per_rank;
  const int G = gridDim.x;
  for (int t = 0; t < n; ++t) {
    const int cur = t & 1;
    if (t == 0) {
      for (int task = blockIdx.x; task < n * chunks; task += G) {
        const int r = task / chunks;
        stage<T>(a, r, task % chunks, kv_elems);
        release_add(a.arrive + r * n + 0);
      }
    }
    if (t < n - 1) {
      for (int task = blockIdx.x; task < n * chunks; task += G) {
        const int r = task / chunks, dst = (r + 1) % n;
        wait_ge(a.arrive + r * n + t, chunks);
        if (t > 0) wait_ge(a.done + dst * n + (t - 1), per_rank + chunks);
        push(a, r, dst, cur, task % chunks, kv_elems);
        release_add(a.arrive + dst * n + (t + 1));
        release_add(a.done + r * n + t);
      }
    }
    for (int item = blockIdx.x; item < items; item += G) {
      const int r = item / per_rank;
      const int rest = item % per_rank;
      const int b = rest / (a.H * nqb), h = (rest / nqb) % a.H, qb = rest % nqb;
      const int src = (r - t + n) % n;
      const bool live = !a.causal || src <= r;
      if (live) wait_ge(a.arrive + r * n + t, chunks);
      attend<D, T>(a, smem, t, cur, r, b, h, qb * kRows, live, a.causal && src == r, kv_elems);
      release_add(a.done + r * n + t);
    }
  }
}

template <int D, typename T>
int launch(const Args& a, int* info, cudaStream_t st) {
  auto kern = ring_attn_kernel<D, T>;
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int64_t kv_elems = (int64_t)a.B * a.S * a.Hk * D;
  const int64_t chunks = (2 * kv_elems + kChunk - 1) / kChunk;
  const int64_t items = (int64_t)a.n * a.B * a.H * ((a.S + kRows - 1) / kRows);
  const int grid = (int)std::min<int64_t>((int64_t)per_sm * sms, std::max(items, a.n * chunks));
  if (info) {
    info[0] = grid;
    info[1] = per_sm;
  }
  e = cudaMemsetAsync(a.arrive, 0, sizeof(unsigned) * a.n * a.n, st);
  if (e == cudaSuccess) e = cudaMemsetAsync(a.done, 0, sizeof(unsigned) * a.n * a.n, st);
  if (e != cudaSuccess) return (int)e;
  Args args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid), dim3(kThreads), params, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: a device array of 4 * n pointers (q, k, v, out of each rank), every
// tensor contiguous and 16-byte aligned; q, k, v, out bf16 (is_bf16 1) or
// fp32; slots [n, 2, 2, B, S, Hk, D], acc [n, B, H, S, D], lse [n, B, H, S]
// fp32 scratch; counters 2 * n * n uint32, zeroed here on the stream.  D is
// 64 or 128, H a multiple of Hk.  info (host int[2], may be null) gets the
// grid and the blocks an SM.  A device that cannot launch cooperatively, or
// a grid the occupancy does not hold, returns the CUDA error: no fallback.
extern "C" int fatt_ring_attn(const void* ptrs, void* slots, void* acc, void* lse,
                              void* counters, int n, int B, int S, int H, int Hk, int D,
                              int is_bf16, int causal, float scale, int* info, void* stream) {
  if (n < 1 || B < 1 || S < 1 || Hk < 1 || H % Hk != 0 || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const auto p = static_cast<void* const*>(const_cast<void*>(ptrs));
  Args a;
  a.q = p;
  a.k = p + n;
  a.v = p + 2 * n;
  a.out = p + 3 * n;
  a.slots = static_cast<float*>(slots);
  a.acc = static_cast<float*>(acc);
  a.lse = static_cast<float*>(lse);
  a.arrive = static_cast<unsigned*>(counters);
  a.done = a.arrive + n * n;
  a.n = n;
  a.B = B;
  a.S = S;
  a.H = H;
  a.Hk = Hk;
  a.causal = causal;
  a.scale = scale;
  auto st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return D == 64 ? launch<64, __nv_bfloat16>(a, info, st) : launch<128, __nv_bfloat16>(a, info, st);
  return D == 64 ? launch<64, float>(a, info, st) : launch<128, float>(a, info, st);
}

// K11: ring attention, the whole ring of n ranks in one cooperative launch.
//
// Replaces flash_attn_tpu/parallel/rdma_ring.py:_kernel (B11, its
// pallas_call at :239): each rank r holds queries q_r [B, S, H, D] and a KV
// shard k_r, v_r [B, S, Hk, D]; out_r is the softmax of q_r k^T * scale over
// all n shards, times v, in fp32 (inputs taken to fp32, products at fp32
// accuracy), written back in q's dtype.  Causal means the contiguous
// layout: earlier shards in full, the diagonal shard causal, later shards
// dead.
//
// The TPU runs one pallas_call a device with the ring step as its outer
// grid axis and pushes the KV shard to the right neighbour with a remote
// DMA under the step's compute.  Here the ranks are logical ranks of one
// card and the rank is a coordinate of the work: one launch runs every
// rank.  Each rank has two KV slots in device memory (JAX's VMEM double
// buffer; their layout below); slot 0 is staged from the local shard.  At
// step t (cur = t % 2) each rank's slot cur is copied into the right
// neighbour's slot 1 - cur by the blocks themselves, in chunks of 64 KB,
// before they compute on slot cur.  Counters in global memory keep JAX's
// protocol (rdma_ring.py:85-136), each raised with a release (every
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
// zeroed on the stream before each launch; slots are read through L2 only
// (ld.global.cg; the tiles by bulk copy, after a proxy fence), so no block
// sees a stale L1 line of a slot written again.  A wait that lasts 20 s
// traps, so that a protocol fault fails the launch instead of hanging the
// card.
//
// A work item is 128 query rows of one (rank, batch, KV head): the query
// heads of one KV head share each K/V tile, 4 (or 2, or 1: the most that
// divides the group) of them over 32 (64, 128) rows, eight warps of 16
// rows.  The same block takes the same items at every step, so its fp32
// accumulators and LSE, kept in device memory between steps (JAX keeps
// them in VMEM scratch), are read and written only by it.  Within a step
// the item streams 64-key tiles of K and V through shared memory with an
// online softmax in base-2 units (row max, row sum, unnormalised O in
// registers); at the end of the step it merges (m + log l, O) into the
// running (lse, acc) by rdma_ring.py:168-201 case for case: a dead row or a
// skipped step adds exactly nothing and no exp(-inf - -inf) is formed.
// The last step writes out_r.
//
// Bound on the H100: operations, on the tensor cores.  JAX computes both
// products in fp32 at Precision.HIGHEST (rdma_ring.py:148-149, 183-184).
// One TF32 pass keeps 10 mantissa bits, ~2^-11 relative a product, so its
// logits at |s| ~ 40 err by ~0.02 and the output by ~2 %: it would change
// the function (a one-pass copy misses the card's large-logit case 39x).
// Three passes keep HIGHEST's accuracy: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi), a b = lo_a hi_b + hi_a lo_b + hi_a hi_b (the small
// terms first), accumulated in fp32; the dropped lo_a lo_b and lo's own
// rounding cost ~2^-21 relative a product.  So 3 x 4 D flops a live
// (query, key) pair at the TF32 peak (495 TFLOP/s).
//   * The route is wgmma (m64nNk8 TF32), both products, A from registers:
//     TF32 takes B only K-major, which K is as it stands and V is
//     transposed.  Q's fp32 fragments come from a shared Q tile and P's
//     from the S accumulators, each split at its use; the keys of a depth
//     step are taken in the order 2t, 2t + 1 <-> k index t, t + 4, so an
//     accumulator's pair is a fragment's pair, and K's columns and V^T's
//     keys are staged in that order.  mma.sync from shared memory, every
//     B fragment read once a warp (16 rows), ran 1.66x longer on the H100.
//   * The split is done once a shard: staging writes each rank's K and V
//     into its slot 0 as TF32 hi and lo planes, tile by tile, each plane
//     byte for byte the swizzled shared tile wgmma reads, so one bulk copy
//     (cp.async.bulk, an mbarrier) brings K's half of a tile and one its
//     V^T's (2048 16-byte cp.async a tile cost 8 ms of the 8B causal call
//     on the H100).
//     The slots, and so the pushes, hold twice the bytes of fp32 K/V (64
//     MiB a rank at Llama-3-8B's widths and S_loc 4096).
//   * K and V^T have one buffer each (64 KB at D = 128): K of the next
//     tile loads while this tile's softmax and PV run, V^T while the next
//     S runs; empty barriers say when every warp is done with a buffer.
//     With the Q tile, 197 KB: one block of eight warps an SM.
//   * Diagonal items skip, warpgroup by warpgroup, the tiles past their
//     rows (an exact no-op otherwise: p = 0, alpha = 1).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16 * kWarps;   // query rows a work item (over its heads)
constexpr int kKeys = 64;            // keys a tile
constexpr int kChunk = 16384;        // floats a staging or push task (64 KB)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* const* q;              // n pointers, [B, S, H, D] each
  const void* const* k;              // n pointers, [B, S, Hk, D]
  const void* const* v;
  void* const* out;                  // n pointers, [B, S, H, D]
  float* slots;                      // [n, 2, B, Hk, S_pad / kKeys, 4, kKeys * D]
  float* acc;                        // [n, B, H, S, D]
  float* lse;                        // [n, B, H, S]
  unsigned* arrive;                  // [n, n]
  unsigned* done;                    // [n, n]
  int n, B, S, H, Hk, causal;
  float scale;
};

__host__ __device__ constexpr int pad_keys(int S) { return (S + kKeys - 1) / kKeys * kKeys; }

// The work items of one rank: an item is `heads` query heads of one KV
// head (4, 2 or 1, the most that divides the group), each over `rows`
// query rows (kWarps / heads warps of 16), so the heads share each K/V tile.
struct Items {
  int heads, rows, nqb, per_rank;
  __host__ __device__ Items(int B, int S, int H, int Hk) {
    const int G = H / Hk;
    heads = G % 4 == 0 ? 4 : G % 2 == 0 ? 2 : 1;
    rows = kRows / heads;
    nqb = (S + rows - 1) / rows;
    per_rank = B * Hk * (G / heads) * nqb;
  }
};

// Shared memory, from a 1024-byte boundary (bytes): a key tile's K hi and
// lo planes ([kKeys][D] fp32, D / 32 swizzle atoms wide), then its V^T hi
// and lo planes ([D][kKeys], two atoms wide), in the 128-byte swizzle that
// wgmma reads (fatt::sw128); then the item's Q, fp32 rows of D padded by 8
// (8 mod 32: a half warp's 8-byte reads, four rows of four pairs, on 32
// distinct banks).  K and V^T are one buffer each: K of the next tile
// loads while this tile's softmax and PV run, V^T while the next S runs.
template <int D>
struct Tile {
  static constexpr int kPlane = D * kKeys * 4;     // one plane of K or V^T
  static constexpr int kHalf = 2 * kPlane;         // K's (or V^T's) two planes
  static constexpr int kQPitch = D + 8;
  static constexpr int kQOffset = 2 * kHalf;
  static constexpr int kSmemBytes = kQOffset + kRows * kQPitch * 4 + 1024;
};

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

// A buffer's bulk copy: one thread arms the buffer's full barrier with the
// bytes to come and copies them global -> shared (the async proxy, through
// L2); every thread waits on the barrier's phase (bar_wait).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// Wait until mbarrier bar has completed its phase of this parity; 20 s
// trap as wait_ge does.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  const uint64_t t0 = global_ns();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) break;
    if (global_ns() - t0 > kWaitNs) __trap();
  }
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// S (64 x kKeys, this warp's rows as s[j][e]: key 8 j + 2 t + (e & 1) of
// row g + 8 (e >> 1), g = lane / 4, t = lane % 4) = Q K^T on wgmma in three
// TF32 passes, the small terms first.  Q's fp32 A fragments come from the
// Q tile (qa: this thread's row g at column 2 t; depth step ks takes
// columns 8 ks + 2 t (k index t) and + 1 (t + 4), as K's planes are
// staged), split at each use four depth steps a batch into one of two
// register buffers, which a batch's products read until they are done.
// K's hi and lo planes at shared addresses kh, kl.
template <int D, int kQPitch>
__device__ __forceinline__ void qk3(float (&s)[kKeys / 8][4], const float* qa, uint32_t kh,
                                    uint32_t kl) {
  auto& sd = reinterpret_cast<float(&)[kKeys / 2]>(s);
#pragma unroll
  for (int i = 0; i < kKeys / 2; ++i) sd[i] = 0.f;
  uint32_t ah[2][4][4], al[2][4][4];
#pragma unroll
  for (int bt = 0; bt < D / 32; ++bt) {
    const int buf = bt & 1;
    if (bt >= 2) fatt::wg_wait<1>();  // the batch before last has read buffer buf
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ks = 4 * bt + i;
      const float2 x0 = load2(qa + 8 * ks), x1 = load2(qa + 8 * kQPitch + 8 * ks);
      split(x0.x, ah[buf][i][0], al[buf][i][0]);
      split(x1.x, ah[buf][i][1], al[buf][i][1]);
      split(x0.y, ah[buf][i][2], al[buf][i][2]);
      split(x1.y, ah[buf][i][3], al[buf][i][3]);
    }
    fatt::pin(sd);
    fatt::wg_fence();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ks = 4 * bt + i;
      fatt::wgmma_tf32(sd, al[buf][i], fatt::wg_desc(fatt::kmajor<kKeys>(kh, ks)));
      fatt::wgmma_tf32(sd, ah[buf][i], fatt::wg_desc(fatt::kmajor<kKeys>(kl, ks)));
      fatt::wgmma_tf32(sd, ah[buf][i], fatt::wg_desc(fatt::kmajor<kKeys>(kh, ks)));
    }
    fatt::wg_commit();
  }
  fatt::wg_wait<0>();
  fatt::pin(sd);
}

// O (64 x D) += P V on wgmma in three TF32 passes, the small terms first:
// P's A fragments of depth step j split into ah[j] + al[j], V^T's hi and lo
// planes at shared addresses vh, vl.
template <int D>
__device__ __forceinline__ void pv3(float (&o)[D / 8][4], const uint32_t (&ah)[kKeys / 8][4],
                                    const uint32_t (&al)[kKeys / 8][4], uint32_t vh,
                                    uint32_t vl) {
  auto& od = reinterpret_cast<float(&)[D / 2]>(o);
  fatt::pin(od);
  fatt::wg_fence();
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    fatt::wgmma_tf32(od, al[j], fatt::wg_desc(fatt::kmajor<D>(vh, j)));
    fatt::wgmma_tf32(od, ah[j], fatt::wg_desc(fatt::kmajor<D>(vl, j)));
    fatt::wgmma_tf32(od, ah[j], fatt::wg_desc(fatt::kmajor<D>(vh, j)));
  }
  fatt::wg_commit();
  fatt::wg_wait_all();
  fatt::pin(od);
}

// Stage rank r's local shard into its slot 0 as TF32 hi and lo planes:
// floats [c * kChunk, (c + 1) * kChunk) of the slot, which is [B, Hk,
// S_pad / kKeys key tiles, 4 planes], a tile's planes (K hi, K lo: kKeys
// keys x D columns; V^T hi, V^T lo: D columns x kKeys keys) each laid out
// byte for byte as the shared tile wgmma reads (fatt::sw128), so one bulk
// copy brings K's two planes and one V^T's.  Along a plane row each 8 positions hold the order
// 0, 2, 4, 6, 1, 3, 5, 7, a depth step's k indices as Q's and P's A
// fragments take them; zero past S.
template <int D, typename T>
__device__ void stage(const Args& a, int r, int c, int64_t kv_elems) {
  using G = Tile<D>;
  constexpr int kPlaneFloats = G::kPlane / 4;
  float* dst = a.slots + (int64_t)r * 2 * 2 * kv_elems;
  const int S = a.S, Hk = a.Hk;
  const int64_t end = (int64_t)(c + 1) * kChunk < 2 * kv_elems ? (int64_t)(c + 1) * kChunk
                                                                : 2 * kv_elems;
  for (int64_t e = (int64_t)c * kChunk + threadIdx.x * 4; e < end; e += kThreads * 4) {
    const int64_t tile = e / (4 * kPlaneFloats);  // (b, hk) * tiles + key tile
    const int plane = (int)(e / kPlaneFloats % 4), o = (int)(e % kPlaneFloats) * 4;
    const bool is_k = plane < 2, lo = plane & 1;
    const int R = is_k ? kKeys : D;  // the plane's rows: keys of K, columns of V^T
    // byte o of the swizzled plane: row, and the logical 16-byte chunk
    const int part = o / (R * 128), row = o % (R * 128) / 128;
    const int chunk = part * 8 + ((o % 128 / 16) ^ (row & 7));
    const int nkt = S / kKeys + (S % kKeys != 0);
    const int64_t bh = tile / nkt;
    const int key0 = (int)(tile % nkt) * kKeys;
    const T* src = static_cast<const T*>(is_k ? a.k[r] : a.v[r]) +
                   ((bh / Hk) * S * Hk + bh % Hk) * D;
    float y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = 8 * (chunk >> 1) + (chunk & 1) + 2 * i;  // the 8-group order
      const int key = key0 + (is_k ? row : pos), col = is_k ? pos : row;
      uint32_t h32 = 0, l32 = 0;
      if (key < S) split(load1(src + (int64_t)key * Hk * D + col), h32, l32);
      y[i] = __uint_as_float(lo ? l32 : h32);
    }
    __stcg(reinterpret_cast<float4*>(dst + e), make_float4(y[0], y[1], y[2], y[3]));
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

// One work item at step t: rows [r0, r0 + it.rows) of query heads h0 ..
// h0 + it.heads - 1 of (rank r, batch b), all of KV head hk, against rank
// r's slot ``cur``, merged into acc / lse.  Warp w takes head h0 + w /
// (kWarps / it.heads) and its 16 rows from r0 + 16 (w % (kWarps /
// it.heads)); a thread holds rows + lane / 4 (accumulator entries 0, 1)
// and 8 below (2, 3).  Scores are in base-2 units (log2 e folded into the
// scale).
template <int D, typename T>
__device__ void attend(const Args& a, const Items& it, float* smem, uint32_t bars,
                       uint32_t& phases, int t, int cur, int r, int b, int hk, int h0, int r0,
                       bool live, bool diag, int64_t kv_elems, int S_pad) {
  using G = Tile<D>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int S = a.S, H = a.H;
  const int wph = kWarps / it.heads;
  const int h = h0 + warp / wph;
  const int wrow0 = r0 + 16 * (warp % wph);
  const int64_t row_base = (((int64_t)r * a.B + b) * H + h) * S;  // into acc / lse rows
  const bool last = t == a.n - 1;

  float o[D / 8][4];
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};  // l: this thread's share
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  if (live) {
    // the shared tiles from the first 1024-byte boundary (wgmma's swizzle)
    const uint32_t s_raw = fatt::smem_u32(smem);
    const uint32_t s_base = (s_raw + 1023) & ~1023u;
    unsigned char* sm = reinterpret_cast<unsigned char*>(smem) + (s_base - s_raw);
    // this warp's 16 rows of Q, fp32 (zero past S), into its rows of the
    // Q tile (read by this warp alone)
    const T* q = static_cast<const T*>(a.q[r]);
    float* qs = reinterpret_cast<float*>(sm + G::kQOffset) + 16 * warp * G::kQPitch;
    for (int i = lane; i < 16 * (D / 2); i += 32) {
      const int row = i / (D / 2), c = i % (D / 2);
      const float2 x = wrow0 + row < S
                           ? load2(q + (((int64_t)b * S + wrow0 + row) * H + h) * D + 2 * c)
                           : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(qs + row * G::kQPitch + 2 * c) = x;
    }
    __syncwarp();
    const float sl2 = a.scale * kLog2e;
    const unsigned char* slot = reinterpret_cast<const unsigned char*>(
        a.slots + ((int64_t)r * 2 + cur) * 2 * kv_elems +
        ((int64_t)b * a.Hk + hk) * S_pad * 4 * D);  // (b, hk)'s key tiles
    const int nk = (S + kKeys - 1) / kKeys;
    const int tiles = diag ? min((r0 + it.rows - 1) / kKeys + 1, nk) : nk;
    // the last row of this warp's warpgroup, wgmma's unit: a diagonal tile
    // wholly past it adds nothing (p = 0, alpha = 1) and is skipped
    int wg_last = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) wg_last = max(wg_last, 16 * (((warp & ~3) + i) % wph) + 15);
    wg_last += r0;
    // half x (0: K, 1: V^T) of key tile kt into its buffer by one bulk
    // copy, issued by thread 0 once every warp has released the buffer's
    // last tile (its empty barrier)
    auto load_half = [&](int x, int kt) {
      if (phases >> (4 + x) & 1u) {
        bar_wait(bars + 16 + 8 * x, phases >> (2 + x) & 1u);
        phases ^= 1u << (2 + x);
      }
      phases |= 1u << (4 + x);
      bulk_load(s_base + x * G::kHalf, slot + ((int64_t)kt * 2 + x) * G::kHalf, G::kHalf,
                bars + 8 * x);
    };
    // wait for half x's bytes; this warp's release of it when done
    auto acquire = [&](int x) {
      bar_wait(bars + 8 * x, phases >> x & 1u);
      phases ^= 1u << x;
    };
    auto release = [&](int x) {
      if (lane == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bars + 16 + 8 * x)
                     : "memory");
    };
    if (tid == 0) {
      // the slot's bytes, written by other blocks' generic stores and
      // acquired above, before this thread's async-proxy reads of them
      asm volatile("fence.proxy.async;" ::: "memory");
      load_half(0, 0);
      load_half(1, 0);
    }
    const uint32_t kh = s_base, vh = s_base + G::kHalf;
    for (int tile = 0; tile < tiles; ++tile) {
      const int k0 = tile * kKeys;
      const bool skip = diag && k0 > wg_last;
      // S = Q K^T; then K's buffer takes the next tile
      float s[kKeys / 8][4];
      acquire(0);
      if (!skip) qk3<D, G::kQPitch>(s, qs + g * G::kQPitch + 2 * t4, kh, kh + G::kPlane);
      release(0);
      if (tid == 0 && tile + 1 < tiles) load_half(0, tile + 1);
      if (!skip) {
        // mask, online softmax; a row's keys lie in the quad of its g
        float alphas[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = wrow0 + g + 8 * hf;
          float mt = -CUDART_INF_F;
#pragma unroll
          for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
            for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
              const int key = k0 + 8 * j + 2 * t4 + (e & 1);
              const bool dead = key >= S || (diag && key > row);
              s[j][e] = dead ? -CUDART_INF_F : s[j][e] * sl2;
              mt = fmaxf(mt, s[j][e]);
            }
          }
          mt = fatt::quad_max(mt);
          const float mn = fmaxf(m[hf], mt);
          const bool any = mn > -CUDART_INF_F;
          const float alpha =
              any && m[hf] > -CUDART_INF_F ? exp2f(m[hf] - mn) : (any ? 0.f : 1.f);
          float ls = 0.f;
#pragma unroll
          for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
            for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
              s[j][e] = any && s[j][e] > -CUDART_INF_F ? exp2f(s[j][e] - mn) : 0.f;
              ls += s[j][e];
            }
          }
          l[hf] = l[hf] * alpha + ls;
          m[hf] = mn;
          alphas[hf] = alpha;
        }
        // O *= alpha, skipped where the warp's rows kept their max (alpha 1)
        if (__any_sync(0xffffffffu, alphas[0] != 1.f || alphas[1] != 1.f)) {
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            o[j][0] *= alphas[0];
            o[j][1] *= alphas[0];
            o[j][2] *= alphas[1];
            o[j][3] *= alphas[1];
          }
        }
      }
      // O += P V; then V^T's buffer takes the next tile
      acquire(1);
      if (!skip) {
        // P's depth step j is S's key block j, its k index t4 key 8 j + 2 t4
        // and t4 + 4 key 8 j + 2 t4 + 1, as V^T's keys are staged
        uint32_t ah[kKeys / 8][4], al[kKeys / 8][4];
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          split(s[j][0], ah[j][0], al[j][0]);
          split(s[j][2], ah[j][1], al[j][1]);
          split(s[j][1], ah[j][2], al[j][2]);
          split(s[j][3], ah[j][3], al[j][3]);
        }
        pv3<D>(o, ah, al, vh, vh + G::kPlane);
      }
      release(1);
      if (tid == 0 && tile + 1 < tiles) load_half(1, tile + 1);
    }
  }

  // merge into (lse, acc) by rdma_ring.py:168-201; write out at the last step
  T* out = static_cast<T*>(a.out[r]);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = wrow0 + g + 8 * hf;
    const float lsum = fatt::quad_sum(l[hf]);
    if (row >= S) continue;
    const int64_t ar = row_base + row;
    const float lse_prev = t == 0 ? -CUDART_INF_F : a.lse[ar];
    const bool step_live = live && m[hf] > -CUDART_INF_F && lsum > 0.f;
    const float m_nat = m[hf] * kLn2;
    const float lse_i = step_live ? m_nat + logf(lsum) : -CUDART_INF_F;
    float lse_new = lse_prev, w_prev = 1.f, w_i = 0.f;
    if (step_live) {
      const float hi = fmaxf(lse_prev, lse_i), lo = fminf(lse_prev, lse_i);
      lse_new = hi + log1pf(expf(lo - hi));
      w_prev = lse_prev > -CUDART_INF_F ? expf(lse_prev - lse_new) : 0.f;
      w_i = expf(m_nat - lse_new);
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      float2 prev = make_float2(0.f, 0.f);
      if (t > 0) prev = load2(a.acc + ar * D + col);
      const float x0 = prev.x * w_prev + o[j][2 * hf] * w_i;
      const float x1 = prev.y * w_prev + o[j][2 * hf + 1] * w_i;
      if (last)
        store2(out + (((int64_t)b * S + row) * H + h) * D + col, x0, x1);
      else
        store2(a.acc + ar * D + col, x0, x1);
    }
    if (!last && t4 == 0) a.lse[ar] = lse_new;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1) ring_attn_kernel(Args a) {
  extern __shared__ float4 smem4[];
  // K's and V^T's full barriers (the bulk copy's bytes landed) and empty
  // ones (every warp is done with the buffer)
  __shared__ __align__(8) uint64_t bar[4];
  float* smem = reinterpret_cast<float*>(smem4);
  const uint32_t bars = fatt::smem_u32(bar);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bars + 8 * i),
                   "r"(i < 2 ? 1 : kWarps) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // bit h (0: K, 1: V^T): the parity of the buffer's full barrier a wait
  // expects next; bits 2 + h, 4 + h (thread 0): the same for its empty
  // barrier, and whether the buffer was ever loaded
  uint32_t phases = 0;
  const int n = a.n;
  const int S_pad = pad_keys(a.S);
  const int64_t kv_elems = (int64_t)a.B * a.Hk * S_pad * 2 * D;  // floats of K (or V) a slot
  const int chunks = (int)((2 * kv_elems + kChunk - 1) / kChunk);
  const Items it(a.B, a.S, a.H, a.Hk);
  const int per_rank = it.per_rank;
  const int items = n * per_rank;
  const int chunks_h = a.H / a.Hk / it.heads;  // head chunks a KV head
  const int G = gridDim.x;
  for (int t = 0; t < n; ++t) {
    const int cur = t & 1;
    if (t == 0) {
      for (int task = blockIdx.x; task < n * chunks; task += G) {
        const int r = task / chunks;
        stage<D, T>(a, r, task % chunks, kv_elems);
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
      const int qb = rest % it.nqb, hc = rest / it.nqb % (a.Hk * chunks_h);
      const int b = rest / (it.nqb * a.Hk * chunks_h);
      const int hk = hc / chunks_h, h0 = hk * (a.H / a.Hk) + hc % chunks_h * it.heads;
      const int src = (r - t + n) % n;
      const bool live = !a.causal || src <= r;
      if (live) wait_ge(a.arrive + r * n + t, chunks);
      attend<D, T>(a, it, smem, bars, phases, t, cur, r, b, hk, h0, qb * it.rows, live,
                   a.causal && src == r, kv_elems, S_pad);
      release_add(a.done + r * n + t);
    }
  }
}

template <int D, typename T>
int launch(const Args& a, int* info, cudaStream_t st) {
  auto kern = ring_attn_kernel<D, T>;
  const size_t smem = Tile<D>::kSmemBytes;
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
  const int64_t kv_elems = (int64_t)a.B * a.Hk * pad_keys(a.S) * 2 * D;
  const int64_t chunks = (2 * kv_elems + kChunk - 1) / kChunk;
  const int64_t items = (int64_t)a.n * Items(a.B, a.S, a.H, a.Hk).per_rank;
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
// fp32; slots 8 n B Hk S_pad D floats, S_pad S rounded up to a multiple of
// 64 (the key tile; each rank's two slots hold K and V^T as TF32 hi and lo
// planes, tile by tile, see stage), acc [n, B, H, S, D], lse [n, B, H, S]
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

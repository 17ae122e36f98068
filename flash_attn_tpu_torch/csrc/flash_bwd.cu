// K9 and K10: FlashAttention-2 backward, BSHD bf16, bottom-right causal GQA
// with q-side RoPE, at head_dim 64 (GPT-2), 128 (Llama-3; Gemma-2-27B with
// the sliding window and the logit softcap) and 256 (Gemma-2-9B, with
// both).  Two passes, each
// deterministic by construction (no atomics), as on the TPU:
//   K9  (dq pass)    replaces flash_attn_tpu/ops/flash_bwd.py:_dq_kernel;
//   K10 (dk/dv pass) replaces flash_attn_tpu/ops/flash_bwd.py:_dkv_kernel
// on the subset the GPT-2, Llama and Gemma-2 training steps and the C ABI's
// backward entry points use (the window and the softcap at head_dim 128
// and 256; segment ids, positions, an additive bias, dropout, ALiBi and
// dbias at head_dim 64 and 128; segment ids and positions with the window
// and the softcap at 128).  K9 runs first: it rotates q once and
// writes R(q), which K10 streams as it is.
//
// Bound on the H100: operations at D = 128 and 256, bytes at D = 64.  At
// S = 2048, D = 128 the causal half of the five products (QK^T, dO V^T,
// dS K in K9; QK^T, dO V^T, P^T dO, dS^T R(q) in K10, each 2*D flops per
// live (query, key) pair) is far above the ridge against ~4*S*D*2 bytes
// of inputs per head.  At GPT-2's S = 1024, D = 64 the products halve
// twice over while the fp32 outputs (dq; dk and dv per query head) stay
// as large as the bf16 inputs, so the bytes bound both passes.  The
// design keeps scores, P and dS in registers and the tensor cores fed:
//   * every product is a warpgroup wgmma m64n64k16 (bf16 in, fp32
//     accumulate).  Operands read from shared memory sit in the 128-byte
//     swizzle that wgmma reads, as 64-column parts of 64 rows
//     (fatt::sw128), each tile 1024-byte aligned;
//   * K9: one block per (query tile, head, batch), heavy causal tiles
//     first.  R(q) (rotated in fp32 from the bf16 q, rounded to bf16, also
//     written to device memory for K10) and dO stay in shared memory as
//     each warpgroup's A operands; K/V tiles of 64 keys arrive by cp.async
//     into a two-stage ring over the block's live key tiles.  S = R(q) K^T
//     and dP = dO V^T go to register accumulators; dS = P (dP - delta) is
//     packed to bf16 A fragments straight from them (the accumulator
//     layout is the A layout); dq += dS K reads K as a transposed (N-major)
//     operand.  dq stays in registers for the whole loop, then is scaled,
//     pulled back through the rotation in fp32 (a column and its partner
//     D/2 away sit in one thread) and written as fp32;
//   * K10: one block per (key tile, query head, batch), key tile 0 (the
//     most live query tiles) first.  K and V stay in shared memory as A
//     operands; R(q), dO and the tile's lse and delta stream through a
//     two-stage cp.async ring over the live query tiles of 64.  S^T =
//     K R(q)^T and dP^T = V dO^T go to registers; P^T and dS^T are packed
//     to bf16 A fragments there; dv += P^T dO and dk += dS^T R(q) read dO
//     and R(q) as transposed operands.  Each query head writes its own
//     fp32 dk/dv and the wrapper sums a GQA group (one block walking a
//     group's query heads in order and writing their sum measured slower);
//   * only tiles that a warp's diagonal, a window edge or a ragged edge
//     crosses are masked element by element; dead tiles are never loaded.
// Head dim 64 (GPT-2): a bf16 row of 64 is one 128-byte swizzle atom, so a
// tile is one 64-column part (8 KB) and the products serve it as they
// are.  The blocks are the 128 instance's (two warpgroups of 64 rows
// each, K10's each owning all 64 columns of its keys' dk and dv), with
// ~66 KB of shared memory; K9's dq accumulator is 32 registers a thread,
// so K9 asks for two blocks an SM.  The rope partner of a column sits 32
// columns away, in the same part, in this thread's fragment block + 4.
// Head dim 128: a block is two warpgroups, each owning 64 of its 128 rows
// (query rows in K9, keys in K10) and sharing its streamed tiles; ~129 KB
// of shared memory and 256 threads, one block an SM (two blocks of one
// warpgroup each measured 2-4 % slower); 167 (K9) and 236 (K10) registers.
// The window and the softcap live in instances of their own (kLocal), at
// head_dim 256 and beside the 128 instances (Gemma-2-27B: the same blocks
// of two warpgroups, causal or not), as in K4, where compiled into the
// Llama instance at run time they cost it its third block an SM.
// Head dim 256 (kLocal only):
//   * K9: one warpgroup of 64 query rows a block.  Its dq accumulator is
//     64 x 256 fp32, 128 registers a thread, as O is in K4's 256 instance;
//     R(q), dO and a two-stage K/V ring of 64-row, 32 KB tiles take
//     193 KB (two warpgroups would need 257 KB);
//   * K10: dk and dv of 64 keys x 256 columns are 256 fp32 registers a
//     thread in one warpgroup, which cannot fit.  So two warpgroups share
//     the block's 64 keys and each owns half of the columns of dk and dv
//     (128 registers, the 128 instance's budget).  Each recomputes S^T and
//     dP^T over the full D itself (1.5x the products of one pass, but no
//     exchange of P^T or dS^T through shared memory and no barrier
//     between the warpgroups beyond the ring's); 194 KB.
// Every kLocal instance:
//   * the window (left, right; -1 open), bottom-right aligned as causal
//     is, skips tiles: K9 walks key tiles from its first row's left edge
//     (row + shift - left) to its last row's causal or right edge; K10
//     walks query tiles from the first causal-live one to the last whose
//     first row lies within the block's last key + left.  JAX masks the
//     window element by element (flash_bwd.py:87-95) and skips only
//     causal tiles (:178-180, 253-256); the values agree either way;
//   * the softcap (flash_bwd.py:66-70, 122-123): s = c tanh(s / c) before
//     P, with the forward's tanh (fatt::tanh_exp2; a different tanh would
//     make P's rows sum away from 1 against the forward's lse), and
//     dS = P (dP - delta) (1 - tanh^2) for dq and dk; dv takes P.
// Roundings as the reference: R(q) rounded to bf16 before the products
// (flash_fwd.py:146-160); s = (R(q) k^T) * scale in natural units;
// p = exp(s - lse), evaluated as 2^(s * scale * log2 e - lse * log2 e)
// (with the cap, 2^(c log2 e * t - lse log2 e), t = tanh(s * scale / c)),
// masked elementwise (padded and fully masked rows carry lse = NEG_INF and
// give 0); ds = p (dp - delta); P cast to bf16 before dv, dS before dq and
// dk; dq pulled back through the rotation in fp32.
//
// Segment ids, positions, a bias and dropout (the kOpt instances, at head
// dims 64 and 128 beside the instances without them, which keep their code;
// _recompute_p_ds, flash_bwd.py:48-124):
//   * segment ids and positions come as K4 takes them (ops/flash_fwd.py:
//     tile_meta): a (segment, position) pair a token and each 64-token
//     tile's least and greatest of both.  Each block first lists the tiles
//     it walks (K9: key tiles, K10: query tiles) whose ranges can meet its
//     own, in order, in shared memory, and marks those live throughout;
//     the ring walks the list, so a packed batch's dead tiles are never
//     loaded.  Elsewhere a pair is live where qs == ks and kp <= qp;
//   * the bias goes on the natural-unit scores: p = exp(s scale + bias -
//     lse), as 2^(s scale log2 e + (bias log2 e - lse log2 e)).  It rides
//     the cp.async ring one stage ahead, in the commit group of the stage's
//     K/V (K9: the block's 128 query rows x the stage's 64 keys) or R(q)/dO
//     (K10: the stage's 64 queries x the block's 128 keys), 32 KB of fp32 a
//     stage, so no global load sits between a tile's two wgmma batches.
//     Read from a fixed global address per element after S = R(q) K^T, it
//     cost a full load latency a tile (2.2x cuDNN's backward on a float
//     mask).  Every stride the wrapper's broadcast views give takes this one
//     route (load_bias: 16-, 8- or 4-byte pieces as the plane's alignment
//     and key stride allow); rows and keys past Sq / Sk are zero-filled, and
//     masked dead.  Staged rows are padded (K9: 72 floats; K10: 132) so that
//     each warp's fragment reads are free of bank conflicts; the stages are
//     sized at launch only when a bias is given.  K9 reads its 32 entries
//     into registers while S and dP run; K10, at 244 registers, reads each
//     as it needs it (holding them spilled and ran slower);
//   * dropout replays the forward's mask (fatt::drop_keep on the query
//     head h and the absolute row and column): dp becomes keep ? dp / (1 -
//     rate) : 0 before ds = p (dp - delta), and K10's dv takes P dropped
//     alike; ds keeps the undropped P.  Whether to replay is one branch a
//     tile between two copies of the element loop, not one an element.
// The window and the softcap with segment ids and positions (kLocal and
// kOpt: one head_dim 128 instance a pass, and its twin kWinIdx; training
// a windowed Llama such as Mistral-7B on packed documents, the windowed
// ring), neither with a bias, dropout, ALiBi or dS:
//   * with positions the window compares them (flash_bwd.py:87-95, as K4's
//     masked kLocal instance does): the index range of the kLocal walk
//     does not bound it; the list's tile test also drops a tile whose
//     positions lie outside the window of the block's (K9: the key tile's
//     greatest position below the query rows' least - left, or its least
//     above their greatest + right), and a tile is live throughout only if
//     every pair lies inside the window as well as in one segment;
//   * without positions (kWinIdx: segment ids alone, as llama.forward
//     packs documents) the window compares the bottom-right aligned
//     indices: the kLocal walk's index range bounds the list, its index
//     edges mark the tiles to mask, and the list's test is the segments'
//     alone (the positions are 0 there).  A tile dead by the window and
//     live by the segments, or the reverse, is skipped or masked by
//     whichever test says so;
//   * the softcap is the kLocal one (the forward's tanh; dS times 1 - t^2
//     for dq and dk, dv takes P); the bias staging and the dropout replay
//     are compiled out of these instances.
// ALiBi and dbias (kSurface: instances of their own beside the kOpt ones,
// which they extend, at head dims 64 and 128; the C entries pick them when
// the slopes or dS are given; flash_bwd.py:75-80, 247-264, 549-611).
// Compiled into the kOpt instances as runtime branches (copies of the
// element loop) they left the outputs there bitwise as they were, but
// took K9's kOpt points 5-14 % slower (222 to 236 registers at 128;
// NVIDIA H100 80GB HBM3, 700 W, chip_tools/k9_probe.py turns: the mask
// alone 0.5371-0.5465 to 0.5674-0.5682 ms), so the kOpt instances keep
// their code:
//   * ALiBi subtracts slope_h |row + Sk - Sq - col| from the natural-unit
//     scores after the bias, as 2^(s scale log2 e + (bias log2 e - lse
//     log2 e) - slope_h log2 e |...|), the slopes premultiplied by log2 e
//     on the host (K4's); an additive constant, so no factor on dS;
//   * dbias: K9 writes dS = P (dP - delta) (dP dropped; kOpt has no cap, so
//     no tanh factor) in fp32 to [B, H, Sq, Sk], each element once, as JAX's
//     dk/dv pass writes its ds tiles.  K9's accumulator layout holds a
//     warp's 16 query rows x 64 keys with a quad on 8 consecutive keys of a
//     row, which is the output's row-major order: each quad stores its row's
//     32 bytes as float2 pairs, whole sectors, with no transpose through
//     shared memory (K10 holds dS transposed).  Keys and rows past Sk / Sq
//     are not written; the wrapper zero-fills the buffer, so tiles K9 never
//     walks (dead causal tiles, tiles off the live list) are 0, as JAX's
//     _zero_ds makes them.  At B=2 S=2048 H=32 that is 1 GiB of writes.
#include <type_traits>

#include "common.cuh"

namespace {

using fatt::kNegInf;

constexpr int kRows = 64;        // rows a warpgroup owns, and a streamed tile's rows
constexpr int kPartBytes = kRows * 128;  // 64 columns of a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStatBytes = 2 * kRows * 4;
// kOpt: a block lists at most kMaxListTiles tiles, each entry a tile index
// with kFullBit where no segment or position masks it
constexpr int kMaxListTiles = 4096;
constexpr int kFullBit = 1 << 30;

// The kOpt instances' arguments (segment ids and positions as tile
// metadata, the bias, dropout); the other instances take them and ignore
// them.  qmeta/kmeta: [B, nq*64] / [B, nk*64] (segment, position) per
// token; qrange/krange: [B, nq] / [B, nk] (least segment, least position,
// greatest segment, greatest position) per 64-token tile; all null for
// none.  bias: null, or element (b, h, i, j) at b bs_b + h bs_h + i bs_q +
// j bs_k.  dropout: 0, or 1 with the seed's bits, the threshold and
// inv_keep = f32(1 / (1 - rate)).  alibi2: null, or [H] ALiBi slopes times
// log2 e.  ds: null, or (K9) fp32 [B, H, Sq, Sk] for dS, zero-filled.
struct Opt {
  const int2* qmeta;
  const int2* kmeta;
  const int4* qrange;
  const int4* krange;
  const float* bias;
  int64_t bs_b, bs_h, bs_q, bs_k;
  int dropout;
  uint32_t seed, threshold;
  float inv_keep;
  const float* alibi2;
  float* ds;
};

// Two adjacent fp32 values (columns c, c + 1) into a row of n: one 8-byte
// store where n is even (the row and c 8-byte aligned), else each in range.
__device__ __forceinline__ void store_pair(float* row, int c, int n, float x0, float x1) {
  if ((n & 1) == 0 && c + 1 < n) {
    *reinterpret_cast<float2*>(row + c) = make_float2(x0, x1);
  } else {
    if (c < n) row[c] = x0;
    if (c + 1 < n) row[c + 1] = x1;
  }
}

// Lists in shared memory, in order, the tiles t_first + i (i < n) that
// live(t, full) keeps, each with kFullBit where it sets full; returns how
// many.  Every thread of the block calls it (kThreads of them); 128-thread
// chunks at a time by ballot and a prefix count, as K4 does.
template <int kThreads, typename Live>
__device__ __forceinline__ int build_list(int* list, int* warp_live, int t_first, int n,
                                          Live live) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int count = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + threadIdx.x;
    bool keep = false, full = false;
    if (i < n) keep = live(t_first + i, full);
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_live[warp] = __popc(m);
    __syncthreads();
    int off = count;
    for (int w = 0; w < warp; ++w) off += warp_live[w];
    if (keep) list[off + __popc(m & ((1u << lane) - 1u))] = (t_first + i) | (full ? kFullBit : 0);
    for (int w = 0; w < kWarps; ++w) count += warp_live[w];
    __syncthreads();  // the list is complete; warp_live is free again
  }
  return count;
}

// The (least seg, least pos, greatest seg, greatest pos) of n consecutive
// 64-token tiles from t0 (those below nt).
__device__ __forceinline__ int4 tile_range(const int4* ranges, int t0, int n, int nt) {
  int4 r = ranges[t0];
  for (int i = 1; i < n; ++i) {
    if (t0 + i >= nt) break;
    const int4 o = ranges[t0 + i];
    r = make_int4(min(r.x, o.x), min(r.y, o.y), max(r.z, o.z), max(r.w, o.w));
  }
  return r;
}

// Can a pair of a query range qr and a key range kr be live (segments
// meet, some kv position <= some q position); is every pair (one segment
// on both sides, every kv position <= every q position)?
__device__ __forceinline__ bool ranges_live(int4 qr, int4 kr, bool& full) {
  full = qr.x == qr.z && kr.x == kr.z && kr.x == qr.x && kr.w <= qr.y;
  return kr.z >= qr.x && kr.x <= qr.z && kr.y <= qr.w;
}

// ranges_live with the window (left, right; -1 open) on the positions:
// some kv position can lie within [q - left, q + right] of some q position;
// full also wants every pair within it.
__device__ __forceinline__ bool ranges_live_window(int4 qr, int4 kr, int wleft, int wright,
                                                   bool& full) {
  bool live = ranges_live(qr, kr, full);
  if (wleft >= 0) {
    live = live && kr.w >= qr.y - wleft;
    full = full && kr.y >= qr.w - wleft;
  }
  if (wright >= 0) {
    live = live && kr.y <= qr.w + wright;
    full = full && kr.w <= qr.y + wright;
  }
  return live;
}

// The geometry of head dim kD (64, 128 or 256); kLocalT: the window and
// the softcap; kOptT: segment ids, positions, a bias and dropout.
template <int kD, bool kLocalT, bool kOptT = false>
struct Geo {
  static constexpr bool kLocal = kLocalT;
  static constexpr bool kOpt = kOptT;
  static constexpr int kChunks = kD * 2 / 16;  // 16-byte chunks per row
  static constexpr int kTileBytes = kRows * kD * 2;
  static constexpr int kParts = kD / 64;  // 64-column parts of a tile
  // K9: warpgroups a block, each owning 64 query rows of the block
  static constexpr int kDqWarpgroups = kD == 256 ? 1 : 2;
  static constexpr int kDqThreads = 128 * kDqWarpgroups;
  static constexpr int kDqRows = kRows * kDqWarpgroups;
  static constexpr int kDqMinBlocks = kD == 64 && !kOptT ? 2 : 1;  // blocks an SM
  // K10: two warpgroups a block; at 64 and 128 each owns 64 keys of the
  // block's 128 and all their columns, at 256 both own the block's 64
  // keys, each half of the columns
  static constexpr int kKeyWarpgroups = kD == 256 ? 1 : 2;
  static constexpr int kDkvThreads = 256;
  static constexpr int kDkvRows = kRows * kKeyWarpgroups;
  static constexpr int kOwnParts = kD == 64 ? 1 : 2;  // a warpgroup's parts of dk, dv
  // K9: R(q) and dO of each warpgroup, then two stages of (K, V); K10: K and
  // V of each key warpgroup, then two stages of (R(q), dO) and two of (lse,
  // delta).  + 1024: tiles start at the next 1024-byte boundary (the swizzle
  // atom).
  static constexpr int kDqSmem = (2 * kDqWarpgroups + 4) * kTileBytes + 1024;
  static constexpr int kDkvSmem = (2 * kKeyWarpgroups + 4) * kTileBytes + 2 * kStatBytes + 1024;
  // kOpt: the tile list after those
  static constexpr int kListBytes = kOptT ? kMaxListTiles * 4 : 0;
  // kOpt with a bias: two stages of it after the list.  K9 stages [query
  // row][key] of 128 x 64, a thread reading float2 pairs (rows lane/4 and
  // keys 2 (lane % 4) apart): a pitch of 72 (8 mod 32) puts each half-warp
  // on 32 distinct banks, the two wavefronts that 256 bytes need.  K10
  // stages [query][key] of 64 x 128, a thread reading single floats
  // (queries 2 (lane % 4) and keys lane/4 apart): a pitch of 132 (2 x 132 =
  // 8 mod 32) puts the warp on 32 distinct banks, one wavefront.
  static constexpr int kDqBiasPitch = kRows + 8;
  static constexpr int kDqBiasStage = kDqRows * kDqBiasPitch * 4;
  static constexpr int kDqBiasBytes = kOptT ? 2 * kDqBiasStage : 0;
  static constexpr int kDkvBiasPitch = kDkvRows + 4;
  static constexpr int kDkvBiasStage = kRows * kDkvBiasPitch * 4;
  static constexpr int kDkvBiasBytes = kOptT ? 2 * kDkvBiasStage : 0;
};

// 64 rows from row0 of head hx of a [B, S, Hx, kD] bf16 tensor into the
// tile at dst by cp.async; rows past S are zero-filled (src-size 0).
template <int kD, int kThreads>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* src, int b,
                                          int row0, int S, int Hx, int hx) {
  constexpr int kChunks = kD * 2 / 16;
  for (int i = threadIdx.x; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = row0 + r < S;
    const int64_t g = (((int64_t)b * S + (in ? row0 + r : 0)) * Hx + hx) * kD + c * 8;
    fatt::cp_async16(dst + fatt::sw128<kRows>(r, c), src + g, in ? 16 : 0);
  }
}

// Warpgroup products (sm_90a) on the 128-byte-swizzled tiles of
// fatt::sw128.  A K-major operand of depth step kk starts at
// fatt::kmajor<kRows>(tile, kk); an N-major one of depth step kc at
// tile + part * kPartBytes + kc * 16 * 128.
using fatt::pin;
using fatt::wg_commit;
using fatt::wg_desc;
using fatt::wg_fence;
using fatt::wg_wait_all;
using fatt::wgmma_ss;

// acc (64 x 64) = A (64 x kD) * B (64 x kD)^T, both K-major tiles.
template <int kD>
__device__ __forceinline__ void product_abt(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss(acc, wg_desc(fatt::kmajor<kRows>(a, kk)),
             wg_desc(fatt::kmajor<kRows>(b, kk)), kk > 0);
}

// acc (64 x 64 kN, as kN 64-column parts) += frag (64 x 64 from registers)
// * the first kN parts of tile (64 rows), the tile read N-major.
template <int kN>
__device__ __forceinline__ void product_acc(float (&acc)[kN][32], const uint32_t (&frag)[4][4],
                                            uint32_t tile) {
#pragma unroll
  for (int kc = 0; kc < kRows / 16; ++kc) {
#pragma unroll
    for (int p = 0; p < kN; ++p)
      fatt::wgmma_rs<1>(acc[p], frag[kc], wg_desc(tile + p * kPartBytes + kc * 16 * 128), 1);
  }
}

template <int kN>
__device__ __forceinline__ void pin_parts(float (&acc)[kN][32]) {
#pragma unroll
  for (int p = 0; p < kN; ++p) pin(acc[p]);
}

template <int kN>
__device__ __forceinline__ void zero(float (&d)[kN][32]) {
#pragma unroll
  for (int p = 0; p < kN; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) d[p][i] = 0.f;
}

__device__ __forceinline__ void zero(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// A row's lse in base 2, +inf for a dead row (lse = NEG_INF), so that
// 2^(s - lse2) is 0 there.
__device__ __forceinline__ float lse_base2(float lse) {
  return lse > kNegInf / 2 ? lse * kLog2e : __int_as_float(0x7f800000);
}

// The kLocal instances apply the window (wleft, wright; -1 open) and the
// softcap (softcap2, the cap in base-2 units; 0 for none); the others
// ignore all three.  The kOpt instances apply o (segment ids, positions,
// the bias, dropout), the kSurface ones (kOpt too) also its ALiBi slopes
// and dS; the others ignore it.  kLocal and kOpt together: segment ids
// and positions only, the window on the positions, or on the indices in
// the kWinIdx twin.
template <int kD, bool kLocal, bool kOpt, bool kSurface = false, bool kWinIdx = false>
__global__ void __launch_bounds__(Geo<kD, kLocal, kOpt>::kDqThreads,
                                  Geo<kD, kLocal, kOpt>::kDqMinBlocks) dq_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ cosv, const float* __restrict__ sinv,
    float* __restrict__ dq, __nv_bfloat16* __restrict__ rq, int Sq, int Sk, int H, int Hk,
    int rope_bstride, float scale, int causal, int wleft, int wright, float softcap2,
    const Opt o) {
  using G = Geo<kD, kLocal, kOpt>;
  constexpr int kWarpgroups = G::kDqWarpgroups, kThreads = G::kDqThreads;
  constexpr int kBlockRows = G::kDqRows, kChunks = G::kChunks, kTileBytes = G::kTileBytes;
  constexpr int kParts = G::kParts;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_base = fatt::smem_u32(smem);
  const uint32_t qs0 = (s_base + 1023) & ~1023u;  // R(q) of warpgroup w at qs0 + w tiles
  const uint32_t dos0 = qs0 + kWarpgroups * kTileBytes;  // dO likewise
  // ring stage st: K at ring + 2 st tiles, V after it
  const uint32_t ring = dos0 + kWarpgroups * kTileBytes;
  unsigned char* q_tiles = smem + (qs0 - s_base);

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heavy causal tiles first
  const int kvh = h / (H / Hk);
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const int row0 = qt * kBlockRows;
  const int shift = Sk - Sq;  // bottom-right causal alignment
  // the window compares the indices (kLocal, without masks or kWinIdx) or
  // the positions (kLocal and kOpt); kExtras: the bias and dropout
  constexpr bool kIdxWindow = G::kLocal && (!G::kOpt || kWinIdx);
  constexpr bool kPosWindow = G::kLocal && G::kOpt && !kWinIdx;
  constexpr bool kExtras = G::kOpt && !G::kLocal;

  // The key tiles some row of the block sees: causal and the window's
  // right edge bound them above (at the block's last row), the window's
  // left edge below (at its first row).
  int kv_end = Sk;
  if (causal) kv_end = min(Sk, min(row0 + kBlockRows - 1, Sq - 1) + shift + 1);
  int t_first = 0;
  int n_tiles = kv_end > 0 ? (kv_end + kRows - 1) / kRows : 0;
  if constexpr (kIdxWindow) {
    const int row_last = min(row0 + kBlockRows - 1, Sq - 1);
    if (wright >= 0) kv_end = min(kv_end, row_last + shift + wright + 1);
    const int kv_begin = wleft >= 0 ? max(0, row0 + shift - wleft) : 0;
    t_first = kv_begin / kRows;
    n_tiles = kv_end > kv_begin ? (kv_end + kRows - 1) / kRows - t_first : 0;
  }

  // kOpt with segment ids or positions: the live key tiles, listed.
  const bool meta = G::kOpt && o.qrange != nullptr;
  const int nq64 = (Sq + kRows - 1) / kRows, nk64 = (Sk + kRows - 1) / kRows;
  int* list = reinterpret_cast<int*>(smem + G::kDqSmem);
  int n_live = n_tiles;
  if constexpr (G::kOpt) {
    __shared__ int warp_live[kThreads / 32];
    if (meta) {
      const int4 qr = tile_range(o.qrange + (int64_t)b * nq64, row0 / kRows,
                                 kBlockRows / kRows, nq64);
      const int4* kr = o.krange + (int64_t)b * nk64;
      n_live = build_list<kThreads>(list, warp_live, t_first, n_tiles, [&](int t, bool& full) {
        if constexpr (kPosWindow)
          return ranges_live_window(qr, kr[t], wleft, wright, full);
        else
          return ranges_live(qr, kr[t], full);
      });
    }
  }
  // key tile of the walk's step i, and whether no segment or position
  // masks it
  auto tile_of = [&](int i) { return meta ? list[i] & (kFullBit - 1) : t_first + i; };
  auto full_at = [&](int i) { return !meta || (list[i] & kFullBit) != 0; };

  // kOpt with a bias: this (batch, head)'s plane, staged beside K/V in its
  // own two-stage ring after the list (bias_vec: its piece, 0 for none)
  const float* bias_bh = nullptr;
  int bias_vec = 0;
  const uint32_t bias_ring = s_base + G::kDqSmem + G::kListBytes;
  if constexpr (kExtras) {
    if (o.bias != nullptr) {
      bias_bh = o.bias + b * o.bs_b + h * o.bs_h;
      bias_vec = fatt::bias_piece(bias_bh, o.bs_q, o.bs_k);
    }
  }

  auto load_kv = [&](int st, int k0) {
    const uint32_t ks = ring + st * 2 * kTileBytes;
    load_tile<kD, kThreads>(ks, k, b, k0, Sk, Hk, kvh);
    load_tile<kD, kThreads>(ks + kTileBytes, v, b, k0, Sk, Hk, kvh);
    if constexpr (G::kOpt) {
      if (bias_vec != 0)
        fatt::load_bias<kBlockRows, kRows, G::kDqBiasPitch, kThreads>(
            bias_ring + st * G::kDqBiasStage, bias_bh + row0 * o.bs_q + k0 * o.bs_k, o.bs_q,
            o.bs_k, Sq - row0, Sk - k0, bias_vec);
    }
  };
#pragma unroll
  for (int w = 0; w < kWarpgroups; ++w) {
    load_tile<kD, kThreads>(dos0 + w * kTileBytes, dout, b, row0 + w * kRows, Sq, H, h);
    if (cosv == nullptr)
      load_tile<kD, kThreads>(qs0 + w * kTileBytes, q, b, row0 + w * kRows, Sq, H, h);
  }
  if (n_live > 0) load_kv(0, tile_of(0) * kRows);
  fatt::cp_async_commit();

  // R(q): rotate-half in fp32 with each row's cos/sin, products rounded
  // apart (no fused multiply-add) as PyTorch's elementwise ops round them,
  // then bf16.  Chunk c (columns 8c..8c+7) and its partner c + kChunks/2
  // go to the tiles and, when rq is given, to device memory; rows >= Sq
  // are zero.
  if (cosv != nullptr) {
    for (int i = tid; i < kBlockRows * (kChunks / 2); i += kThreads) {
      const int r = i / (kChunks / 2), c = i % (kChunks / 2);
      const int gq = row0 + r;
      uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
      if (gq < Sq) {
        const int64_t g = (((int64_t)b * Sq + gq) * H + h) * kD + c * 8;
        const uint4 x1 = *reinterpret_cast<const uint4*>(q + g);
        const uint4 x2 = *reinterpret_cast<const uint4*>(q + g + kD / 2);
        const int64_t t = (int64_t)b * rope_bstride + (int64_t)gq * (kD / 2) + c * 8;
        float cs[8], sn[8];
        *reinterpret_cast<float4*>(cs) = *reinterpret_cast<const float4*>(cosv + t);
        *reinterpret_cast<float4*>(cs + 4) = *reinterpret_cast<const float4*>(cosv + t + 4);
        *reinterpret_cast<float4*>(sn) = *reinterpret_cast<const float4*>(sinv + t);
        *reinterpret_cast<float4*>(sn + 4) = *reinterpret_cast<const float4*>(sinv + t + 4);
        const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(&x1);
        const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&x2);
        uint32_t o1[4], o2[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 fa = __bfloat1622float2(a[u]), fe = __bfloat1622float2(e[u]);
          const float c0 = cs[2 * u], c1 = cs[2 * u + 1], s0 = sn[2 * u], s1 = sn[2 * u + 1];
          o1[u] = fatt::pack_bf16(__fsub_rn(__fmul_rn(fa.x, c0), __fmul_rn(fe.x, s0)),
                                  __fsub_rn(__fmul_rn(fa.y, c1), __fmul_rn(fe.y, s1)));
          o2[u] = fatt::pack_bf16(__fadd_rn(__fmul_rn(fe.x, c0), __fmul_rn(fa.x, s0)),
                                  __fadd_rn(__fmul_rn(fe.y, c1), __fmul_rn(fa.y, s1)));
        }
        lo = make_uint4(o1[0], o1[1], o1[2], o1[3]);
        hi = make_uint4(o2[0], o2[1], o2[2], o2[3]);
        if (rq != nullptr) {
          *reinterpret_cast<uint4*>(rq + g) = lo;
          *reinterpret_cast<uint4*>(rq + g + kD / 2) = hi;
        }
      }
      unsigned char* tile = q_tiles + (r / kRows) * kTileBytes;
      *reinterpret_cast<uint4*>(tile + fatt::sw128<kRows>(r % kRows, c)) = lo;
      *reinterpret_cast<uint4*>(tile + fatt::sw128<kRows>(r % kRows, c + kChunks / 2)) = hi;
    }
  }

  // This warpgroup's tiles; this thread's rows: wrow0 + lane/4
  // (accumulator entries 0, 1 of each n8 block) and 8 below it (entries 2, 3).
  const uint32_t qs = qs0 + wg * kTileBytes, dos = dos0 + wg * kTileBytes;
  const int wrow0 = row0 + wg * kRows + warp * 16;
  const int my_row = wrow0 + (lane >> 2);
  const float sl2 = scale * kLog2e;
  // with the cap: t = tanh(s * scale / cap) = tanh(s * cap_in)
  const bool capped = G::kLocal && softcap2 > 0.f;
  const float cap_in = capped ? sl2 / softcap2 : 0.f;
  float l2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = my_row + hf * 8;
    const int64_t r = ((int64_t)b * H + h) * Sq + row;
    l2[hf] = lse_base2(row < Sq ? lse[r] : kNegInf);
    dl[hf] = row < Sq ? delta[r] : 0.f;
  }
  // kOpt: this thread's rows' (segment, position), its first staged bias
  // pair (row my_row, keys 2 (lane % 4) + {0, 1} of stage 0) and its rows'
  // part of the dropout hash
  int2 qm[2] = {make_int2(0, 0), make_int2(0, 0)};
  const float* bias_my = reinterpret_cast<const float*>(smem + (bias_ring - s_base)) +
                         (my_row - row0) * G::kDqBiasPitch + 2 * (lane & 3);
  uint32_t drop_rows[2] = {0u, 0u};
  if constexpr (G::kOpt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = my_row + hf * 8;
      if (meta && row < nq64 * kRows) qm[hf] = o.qmeta[(int64_t)b * nq64 * kRows + row];
    }
    const uint32_t mix = fatt::drop_mix(o.seed, b, h);
    drop_rows[0] = fatt::drop_row(mix, my_row);
    drop_rows[1] = fatt::drop_row(mix, my_row + 8);
  }
  const int2* kmeta_b = G::kOpt && meta ? o.kmeta + (int64_t)b * nk64 * kRows : nullptr;
  // kSurface: the query head's ALiBi slope (base 2) and this thread's
  // first row of dS
  const bool has_alibi = kSurface && o.alibi2 != nullptr;
  const float slope2 = has_alibi ? o.alibi2[h] : 0.f;
  float* const ds_row =
      kSurface && o.ds != nullptr ? o.ds + (((int64_t)b * H + h) * Sq + my_row) * Sk : nullptr;

  float acc[kParts][32];  // dq, 64-column parts
  zero(acc);
  for (int t = 0; t < n_live; ++t) {
    if (t + 1 < n_live) load_kv((t + 1) & 1, tile_of(t + 1) * kRows);
    fatt::cp_async_commit();
    fatt::cp_async_wait<1>();
    // cp.async and the R(q) stores -> wgmma's reads
    fatt::fence_proxy_async();
    __syncthreads();
    const uint32_t ks = ring + (t & 1) * 2 * kTileBytes;
    const uint32_t vs = ks + kTileBytes;
    const int k0 = tile_of(t) * kRows;

    float s[32], dp[32];
    zero(s);
    zero(dp);
    pin(s);
    pin(dp);
    wg_fence();
    product_abt<kD>(s, qs, ks);    // S = R(q) K^T
    product_abt<kD>(dp, dos, vs);  // dP = dO V^T
    wg_commit();
    // kOpt with a bias: this thread's staged entries (rows my_row + 8 (e >>
    // 1), keys 8j + 2 (lane % 4) + (e & 1)) read while the products run
    float bb[G::kOpt ? 32 : 1];
    if constexpr (G::kOpt) {
      if (bias_vec != 0) {
        const float* bias_t = bias_my + (t & 1) * (G::kDqBiasStage / 4);
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float2 z =
                *reinterpret_cast<const float2*>(bias_t + hf * 8 * G::kDqBiasPitch + j * 8);
            bb[4 * j + 2 * hf] = z.x;
            bb[4 * j + 2 * hf + 1] = z.y;
          }
      }
    }
    wg_wait_all();
    pin(s);
    pin(dp);

    // dS = P (dP - delta) (with the cap, times 1 - t^2), masked only where
    // this warp's diagonal, a window edge of its rows or Sk's edge crosses
    // the tile, packed to bf16 A fragments (keys 16c..16c+15).
    bool edge = k0 + kRows > Sk || (causal && k0 + kRows - 1 > wrow0 + shift);
    if constexpr (kIdxWindow) {
      if (wright >= 0) edge = edge || k0 + kRows - 1 > wrow0 + shift + wright;
      if (wleft >= 0) edge = edge || k0 < wrow0 + 15 + shift - wleft;
    }
    uint32_t dsf[4][4];
    if constexpr (!G::kOpt) {
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        float x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p, dt = 1.f;
          if (capped) {
            const float tc = fatt::tanh_exp2(s[4 * j + e] * cap_in);
            p = exp2f(fmaf(tc, softcap2, -l2[e >> 1]));
            dt = 1.f - tc * tc;
          } else {
            p = exp2f(fmaf(s[4 * j + e], sl2, -l2[e >> 1]));
          }
          if (edge) {
            const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
            const int row = my_row + (e >> 1) * 8;
            bool dead = col >= Sk || (causal && col > row + shift);
            if constexpr (G::kLocal)
              dead = dead || (wleft >= 0 && col < row + shift - wleft) ||
                     (wright >= 0 && col > row + shift + wright);
            if (dead) p = 0.f;
          }
          x[e] = p * (dp[4 * j + e] - dl[e >> 1]);
          if (capped) x[e] *= dt;
        }
        dsf[j / 2][(j & 1) * 2] = fatt::pack_bf16(x[0], x[1]);
        dsf[j / 2][(j & 1) * 2 + 1] = fatt::pack_bf16(x[2], x[3]);
      }
    } else {
      // kOpt: the bias on the scores, the segment and position masks where
      // the list does not say the tile is live throughout, and the
      // dropout's replay on dP; with kLocal (no bias, no dropout) the
      // softcap and the window instead
      const bool seg_mask = !full_at(t);
      edge = edge || seg_mask;
      // the tile's elements with the dropout's replay (kDrop) or without:
      // one branch a tile (a branch an element, taken or not, kept the loop
      // from being scheduled as one block and measured slower)
      auto elements = [&](auto drop) {
        constexpr bool kDrop = decltype(drop)::value;
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
          float x[4];
          // keys c and c + 1 of the tile: (segment, position) each
          int4 km = make_int4(0, 0, 0, 0);
          if (seg_mask)
            km = __ldg(reinterpret_cast<const int4*>(kmeta_b + k0 + j * 8 + (lane & 3) * 2));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
            const int row = my_row + (e >> 1) * 8;
            float a = -l2[e >> 1];
            if (bias_vec != 0) a = fmaf(bb[4 * j + e], kLog2e, a);
            if constexpr (kSurface) {
              if (has_alibi) a = fmaf(-slope2, (float)abs(row + shift - col), a);
            }
            float p;
            [[maybe_unused]] float dt = 1.f;
            if constexpr (G::kLocal) {
              if (capped) {
                const float tc = fatt::tanh_exp2(s[4 * j + e] * cap_in);
                p = exp2f(fmaf(tc, softcap2, a));
                dt = 1.f - tc * tc;
              } else {
                p = exp2f(fmaf(s[4 * j + e], sl2, a));
              }
            } else {
              p = exp2f(fmaf(s[4 * j + e], sl2, a));
            }
            if (edge) {
              bool dead = col >= Sk || (causal && col > row + shift);
              if constexpr (kIdxWindow)
                dead = dead || (wleft >= 0 && col < row + shift - wleft) ||
                       (wright >= 0 && col > row + shift + wright);
              if (seg_mask) {
                const int kseg = (e & 1) ? km.z : km.x, kpos = (e & 1) ? km.w : km.y;
                dead = dead || kseg != qm[e >> 1].x || kpos > qm[e >> 1].y;
                if constexpr (kPosWindow)
                  dead = dead || (wleft >= 0 && kpos < qm[e >> 1].y - wleft) ||
                         (wright >= 0 && kpos > qm[e >> 1].y + wright);
              }
              if (dead) p = 0.f;
            }
            float dpv = dp[4 * j + e];
            if constexpr (kDrop)
              dpv = fatt::drop_keep(drop_rows[e >> 1], col, o.threshold) ? dpv * o.inv_keep : 0.f;
            x[e] = p * (dpv - dl[e >> 1]);
            if constexpr (G::kLocal) {
              if (capped) x[e] *= dt;
            }
          }
          if constexpr (kSurface) {
            // dbias: this thread's dS pairs, rows my_row and my_row + 8
            if (ds_row != nullptr) {
              const int c = k0 + j * 8 + (lane & 3) * 2;
              if (my_row < Sq) store_pair(ds_row, c, Sk, x[0], x[1]);
              if (my_row + 8 < Sq) store_pair(ds_row + 8 * (int64_t)Sk, c, Sk, x[2], x[3]);
            }
          }
          dsf[j / 2][(j & 1) * 2] = fatt::pack_bf16(x[0], x[1]);
          dsf[j / 2][(j & 1) * 2 + 1] = fatt::pack_bf16(x[2], x[3]);
        }
      };
      if (kExtras && o.dropout)
        elements(std::true_type{});
      else
        elements(std::false_type{});
    }

    pin_parts(acc);
    wg_fence();
    product_acc(acc, dsf, ks);  // dq += dS K
    wg_commit();
    wg_wait_all();
    pin_parts(acc);
    __syncthreads();  // the stage is consumed before the ring refills it
  }
  fatt::cp_async_wait<0>();

  // dq = scale * acc, pulled back through the rotation (R^-1 = R(-angle))
  // in fp32: column c < kD/2, in 8-column block jj of the row, and its
  // partner c + kD/2 in block jj + kD/16; block n is fragment block n % 8
  // of part n / 8 (at head_dim 64 both lie in the one part).
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = my_row + hf * 8;
    if (row >= Sq) continue;
    float* dst = dq + (((int64_t)b * Sq + row) * H + h) * kD;
    const int64_t t = (int64_t)b * rope_bstride + (int64_t)row * (kD / 2);
#pragma unroll
    for (int jj = 0; jj < kD / 16; ++jj) {
      constexpr int kHalf = kD / 16;
      const int p1 = jj / 8, e1 = 4 * (jj % 8) + 2 * hf;
      const int p2 = (jj + kHalf) / 8, e2 = 4 * ((jj + kHalf) % 8) + 2 * hf;
      const int c = jj * 8 + (lane & 3) * 2;
      float x1[2] = {acc[p1][e1] * scale, acc[p1][e1 + 1] * scale};
      float x2[2] = {acc[p2][e2] * scale, acc[p2][e2 + 1] * scale};
      if (cosv != nullptr) {
        const float2 cs = *reinterpret_cast<const float2*>(cosv + t + c);
        const float2 sn = *reinterpret_cast<const float2*>(sinv + t + c);
        const float cv[2] = {cs.x, cs.y}, sv[2] = {sn.x, sn.y};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float o1 = __fadd_rn(__fmul_rn(x1[u], cv[u]), __fmul_rn(x2[u], sv[u]));
          const float o2 = __fsub_rn(__fmul_rn(x2[u], cv[u]), __fmul_rn(x1[u], sv[u]));
          x1[u] = o1;
          x2[u] = o2;
        }
      }
      *reinterpret_cast<float2*>(dst + c) = make_float2(x1[0], x1[1]);
      *reinterpret_cast<float2*>(dst + c + kD / 2) = make_float2(x2[0], x2[1]);
    }
  }
}

template <int kD, bool kLocal, bool kOpt, bool kSurface = false, bool kWinIdx = false>
__global__ void __launch_bounds__(Geo<kD, kLocal, kOpt>::kDkvThreads, 1) dkv_kernel(
    const __nv_bfloat16* __restrict__ rq, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, int H, int Hk,
    float scale, int causal, int wleft, int wright, float softcap2, const Opt o) {
  using G = Geo<kD, kLocal, kOpt>;
  constexpr int kKeyWgs = G::kKeyWarpgroups, kThreads = G::kDkvThreads;
  constexpr int kBlockRows = G::kDkvRows, kTileBytes = G::kTileBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_base = fatt::smem_u32(smem);
  const uint32_t ks0 = (s_base + 1023) & ~1023u;  // K of key warpgroup w at ks0 + w tiles
  const uint32_t vs0 = ks0 + kKeyWgs * kTileBytes;  // V likewise
  // ring stage st: R(q) at ring + 2 st tiles, dO after it
  const uint32_t ring = vs0 + kKeyWgs * kTileBytes;
  const uint32_t stats = ring + 4 * kTileBytes;  // stage st: lse then delta, 64 each
  const float* stats_ptr = reinterpret_cast<const float*>(smem + (stats - s_base));

  const int h = blockIdx.x, b = blockIdx.y, kt = blockIdx.z;  // kt 0 first: the most work
  const int kvh = h / (H / Hk);
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const int k0 = kt * kBlockRows;
  const int shift = Sk - Sq;
  // as K9's
  constexpr bool kIdxWindow = G::kLocal && (!G::kOpt || kWinIdx);
  constexpr bool kPosWindow = G::kLocal && G::kOpt && !kWinIdx;
  constexpr bool kExtras = G::kOpt && !G::kLocal;

  // First live query tile: (k0, qt) is live iff k0 <= qt*64 + 63 + shift.
  int qt0 = 0;
  if (causal) {
    const int t = k0 - shift - (kRows - 1);
    qt0 = t > 0 ? (t + kRows - 1) / kRows : 0;
  }
  int n_iter = max((Sq + kRows - 1) / kRows - qt0, 0);
  if constexpr (kIdxWindow) {
    // the window's right edge bounds the first live query tile as causal
    // does; its left edge the last: the last tile whose first row lies
    // within the block's last key + left
    if (wright >= 0) {
      const int t = k0 - shift - wright - (kRows - 1);
      qt0 = max(qt0, t > 0 ? (t + kRows - 1) / kRows : 0);
    }
    int qt_end = (Sq + kRows - 1) / kRows;
    if (wleft >= 0) {
      const int q_hi = min(k0 + kBlockRows - 1, Sk - 1) - shift + wleft;
      qt_end = min(qt_end, q_hi >= 0 ? q_hi / kRows + 1 : 0);
    }
    n_iter = max(qt_end - qt0, 0);
  }

  // kOpt with segment ids or positions: the live query tiles, listed.
  const bool meta = G::kOpt && o.qrange != nullptr;
  const int nq64 = (Sq + kRows - 1) / kRows, nk64 = (Sk + kRows - 1) / kRows;
  int* list = reinterpret_cast<int*>(smem + G::kDkvSmem);
  if constexpr (G::kOpt) {
    __shared__ int warp_live[kThreads / 32];
    if (meta) {
      const int4 kr = tile_range(o.krange + (int64_t)b * nk64, k0 / kRows,
                                 kBlockRows / kRows, nk64);
      const int4* qr = o.qrange + (int64_t)b * nq64;
      n_iter = build_list<kThreads>(list, warp_live, qt0, n_iter, [&](int t, bool& full) {
        if constexpr (kPosWindow)
          return ranges_live_window(qr[t], kr, wleft, wright, full);
        else
          return ranges_live(qr[t], kr, full);
      });
    }
  }
  // query tile of the walk's step it, and whether no segment or position
  // masks it
  auto tile_of = [&](int it) { return meta ? list[it] & (kFullBit - 1) : qt0 + it; };
  auto full_at = [&](int it) { return !meta || (list[it] & kFullBit) != 0; };

  // kOpt with a bias: this (batch, head)'s plane, staged beside R(q)/dO in
  // its own two-stage ring after the list (bias_vec: its piece, 0 for none)
  const float* bias_bh = nullptr;
  int bias_vec = 0;
  const uint32_t bias_ring = s_base + G::kDkvSmem + G::kListBytes;
  if constexpr (kExtras) {
    if (o.bias != nullptr) {
      bias_bh = o.bias + b * o.bs_b + h * o.bs_h;
      bias_vec = fatt::bias_piece(bias_bh, o.bs_q, o.bs_k);
    }
  }

  // R(q), dO, lse and delta (kOpt: and the bias) of query tile tile_of(it)
  // into ring stage st.
  auto load_q = [&](int st, int it) {
    const int q0 = tile_of(it) * kRows;
    const uint32_t rs = ring + st * 2 * kTileBytes;
    load_tile<kD, kThreads>(rs, rq, b, q0, Sq, H, h);
    load_tile<kD, kThreads>(rs + kTileBytes, dout, b, q0, Sq, H, h);
    if (tid < 2 * kRows) {
      const int gq = q0 + (tid % kRows);
      const bool in = gq < Sq;
      const float* src = (tid < kRows ? lse : delta) + ((int64_t)b * H + h) * Sq + (in ? gq : 0);
      fatt::cp_async4(stats + st * kStatBytes + tid * 4, src, in ? 4 : 0);
    }
    if constexpr (G::kOpt) {
      if (bias_vec != 0)
        fatt::load_bias<kRows, kBlockRows, G::kDkvBiasPitch, kThreads>(
            bias_ring + st * G::kDkvBiasStage, bias_bh + q0 * o.bs_q + k0 * o.bs_k, o.bs_q,
            o.bs_k, Sq - q0, Sk - k0, bias_vec);
    }
  };
#pragma unroll
  for (int w = 0; w < kKeyWgs; ++w) {
    load_tile<kD, kThreads>(ks0 + w * kTileBytes, k, b, k0 + w * kRows, Sk, Hk, kvh);
    load_tile<kD, kThreads>(vs0 + w * kTileBytes, v, b, k0 + w * kRows, Sk, Hk, kvh);
  }
  if (n_iter > 0) load_q(0, 0);
  fatt::cp_async_commit();

  // This warpgroup's keys (kw) and its columns of dk and dv (cw); this
  // thread's keys: wkey0 + lane/4 (accumulator entries 0, 1) and 8 below
  // it (entries 2, 3); its queries 8j + 2 (lane % 4) + {0, 1}.
  constexpr int kOwn = G::kOwnParts;
  const int kw = kKeyWgs == 2 ? wg : 0, cw = kKeyWgs == 2 ? 0 : wg;
  const uint32_t ks = ks0 + kw * kTileBytes, vs = vs0 + kw * kTileBytes;
  const int wkey0 = k0 + kw * kRows + warp * 16;
  const int my_key = wkey0 + (lane >> 2);
  const float sl2 = scale * kLog2e;
  const bool capped = G::kLocal && softcap2 > 0.f;
  const float cap_in = capped ? sl2 / softcap2 : 0.f;
  // kOpt: this thread's keys' (segment, position), its first staged bias
  // entry (query 2 (lane % 4), key my_key of stage 0) and the dropout
  // hash's mix
  int2 km[2] = {make_int2(0, 0), make_int2(0, 0)};
  const float* bias_my = reinterpret_cast<const float*>(smem + (bias_ring - s_base)) +
                         2 * (lane & 3) * G::kDkvBiasPitch + (my_key - k0);
  uint32_t mix = 0u;
  if constexpr (G::kOpt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = my_key + hf * 8;
      if (meta && key < nk64 * kRows) km[hf] = o.kmeta[(int64_t)b * nk64 * kRows + key];
    }
    mix = fatt::drop_mix(o.seed, b, h);
  }
  const int2* qmeta_b = G::kOpt && meta ? o.qmeta + (int64_t)b * nq64 * kRows : nullptr;
  // kSurface: the query head's ALiBi slope (base 2)
  const bool has_alibi = kSurface && o.alibi2 != nullptr;
  const float slope2 = has_alibi ? o.alibi2[h] : 0.f;
  float dk_acc[kOwn][32], dv_acc[kOwn][32];  // 64-column parts of this warpgroup's
  zero(dk_acc);
  zero(dv_acc);
  for (int it = 0; it < n_iter; ++it) {
    if (it + 1 < n_iter) load_q((it + 1) & 1, it + 1);
    fatt::cp_async_commit();
    fatt::cp_async_wait<1>();
    fatt::fence_proxy_async();  // cp.async -> wgmma
    __syncthreads();
    const uint32_t rs = ring + (it & 1) * 2 * kTileBytes;
    const uint32_t ds = rs + kTileBytes;
    const float* lse_s = stats_ptr + (it & 1) * 2 * kRows;
    const float* delta_s = lse_s + kRows;
    const int q0 = tile_of(it) * kRows;

    float st[32], dpt[32];
    zero(st);
    zero(dpt);
    pin(st);
    pin(dpt);
    wg_fence();
    product_abt<kD>(st, ks, rs);   // S^T = K R(q)^T
    product_abt<kD>(dpt, vs, ds);  // dP^T = V dO^T
    wg_commit();
    wg_wait_all();
    pin(st);
    pin(dpt);

    // P^T and dS^T = P^T (dP^T - delta) (with the cap, times 1 - t^2),
    // masked only where this warp's diagonal, a window edge or a ragged
    // edge crosses the tile, packed to bf16 A fragments (queries
    // 16c..16c+15).
    bool edge = wkey0 + 16 > Sk || q0 + kRows > Sq || (causal && wkey0 + 15 > q0 + shift);
    if constexpr (kIdxWindow) {
      if (wleft >= 0) edge = edge || wkey0 < q0 + kRows - 1 + shift - wleft;
      if (wright >= 0) edge = edge || wkey0 + 15 > q0 + shift + wright;
    }
    uint32_t pf[4][4], dsf[4][4];
    if constexpr (!G::kOpt) {
#pragma unroll
      for (int j = 0; j < kRows / 8; ++j) {
        const int c = j * 8 + (lane & 3) * 2;
        const float2 l = *reinterpret_cast<const float2*>(lse_s + c);
        const float2 d = *reinterpret_cast<const float2*>(delta_s + c);
        const float l2[2] = {lse_base2(l.x), lse_base2(l.y)}, dl[2] = {d.x, d.y};
        float p[4], x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dt = 1.f;
          if (capped) {
            const float tc = fatt::tanh_exp2(st[4 * j + e] * cap_in);
            p[e] = exp2f(fmaf(tc, softcap2, -l2[e & 1]));
            dt = 1.f - tc * tc;
          } else {
            p[e] = exp2f(fmaf(st[4 * j + e], sl2, -l2[e & 1]));
          }
          if (edge) {
            const int key = my_key + (e >> 1) * 8, col = q0 + c + (e & 1);
            bool dead = key >= Sk || col >= Sq || (causal && key > col + shift);
            if constexpr (G::kLocal)
              dead = dead || (wleft >= 0 && key < col + shift - wleft) ||
                     (wright >= 0 && key > col + shift + wright);
            if (dead) p[e] = 0.f;
          }
          x[e] = p[e] * (dpt[4 * j + e] - dl[e & 1]);
          if (capped) x[e] *= dt;
        }
        pf[j / 2][(j & 1) * 2] = fatt::pack_bf16(p[0], p[1]);
        pf[j / 2][(j & 1) * 2 + 1] = fatt::pack_bf16(p[2], p[3]);
        dsf[j / 2][(j & 1) * 2] = fatt::pack_bf16(x[0], x[1]);
        dsf[j / 2][(j & 1) * 2 + 1] = fatt::pack_bf16(x[2], x[3]);
      }
    } else {
      // kOpt: the bias on the scores, the segment and position masks where
      // the list does not say the tile is live throughout, and the
      // dropout's replay on P (for dv) and dP; with kLocal (no bias, no
      // dropout) the softcap and the window instead
      const bool seg_mask = !full_at(it);
      edge = edge || seg_mask;
      const float* bias_t = bias_my + (it & 1) * (G::kDkvBiasStage / 4);
      // the tile's elements with the dropout's replay (kDrop) or without:
      // one branch a tile, as in K9
      auto elements = [&](auto drop) {
        constexpr bool kDrop = decltype(drop)::value;
#pragma unroll
        for (int j = 0; j < kRows / 8; ++j) {
          const int c = j * 8 + (lane & 3) * 2;
          const float2 l = *reinterpret_cast<const float2*>(lse_s + c);
          const float2 d = *reinterpret_cast<const float2*>(delta_s + c);
          const float l2[2] = {lse_base2(l.x), lse_base2(l.y)}, dl[2] = {d.x, d.y};
          // queries c and c + 1 of the tile: (segment, position) each
          int4 qm = make_int4(0, 0, 0, 0);
          if (seg_mask) qm = __ldg(reinterpret_cast<const int4*>(qmeta_b + q0 + c));
          float pd[4], x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = my_key + (e >> 1) * 8, col = q0 + c + (e & 1);
            float a = -l2[e & 1];
            // the bias at (query c + (e & 1), key my_key + 8 (e >> 1)), staged
            if (bias_vec != 0)
              a = fmaf(bias_t[(j * 8 + (e & 1)) * G::kDkvBiasPitch + (e >> 1) * 8], kLog2e, a);
            // kSurface: ALiBi at (query col, key), |col + shift - key|
            if constexpr (kSurface) {
              if (has_alibi) a = fmaf(-slope2, (float)abs(col + shift - key), a);
            }
            float p;
            [[maybe_unused]] float dt = 1.f;
            if constexpr (G::kLocal) {
              if (capped) {
                const float tc = fatt::tanh_exp2(st[4 * j + e] * cap_in);
                p = exp2f(fmaf(tc, softcap2, a));
                dt = 1.f - tc * tc;
              } else {
                p = exp2f(fmaf(st[4 * j + e], sl2, a));
              }
            } else {
              p = exp2f(fmaf(st[4 * j + e], sl2, a));
            }
            if (edge) {
              bool dead = key >= Sk || col >= Sq || (causal && key > col + shift);
              if constexpr (kIdxWindow)
                dead = dead || (wleft >= 0 && key < col + shift - wleft) ||
                       (wright >= 0 && key > col + shift + wright);
              if (seg_mask) {
                const int qseg = (e & 1) ? qm.z : qm.x, qpos = (e & 1) ? qm.w : qm.y;
                dead = dead || km[e >> 1].x != qseg || km[e >> 1].y > qpos;
                if constexpr (kPosWindow)
                  dead = dead || (wleft >= 0 && km[e >> 1].y < qpos - wleft) ||
                         (wright >= 0 && km[e >> 1].y > qpos + wright);
              }
              if (dead) p = 0.f;
            }
            float dpv = dpt[4 * j + e];
            pd[e] = p;
            if constexpr (kDrop) {
              const bool keep = fatt::drop_keep(fatt::drop_row(mix, col), key, o.threshold);
              dpv = keep ? dpv * o.inv_keep : 0.f;
              pd[e] = keep ? p * o.inv_keep : 0.f;
            }
            x[e] = p * (dpv - dl[e & 1]);
            if constexpr (G::kLocal) {
              if (capped) x[e] *= dt;
            }
          }
          pf[j / 2][(j & 1) * 2] = fatt::pack_bf16(pd[0], pd[1]);
          pf[j / 2][(j & 1) * 2 + 1] = fatt::pack_bf16(pd[2], pd[3]);
          dsf[j / 2][(j & 1) * 2] = fatt::pack_bf16(x[0], x[1]);
          dsf[j / 2][(j & 1) * 2 + 1] = fatt::pack_bf16(x[2], x[3]);
        }
      };
      if (kExtras && o.dropout)
        elements(std::true_type{});
      else
        elements(std::false_type{});
    }

    pin_parts(dv_acc);
    pin_parts(dk_acc);
    wg_fence();
    product_acc(dv_acc, pf, ds + cw * kOwn * kPartBytes);   // dv += P^T dO
    product_acc(dk_acc, dsf, rs + cw * kOwn * kPartBytes);  // dk += dS^T R(q)
    wg_commit();
    wg_wait_all();
    pin_parts(dv_acc);
    pin_parts(dk_acc);
    __syncthreads();  // the stage is consumed before the ring refills it
  }
  fatt::cp_async_wait<0>();

  // fp32 [B, H, Sk, D] rows of this thread's keys, this warpgroup's columns.
  const int64_t base = ((int64_t)b * H + h) * Sk;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = my_key + hf * 8;
    if (key >= Sk) continue;
    float* dkr = dk + (base + key) * kD + cw * kOwn * 64;
    float* dvr = dv + (base + key) * kD + cw * kOwn * 64;
#pragma unroll
    for (int j = 0; j < kRows / 8; ++j) {
      const int c = j * 8 + (lane & 3) * 2, e = 4 * j + 2 * hf;
#pragma unroll
      for (int p = 0; p < kOwn; ++p)
        *reinterpret_cast<float2*>(dkr + c + p * 64) =
            make_float2(dk_acc[p][e] * scale, dk_acc[p][e + 1] * scale);
#pragma unroll
      for (int p = 0; p < kOwn; ++p)
        *reinterpret_cast<float2*>(dvr + c + p * 64) = make_float2(dv_acc[p][e], dv_acc[p][e + 1]);
    }
  }
}

// Head dims 64 (GPT-2), 128 (Llama-3, Gemma-2-27B) and 256 (Gemma-2-9B;
// causal only) are built; a window or a softcap at head_dim 128 and 256.
bool shape_ok(int B, int Sq, int Sk, int H, int Hk, int D, int causal, int wleft, int wright,
              float softcap2) {
  const bool local = wleft >= 0 || wright >= 0 || softcap2 > 0.f;
  // the smaller of K9's and K10's block rows (at 64 and 128 both 128)
  const int rows = D == 256 ? kRows : Geo<128, false>::kDqRows;
  return Sq > 0 && Sk > 0 && Hk > 0 && H % Hk == 0 && (D == 64 || D == 128 || D == 256) &&
         B <= 65535 && (Sq + rows - 1) / rows <= 65535 && (Sk + rows - 1) / rows <= 65535 &&
         wleft >= -1 && wright >= -1 && softcap2 >= 0.f && !(local && D == 64) &&
         !(D == 256 && !causal);
}

template <int kD, bool kLocal, bool kOpt, bool kSurface = false, bool kWinIdx = false>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* cosv, const void* sinv, void* dq, void* rq,
              int B, int Sq, int Sk, int H, int Hk, int rope_bstride, float scale, int causal,
              int wleft, int wright, float softcap2, const Opt& o, cudaStream_t st) {
  using G = Geo<kD, kLocal, kOpt>;
  // the bias's stages only when a bias is given
  constexpr int kSmem = G::kDqSmem + G::kListBytes;
  static fatt::SmemLimitSet smem_set;
  cudaError_t e =
      fatt::smem_limit_once(dq_kernel<kD, kLocal, kOpt, kSurface, kWinIdx>,
                            kSmem + G::kDqBiasBytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  const int smem = kSmem + (o.bias != nullptr ? G::kDqBiasBytes : 0);
  dim3 grid(H, B, (Sq + G::kDqRows - 1) / G::kDqRows);
  dq_kernel<kD, kLocal, kOpt, kSurface, kWinIdx><<<grid, G::kDqThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(cosv), static_cast<const float*>(sinv),
      static_cast<float*>(dq), static_cast<__nv_bfloat16*>(rq), Sq, Sk, H, Hk, rope_bstride,
      scale, causal, wleft, wright, softcap2, o);
  return (int)cudaGetLastError();
}

template <int kD, bool kLocal, bool kOpt, bool kSurface = false, bool kWinIdx = false>
int launch_dkv(const void* rq, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B, int Sq, int Sk,
               int H, int Hk, float scale, int causal, int wleft, int wright, float softcap2,
               const Opt& o, cudaStream_t st) {
  using G = Geo<kD, kLocal, kOpt>;
  // the bias's stages only when a bias is given
  constexpr int kSmem = G::kDkvSmem + G::kListBytes;
  static fatt::SmemLimitSet smem_set;
  cudaError_t e =
      fatt::smem_limit_once(dkv_kernel<kD, kLocal, kOpt, kSurface, kWinIdx>,
                            kSmem + G::kDkvBiasBytes, smem_set);
  if (e != cudaSuccess) return (int)e;
  const int smem = kSmem + (o.bias != nullptr ? G::kDkvBiasBytes : 0);
  dim3 grid(H, B, (Sk + G::kDkvRows - 1) / G::kDkvRows);
  dkv_kernel<kD, kLocal, kOpt, kSurface, kWinIdx><<<grid, G::kDkvThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(rq), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, H, Hk, scale, causal, wleft,
      wright, softcap2, o);
  return (int)cudaGetLastError();
}

// The kOpt arguments of a C entry, checked: the four tile-metadata
// pointers all or none (with at most kMaxListTiles tiles a side), kOpt
// only at head_dim 64 and 128, and with a window or softcap only the tile
// metadata, at head_dim 128.  Sets opt when any option is given.
bool opt_ok(const Opt& o, int Sq, int Sk, int D, bool local, bool& opt) {
  const int given = (o.qmeta != nullptr) + (o.kmeta != nullptr) + (o.qrange != nullptr) +
                    (o.krange != nullptr);
  const bool extra = o.bias != nullptr || o.dropout != 0 || o.alibi2 != nullptr ||
                     o.ds != nullptr;
  opt = given != 0 || extra;
  if (!opt) return true;
  return (given == 0 || given == 4) && (D == 64 || D == 128) &&
         !(local && (D != 128 || extra)) &&
         (Sq + kRows - 1) / kRows <= kMaxListTiles && (Sk + kRows - 1) / kRows <= kMaxListTiles &&
         (o.dropout == 0 || o.inv_keep > 0.f);
}

}  // namespace

// q, dout [B, Sq, H, D]; k, v [B, Sk, Hk, D] bf16; lse, delta [B, H, Sq]
// fp32; cos/sin [B or 1, Sq, D/2] fp32 with batch stride rope_bstride (0
// when shared), or both null.  dq: [B, Sq, H, D] fp32, w.r.t. un-rotated q.
// rq (with the tables, else unused): [B, Sq, H, D] bf16, R(q) for K10.
// window_left / window_right: the window's sides (-1 open); softcap2: the
// logit softcap in base-2 units (cap * log2 e), 0 for none; both at
// head_dim 128 and 256.  head_dim 64, 128 or 256 (256 causal only).
// qmeta, kmeta, qrange, krange: segment ids and positions as K4 takes them
// (all four or none); bias: null, or fp32 in natural units, element
// (b, h, i, j) at b bs_b + h bs_h + i bs_q + j bs_k; dropout: 0, or 1 with
// the seed's bits, the keep threshold and inv_keep = f32(1 / (1 - rate)).
// alibi2: null, or [H] fp32 ALiBi slopes times log2 e.  ds: null, or fp32
// [B, H, Sq, Sk], zero-filled, for dS (the bias's gradient before any
// broadcast).  These at head_dim 64 and 128, without a window or softcap,
// but for the tile metadata, which takes both at head_dim 128.
// window_idx: nonzero where the tile metadata carries segment ids without
// positions and a window is given: the window then compares the indices
// (else the positions); ignored otherwise.
extern "C" int fatt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 const void* cosv, const void* sinv, void* dq, void* rq,
                                 int B, int Sq, int Sk, int H, int Hk, int D,
                                 int rope_bstride, float scale, int causal, int window_left,
                                 int window_right, float softcap2, const void* qmeta,
                                 const void* kmeta, const void* qrange, const void* krange,
                                 const float* bias, int64_t bs_b, int64_t bs_h, int64_t bs_q,
                                 int64_t bs_k, int dropout, uint32_t seed, uint32_t threshold,
                                 float inv_keep, const float* alibi2, float* ds,
                                 int window_idx, void* stream) {
  const Opt o{static_cast<const int2*>(qmeta), static_cast<const int2*>(kmeta),
              static_cast<const int4*>(qrange), static_cast<const int4*>(krange), bias, bs_b,
              bs_h, bs_q, bs_k, dropout, seed, threshold, inv_keep, alibi2, ds};
  const bool local = window_left >= 0 || window_right >= 0 || softcap2 > 0.f;
  bool opt = false;
  if (!shape_ok(B, Sq, Sk, H, Hk, D, causal, window_left, window_right, softcap2) ||
      !opt_ok(o, Sq, Sk, D, local, opt))
    return (int)cudaErrorInvalidValue;
  const bool surface = alibi2 != nullptr || ds != nullptr;
  auto fn = D == 256        ? launch_dq<256, true, false>
            : D == 64       ? (surface ? launch_dq<64, false, true, true>
                               : opt   ? launch_dq<64, false, true>
                                       : launch_dq<64, false, false>)
            : surface       ? launch_dq<128, false, true, true>
            : opt && local  ? (window_idx ? launch_dq<128, true, true, false, true>
                                          : launch_dq<128, true, true>)
            : opt           ? launch_dq<128, false, true>
            : local         ? launch_dq<128, true, false>
                            : launch_dq<128, false, false>;
  return fn(q, k, v, dout, lse, delta, cosv, sinv, dq, rq, B, Sq, Sk, H, Hk, rope_bstride,
            scale, causal, window_left, window_right, softcap2, o,
            static_cast<cudaStream_t>(stream));
}

// rq: R(q) [B, Sq, H, D] bf16 (q itself without rope); the rest, the
// options and window_idx included, as fatt_flash_bwd_dq (no dS: K9 writes
// it).  dk, dv:
// [B, H, Sk, D] fp32, per query head.
extern "C" int fatt_flash_bwd_dkv(const void* rq, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int Sq, int Sk, int H, int Hk,
                                  int D, float scale, int causal, int window_left,
                                  int window_right, float softcap2, const void* qmeta,
                                  const void* kmeta, const void* qrange, const void* krange,
                                  const float* bias, int64_t bs_b, int64_t bs_h, int64_t bs_q,
                                  int64_t bs_k, int dropout, uint32_t seed, uint32_t threshold,
                                  float inv_keep, const float* alibi2, int window_idx,
                                  void* stream) {
  const Opt o{static_cast<const int2*>(qmeta), static_cast<const int2*>(kmeta),
              static_cast<const int4*>(qrange), static_cast<const int4*>(krange), bias, bs_b,
              bs_h, bs_q, bs_k, dropout, seed, threshold, inv_keep, alibi2, nullptr};
  const bool local = window_left >= 0 || window_right >= 0 || softcap2 > 0.f;
  bool opt = false;
  if (!shape_ok(B, Sq, Sk, H, Hk, D, causal, window_left, window_right, softcap2) ||
      !opt_ok(o, Sq, Sk, D, local, opt))
    return (int)cudaErrorInvalidValue;
  const bool surface = alibi2 != nullptr;
  auto fn = D == 256        ? launch_dkv<256, true, false>
            : D == 64       ? (surface ? launch_dkv<64, false, true, true>
                               : opt   ? launch_dkv<64, false, true>
                                       : launch_dkv<64, false, false>)
            : surface       ? launch_dkv<128, false, true, true>
            : opt && local  ? (window_idx ? launch_dkv<128, true, true, false, true>
                                          : launch_dkv<128, true, true>)
            : opt           ? launch_dkv<128, false, true>
            : local         ? launch_dkv<128, true, false>
                            : launch_dkv<128, false, false>;
  return fn(rq, k, v, dout, lse, delta, dk, dv, B, Sq, Sk, H, Hk, scale, causal, window_left,
            window_right, softcap2, o, static_cast<cudaStream_t>(stream));
}

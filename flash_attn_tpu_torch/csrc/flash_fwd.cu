// K4: FlashAttention-2 forward, BSHD bf16, head_dim 64, 128 or 256, causal
// (bottom-right) GQA prefill with q-side RoPE applied in the kernel,
// "clamped" or "online" softmax, fp32 LSE, an optional sliding window and
// logit softcap (Gemma-2, Mistral), optional segment ids and positions (the
// packed and chunked prefill's masks; head_dim 64 or 128, with a window or
// softcap at 128), and
// an optional additive fp32 bias and counter-based dropout (the C ABI's
// attn_mask and dropout; head_dim 64 or 128, with or without the masks).
//
// Replaces flash_attn_tpu/ops/flash_fwd.py:_fwd_kernel (B7) on the subset
// the Llama, Gemma-2 and GPT-2 prefill paths and the training forward use
// (models/llama.py, models/gemma2.py, models/gpt2.py).
//
// Bound on the H100: operations.  At S = 2048, D = 128 the causal half of
// QK^T and PV is ~4*S^2*D/2 flops per head against ~4*S*D bytes, far above
// the ridge, so the tensor cores set the bound.  The design keeps every
// intermediate in registers and the tensor cores fed:
//   * one block per (64-query tile, head, batch): one warpgroup of 4 warps,
//     16 query rows each.  Each thread builds its Q fragments straight from
//     device memory: scaled, rounded to bf16, rotated in fp32 and rounded
//     again (as flash_fwd.py:146-160 does); a column and its rotation
//     partner 64 away land in the same thread;
//   * QK^T and PV run on wgmma m64n64k16 (bf16 in, fp32 accumulate): A (Q,
//     then P) from registers, B (K, then V transposed) read by descriptor
//     from shared memory once for the warpgroup's 64 rows.  Scores, the
//     running max and sum, and the O accumulator live in registers for the
//     whole KV loop; P is packed to bf16 straight from the score
//     accumulators, whose layout is the A-fragment layout; O is written
//     once, at the end, through the drained ring;
//   * K/V tiles of 64 keys arrive by cp.async into a two-stage ring, so the
//     next tile loads while the current one computes; rows past Sk are
//     zero-filled (src-size 0), so V rows that p = 0 multiplies are finite.
//     The ring holds each tile as two 64-column halves in the 128-byte
//     swizzle that wgmma reads, which also keeps the cp.async writes free
//     of bank conflicts.  65 KB and 167 registers a block: three blocks an
//     SM;
//   * only tiles that a warp's diagonal (or Sk's edge) crosses are
//     masked element by element; tiles above the diagonal are never
//     loaded; the heavy (last) query tiles are scheduled first;
//   * the KV head is h / (H / Hk): GQA without a materialised broadcast.
// Scores are in base-2 units (log2(e) folded into the q pre-scale).
// Clamped mode drops the running max: p = 2^min(s, 80), no rescale.
//
// Head dim 256 (Gemma-2-9B; the kD = 256 instance): the O accumulator
// alone takes 128 fp32 registers a thread, so Q leaves the registers: the
// prologue writes the scaled, rotated, rounded Q tile (64 x 256 bf16,
// 32 KB) into shared memory in the same swizzle as K, and QK^T reads it
// by descriptor as wgmma's A operand.  The K/V ring's two stages take
// 128 KB: one block an SM.  PV runs on four 64-column parts of V.
//
// The window and the softcap are built into instances of their own
// (kLocal): head_dim 256 (Gemma-2-9B) and a head_dim 128 one beside the
// Llama instance (Gemma-2-27B), which keeps Q in registers as the Llama
// instance does.  Compiled into the Llama instance at run time they took
// it from 167 registers to 190 and from three blocks an SM to two, 17 %
// slower at S = 2048, so the instances without them keep their code.
// Window (left, right; -1 open), bottom-right aligned as causal is
// (flash_fwd.py:320-333): a block walks only the key tiles that some of
// its rows' windows reach, from max(0, row0 + shift - left) to its last
// row's right edge, so the tiles below a sliding window are never loaded
// (JAX's block liveness, not a mask); tiles that a warp's window edge
// crosses are masked element by element.
// Softcap (flash_fwd.py:363-367, 757-761): s = c * tanh(s / c) on the
// base-2 scores before the masks, c = cap * log2(e) passed by the wrapper.
// tanh is 1 - 2 / (2^(2x log2 e) + 1) on two MUFU operations (fatt::tanh_exp2):
// the library tanhf took half of the D = 256 kernel's time (3.86 ms
// against 1.90 without the cap at S = 8192), and tanh.approx.f32 errs
// ~2^-11 relative, ~0.035 base-2 units at c = 72; this form errs ~1e-7
// absolute in tanh, ~1e-5 units in s.  At cap 50 (c = 72.1 < 80) clamped
// mode stays exact.
//
// Segment ids and positions (the kMeta instance): a pair is live only where
// every mask given holds, as _apply_mask composes them (flash_fwd.py:
// 296-347): causal by index, q segment == kv segment, kv position <= q
// position.  A packed prefill's live pairs are a few percent of the square
// (8.5 % at phase 4's eight prompts in 4096), so the design skips what it
// can prove dead and masks only where it must:
//   * the wrapper passes each side's (segment, position) per token, padded
//     to whole tiles ([B, n*64] int2), and each tile's least and greatest
//     segment and position ([B, n] int4), plain torch reductions made once
//     for the mask tensors that a prefill's layers share;
//   * each block first lists its live key tiles in shared memory, 128 at a
//     time by ballot and a prefix count (in order): a k tile is dead when
//     its segment range misses the q tile's, or its least position exceeds
//     the q tile's greatest, or (causal) the index test drops it.  Ranges
//     only have to be conservative, so the test holds whatever the order of
//     the ids, padding (id 0, position 0) included.  The list entry also
//     says whether the pair is live throughout (one segment on both sides
//     and greatest kv position <= least q position); every other listed
//     tile is masked element by element.  On request (tile_count) head 0's
//     blocks add up their lists, so a check can read back what was walked;
//   * the cp.async ring walks the list, so it prefetches the next live
//     tile, and each tile's 64 (segment, position) pairs ride beside its
//     K/V in a small ring of their own; each thread holds its two rows'
//     segment and position in registers;
//   * a dead tile adds exactly 0 in both softmax modes, so skipping it
//     changes nothing.  A row with no live key gives 0 and lse -1e30;
//     padding rows (segment 0, position 0) see every padding key, as in
//     JAX;
//   * the q tiles keep the causal order (last first): in a chunk over a
//     cache and within a packed prompt the later tiles see the most keys.
//
// Masks with a window or a softcap (kMeta and kLocal: one head_dim 128
// instance, the packed and chunked prefill of a windowed Llama such as
// Mistral-7B).  With positions the window compares them, not the indices
// (flash_fwd.py:320-333): kv position >= q position - left (<= q position +
// right), which keeps the window per prompt in a packed row and at start + i
// in a chunk over a cache.  So the index-based tile range of the kLocal
// instances is not used here: the live list bounds the walk, and its tile
// test also drops a tile whose greatest position lies below the q tile's
// least position - left (or whose least lies above its greatest + right);
// a tile is live throughout only if, besides the test above, its least
// position is >= the q tile's greatest - left (and its greatest <= the
// least + right).  Ranges only have to be conservative, so the list still
// never drops a live tile.  The element mask adds the window on the
// positions; the softcap is the kLocal one.  With segment ids and no
// positions (llama.forward's packed documents) JAX's window compares the
// bottom-right aligned indices: a twin of the instance (kWinIdx, which the
// C entry picks on window_idx) bounds the walk by the kLocal instances'
// index range, lists that range's tiles by the segments alone (the
// positions are 0 there) and masks the window on the indices where an
// edge crosses a warp's rows, as the kLocal instances without masks do.
// The wrapper never makes index positions up: they would add kv position
// <= q position, which is wrong for a call that is not causal.
//
// Head dim 64 (GPT-2; the kD = 64 instances, with and without masks): a
// bf16 row is 128 bytes, one swizzle atom, so a K/V tile is one 64-column
// part (8 KB): QK^T takes 4 depth steps, PV one n64 product.  The O
// accumulator (32 fp32 registers) and the ring (two stages of 16 KB) are
// half of D = 128's, so ptxas is asked for four blocks an SM.
//
// Bias and dropout (the kExtra instances, beside each head_dim 64 and 128
// instance with and without masks; the others keep their code, as kLocal's
// do): flash_fwd.py:369-372, 451-456, 764-766.
//   * the bias is fp32, read through four strides (0 on a broadcast axis,
//     so a [Sq, Sk] or [B, 1, Sq, Sk] mask is never materialised over the
//     heads).  It rides the cp.async ring: each stage stages the block's 64
//     query rows x the stage's 64 keys (16 KB of fp32) in the commit group
//     of the stage's K/V, so the tile's bias has landed when S = Q K^T
//     does and no device-memory load sits between S and the softmax (read
//     per element from device memory after S, it cost a full load latency
//     a tile: 1.63x SDPA on the same float mask).  Every stride the
//     wrapper's broadcast views give takes this one route
//     (fatt::load_bias: 16-, 8- or 4-byte pieces as the plane's alignment
//     and key stride allow, as K9's and K10's); rows and keys past Sq / Sk
//     are zero-filled and meet only entries masked dead or never written.
//     A thread reads its entries as float2 pairs (rows lane/4 and 8 below,
//     keys 2 (lane % 4) apart): rows padded to 72 floats (8 mod 32) put
//     each half-warp on 32 distinct banks, the two wavefronts 256 bytes
//     need.  The two stages (36 KB) are sized at launch only when a bias is
//     given, so head dim 128 keeps two blocks an SM and 64 three.  Each
//     entry adds bias * log2(e), both rounded apart as JAX rounds them, and
//     clamps at -1e30, so a -inf entry is dead and a row of them gives 0
//     and lse -1e30 as JAX's clamp does;
//   * dropout hashes (seed, b, h, row, column) per live element
//     (fatt::drop_keep, keyed on the query head h, not the KV head) and
//     multiplies kept P by 1 / f32(1 - rate) (a division, as JAX's) before
//     P is packed for PV; the row sums, and so out's normalisation and
//     the LSE, are the undropped P's.
//
// ALiBi, return_softmax and clamped_verify (kSurface: instances of their
// own beside the kExtra ones, which they extend, at head_dim 64 and 128,
// with and without masks; the C entry picks them when one of their
// pointers is not null).  Compiled into the kExtra instances as runtime
// branches they left the outputs there bitwise as they were, but took
// K4's mask-alone point from 0.3389-0.3425 ms to 0.3572-0.3636 (188 to
// 206 registers; NVIDIA H100 80GB HBM3, 700 W, chip_tools/k4_probe.py
// turns), so the kExtra instances keep their code:
//   * ALiBi (flash_fwd.py:374-388, 872-876): s -= slope_h log2(e) |row +
//     Sk - Sq - col| after the bias clamp and before the masks, on every
//     tile the block walks (the unmasked ones too), with the query head's
//     slope (premultiplied by log2 e on the host) and the row and column
//     indices, never the positions (with segment ids JAX's ALiBi measures
//     the packed indices too).  __fmul_rn / __fsub_rn, as the bias's, so
//     that no contraction moves the kernel off its plain version;
//   * return_softmax (flash_fwd.py:263-269, 460-467, 1048-1061): each
//     tile's post-dropout P as the softmax made it, unnormalised (online:
//     2^(s - m) with the row's running max m after the tile, also written,
//     one float a row and tile; clamped: 2^min(s, 80)), into an fp32
//     [B, H, Sq, nk*64] buffer that the wrapper zero-fills, so the tiles the
//     block never walks (above the diagonal, off the live list) stay 0;
//     JAX disables its causal skip to write them.  The wrapper
//     renormalises, P = praw exp(m ln 2 - lse), as JAX does outside its
//     kernel.  The path is for tests and debugging: 512 MiB of fp32 at
//     B=1 S=2048 H=32, written from the score registers as float2 pairs
//     (each quad's 32 bytes of a row, whole sectors), in the softmax loop
//     of the kProbs instances only (kSurface ones with the writes);
//   * clamped_verify (flash_fwd.py:417-421, 516-524): the clamped mode also
//     keeps each row's running max (quad_max as the online branch, never
//     subtracted) and writes the row's flag, l == 0 or m in [-80, 80]: the
//     rows where clamped equals online exactly.
#include "common.cuh"

namespace {

using fatt::kNegInf;

constexpr int kBQ = 64;  // query rows per block: one warpgroup
constexpr int kBK = 64;  // keys per tile
constexpr int kWarps = kBQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;
// With masks: a stage's 64 (segment, position) pairs after the K/V ring,
// then the block's list of live key tiles (at most kMaxListTiles).
constexpr int kMetaBytes = kBK * 8;
constexpr int kMaxListTiles = 4096;
constexpr int kFullBit = 1 << 30;  // list entry: live throughout, no mask
constexpr float kClamp2 = 80.f;
constexpr float kVerifyFloor2 = -80.f;  // clamped_verify's floor, base-2 units
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
// kExtra with a bias: two stages of the block's 64 query rows x 64 keys,
// rows padded to 72 floats, after the K/V ring.
constexpr int kBiasPitch = kBK + 8;
constexpr int kBiasStage = kBQ * kBiasPitch * 4;
constexpr int kBiasBytes = kStages * kBiasStage;

// The tile geometry of head dim kD (64, 128 or 256).
template <int kD>
struct Dims {
  static constexpr int kRowBytes = kD * 2;
  static constexpr int kChunks = kRowBytes / 16;  // 16-byte chunks per row
  static constexpr int kTileBytes = kBK * kRowBytes;
  // Q in shared memory (after the ring) above 128; in registers at 128
  static constexpr bool kQSmem = kD > 128;
  // + 1024: the ring starts at the next 1024-byte boundary (the swizzle atom)
  static constexpr int kSmemBytes = kStages * 2 * kTileBytes + (kQSmem ? kTileBytes : 0) + 1024;
};

// Byte offset of 16-byte chunk c of row r in a swizzled [rows][kD] tile.
template <int kD>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return r * Dims<kD>::kRowBytes + ((c ^ (r & 7)) << 4);
}

// S (64 x 64 fp32, laid out as fatt::attn_qk lays it) = Q K^T with both
// operands read by descriptor: Q the tile at qt, K the tile at kt (kD / 64
// parts of 64 columns in the 128-byte swizzle).
template <int kD>
__device__ __forceinline__ void attn_qk_smem(float (&s)[8][4], uint32_t qt, uint32_t kt) {
  auto& sd = reinterpret_cast<float(&)[32]>(s);
  fatt::pin(sd);
  fatt::wg_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    fatt::wgmma_ss(sd, fatt::wg_desc(fatt::kmajor<kBQ>(qt, kk)),
                   fatt::wg_desc(fatt::kmajor<kBK>(kt, kk)), kk > 0);
  fatt::wg_commit();
  fatt::wg_wait_all();
  fatt::pin(sd);
}

// A K/V ring tile is kD / 64 64-column parts of kBK rows in the 128-byte
// swizzle (fatt::sw128): every operand K4's products (fatt::attn_qk,
// fatt::attn_pv) read from it spans one swizzle atom (K: 16 of 64 columns;
// V: 64 of 64).

// qmeta/kmeta: [B, nq*64] / [B, nk*64] (segment, position) per token;
// qrange/krange: [B, nq] / [B, nk] (least segment, least position, greatest
// segment, greatest position) per tile.  Read only by the kMeta instance.
// The kLocal instances apply the window (wleft, wright; -1 open) and the
// softcap (softcap2, the cap in base-2 units; 0 for none); the others
// ignore all three.  The kExtra instances apply the bias (null for none;
// element (b, h, i, j) at b bs_b + h bs_h + i bs_q + j bs_k) and, where
// dropout != 0, dropout (seed bits, threshold, keep_div = f32(1 - rate)),
// ALiBi (alibi2: [H] slopes times log2 e), return_softmax (probs: [B, H,
// Sq, nk*64] unnormalised P, pmax: [B, H, Sq, nk] running maxima, null in
// clamped mode) and clamped_verify (vflag: [B, H, Sq], with clamped), each
// null for none; the kSurface instances apply the last three (kSurface
// implies kExtra; return_softmax only in the kProbs ones, where probs is
// given), the others ignore them.
template <int kD, bool kMeta, bool kLocal, bool kExtra, bool kSurface = false,
          bool kProbs = false, bool kWinIdx = false>
__global__ void __launch_bounds__(kThreads, kD == 64 ? (kExtra ? 3 : 4) : kD == 128 ? 2 : 1)
    flash_fwd_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ cosv,
    const float* __restrict__ sinv, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, const int2* __restrict__ qmeta,
    const int2* __restrict__ kmeta, const int4* __restrict__ qrange,
    const int4* __restrict__ krange, int* __restrict__ tile_count, int Sq, int Sk,
    int H, int Hk, int rope_bstride, float eff_scale, int causal, int clamped, int wleft,
    int wright, float softcap2, const float* __restrict__ bias, int64_t bs_b, int64_t bs_h,
    int64_t bs_q, int64_t bs_k, int dropout, uint32_t seed, uint32_t threshold,
    float keep_div, const float* __restrict__ alibi2, float* __restrict__ probs,
    float* __restrict__ pmax, float* __restrict__ vflag) {
  using G = Dims<kD>;
  constexpr int kChunks = G::kChunks;
  constexpr int kTileBytes = G::kTileBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_base = fatt::smem_u32(smem);
  const uint32_t kv_base = (s_base + 1023) & ~1023u;
  // The ring's first stage holds O on its way out once the ring is drained.
  unsigned char* Os = smem + (kv_base - s_base);
  // kExtra with a bias: its two stages after the K/V ring.
  const uint32_t bias_ring = kv_base + kStages * 2 * kTileBytes;
  const bool has_bias = kExtra && bias != nullptr;
  // kMeta: the tiles' (segment, position) ring, then the live-tile list.
  const uint32_t meta_base = bias_ring + (has_bias ? kBiasBytes : 0);
  const unsigned char* meta_s = smem + (meta_base - s_base);
  int* list = reinterpret_cast<int*>(smem + (meta_base - s_base) + kStages * kMetaBytes);

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // heavy (last) tiles first
  const int kvh = h / (H / Hk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = qt * kBQ;
  const int shift = Sk - Sq;  // bottom-right causal alignment
  const int nk = (Sk + kBK - 1) / kBK;
  // the window compares the indices (kLocal without masks, or kWinIdx) or
  // the positions (kLocal with masks)
  constexpr bool kIdxWindow = kLocal && (!kMeta || kWinIdx);
  constexpr bool kPosWindow = kLocal && kMeta && !kWinIdx;

  // The key range some row of the block sees: causal and the window's
  // right edge bound it above (at the block's last row), the window's left
  // edge below (at its first row).
  const int row_last = min(row0 + kBQ - 1, Sq - 1);
  int kv_end = Sk;
  if (causal) kv_end = min(kv_end, row_last + shift + 1);
  int kv_begin = 0;
  if constexpr (kIdxWindow) {  // kPosWindow: the window on positions, in the list
    if (wright >= 0) kv_end = min(kv_end, row_last + shift + wright + 1);
    if (wleft >= 0) kv_begin = max(0, row0 + shift - wleft);
  }
  const int t_first = kv_begin / kBK;
  const int n_tiles = kv_end > kv_begin ? (kv_end + kBK - 1) / kBK - t_first : 0;

  // The block's live key tiles, in order, each with its kFullBit.
  int n_live = n_tiles;
  if constexpr (kMeta) {
    __shared__ int warp_live[kWarps];
    const int4 qr = qrange[(int64_t)b * gridDim.z + qt];
    int n = 0;
    for (int base = 0; base < n_tiles; base += kThreads) {
      const int t = base + tid;
      bool live = false;
      int entry = t_first + t;
      if (t < n_tiles) {
        const int4 kr = krange[(int64_t)b * nk + t_first + t];
        live = kr.z >= qr.x && kr.x <= qr.z && kr.y <= qr.w;
        bool full = qr.x == qr.z && kr.x == kr.z && kr.x == qr.x && kr.w <= qr.y;
        if constexpr (kPosWindow) {  // the window on positions
          if (wleft >= 0) {
            live = live && kr.w >= qr.y - wleft;
            full = full && kr.y >= qr.w - wleft;
          }
          if (wright >= 0) {
            live = live && kr.y <= qr.w + wright;
            full = full && kr.w <= qr.y + wright;
          }
        }
        if (full) entry |= kFullBit;
      }
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (lane == 0) warp_live[warp] = __popc(m);
      __syncthreads();
      int off = n;
      for (int w = 0; w < warp; ++w) off += warp_live[w];
      if (live) list[off + __popc(m & ((1u << lane) - 1u))] = entry;
      for (int w = 0; w < kWarps; ++w) n += warp_live[w];
      __syncthreads();  // the list is complete; warp_live is free again
    }
    n_live = n;
    // On request, head 0's blocks add their list's length and its tiles
    // live throughout (tile_count[0], [1]): the count of what the walk
    // visits, read back by the card's checks.
    if (tile_count != nullptr && h == 0 && tid == 0) {
      int n_full = 0;
      for (int i = 0; i < n; ++i) n_full += (list[i] & kFullBit) != 0;
      atomicAdd(tile_count, n);
      atomicAdd(tile_count + 1, n_full);
    }
  }
  // Key tile of the walk's step i, and whether it needs no segment or
  // position mask.
  auto tile_of = [&](int i) { return kMeta ? list[i] & (kFullBit - 1) : t_first + i; };

  // kExtra: this (batch, head)'s bias plane and its cp.async piece.
  const float* bias_bh = nullptr;
  int bias_vec = 0;
  if constexpr (kExtra) {
    if (has_bias) {
      bias_bh = bias + b * bs_b + h * bs_h;
      bias_vec = fatt::bias_piece(bias_bh, bs_q, bs_k);
    }
  }

  // K and V of the tile at key k0 into ring stage st (with masks, also its
  // 64 (segment, position) pairs; with a bias, its 64 x 64 entries).
  auto load_tile = [&](int st, int k0) {
    const uint32_t ks = kv_base + st * 2 * kTileBytes;
    const uint32_t vs = ks + kTileBytes;
    for (int i = tid; i < kBK * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const bool in = k0 + r < Sk;
      const int64_t g = (((int64_t)b * Sk + (in ? k0 + r : 0)) * Hk + kvh) * kD + c * 8;
      fatt::cp_async16(ks + fatt::sw128<kBK>(r, c), k + g, in ? 16 : 0);
      fatt::cp_async16(vs + fatt::sw128<kBK>(r, c), v + g, in ? 16 : 0);
    }
    if constexpr (kMeta) {
      if (tid < kMetaBytes / 16)
        fatt::cp_async16(meta_base + st * kMetaBytes + tid * 16,
                         kmeta + (int64_t)b * nk * kBK + k0 + tid * 2, 16);
    }
    if constexpr (kExtra) {
      if (has_bias)
        fatt::load_bias<kBQ, kBK, kBiasPitch, kThreads>(
            bias_ring + st * kBiasStage, bias_bh + row0 * bs_q + k0 * bs_k, bs_q, bs_k,
            Sq - row0, Sk - k0, bias_vec);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_live) load_tile(i, tile_of(i) * kBK);
    fatt::cp_async_commit();
  }

  // Q: scale in fp32, round to bf16, rotate (rotate-half) in fp32 with the
  // row's cos/sin, round to bf16.  Rows >= Sq are zero.
  // kD = 256: into the Q tile after the ring, each thread 8 columns and
  // their rotation partners kD/2 away at a time (16-byte loads and stores).
  const uint32_t q_tile = kv_base + kStages * 2 * kTileBytes;
  if constexpr (G::kQSmem) {
    constexpr int kHalf = kChunks / 2;
    unsigned char* qs = smem + (q_tile - s_base);
    for (int i = tid; i < kBQ * kHalf; i += kThreads) {
      const int r = i / kHalf, c = i % kHalf;
      const int gq = row0 + r;
      float a[8], e[8];
      if (gq < Sq) {
        const __nv_bfloat16* src = q + (((int64_t)b * Sq + gq) * H + h) * kD + c * 8;
        const uint4 ra = *reinterpret_cast<const uint4*>(src);
        const uint4 re = *reinterpret_cast<const uint4*>(src + kD / 2);
        const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&ra);
        const __nv_bfloat162* pe = reinterpret_cast<const __nv_bfloat162*>(&re);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 fa = __bfloat1622float2(pa[u]), fe = __bfloat1622float2(pe[u]);
          a[2 * u] = fatt::bf16_round(fa.x * eff_scale);
          a[2 * u + 1] = fatt::bf16_round(fa.y * eff_scale);
          e[2 * u] = fatt::bf16_round(fe.x * eff_scale);
          e[2 * u + 1] = fatt::bf16_round(fe.y * eff_scale);
        }
        if (cosv != nullptr) {
          const int64_t t = (int64_t)b * rope_bstride + (int64_t)gq * (kD / 2) + c * 8;
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            const float cv = cosv[t + u], sv = sinv[t + u];
            const float o1 = __fsub_rn(__fmul_rn(a[u], cv), __fmul_rn(e[u], sv));
            const float o2 = __fadd_rn(__fmul_rn(e[u], cv), __fmul_rn(a[u], sv));
            a[u] = o1;
            e[u] = o2;
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < 8; ++u) a[u] = e[u] = 0.f;
      }
      uint4 wa, we;
      wa.x = fatt::pack_bf16(a[0], a[1]);
      wa.y = fatt::pack_bf16(a[2], a[3]);
      wa.z = fatt::pack_bf16(a[4], a[5]);
      wa.w = fatt::pack_bf16(a[6], a[7]);
      we.x = fatt::pack_bf16(e[0], e[1]);
      we.y = fatt::pack_bf16(e[2], e[3]);
      we.z = fatt::pack_bf16(e[4], e[5]);
      we.w = fatt::pack_bf16(e[6], e[7]);
      *reinterpret_cast<uint4*>(qs + fatt::sw128<kBQ>(r, c)) = wa;
      *reinterpret_cast<uint4*>(qs + fatt::sw128<kBQ>(r, c + kHalf)) = we;
    }
    // the loop's fence and barrier order these stores before the first
    // product reads them
  }
  // kD = 64, 128: straight into the fragments: this thread holds columns
  // 16kk + 2(lane%4) + {0, 1} (+ 8) of rows lane/4 and lane/4 + 8; column
  // c < kD/2 and its rotation partner c + kD/2 sit in fragments kk and
  // kk + kD/32 of one thread.
  uint32_t qf[G::kQSmem ? 1 : kD / 16][4];  // this warp's 16 rows as A fragments
#pragma unroll
  for (int hf = 0; hf < 2 && !G::kQSmem; ++hf) {
    const int gq = row0 + warp * 16 + (lane >> 2) + hf * 8;
    const bool in = gq < Sq;
    const __nv_bfloat16* src = q + (((int64_t)b * Sq + (in ? gq : 0)) * H + h) * kD;
    const int64_t t = (int64_t)b * rope_bstride + (int64_t)(in ? gq : 0) * (kD / 2);
#pragma unroll
    for (int kk = 0; kk < kD / 32; ++kk) {
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {
        const int c = kk * 16 + h8 * 8 + (lane & 3) * 2;
        float2 x1 = make_float2(0.f, 0.f), x2 = make_float2(0.f, 0.f);
        if (in) {
          x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + c));
          x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + c + kD / 2));
        }
        float a[2] = {fatt::bf16_round(x1.x * eff_scale), fatt::bf16_round(x1.y * eff_scale)};
        float e[2] = {fatt::bf16_round(x2.x * eff_scale), fatt::bf16_round(x2.y * eff_scale)};
        if (cosv != nullptr) {
          const float2 cs = *reinterpret_cast<const float2*>(cosv + t + c);
          const float2 sn = *reinterpret_cast<const float2*>(sinv + t + c);
          const float cv[2] = {cs.x, cs.y}, sv[2] = {sn.x, sn.y};
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float o1 = __fsub_rn(__fmul_rn(a[u], cv[u]), __fmul_rn(e[u], sv[u]));
            const float o2 = __fadd_rn(__fmul_rn(e[u], cv[u]), __fmul_rn(a[u], sv[u]));
            a[u] = o1;
            e[u] = o2;
          }
        }
        if constexpr (!G::kQSmem) {
          qf[kk][hf + 2 * h8] = fatt::pack_bf16(a[0], a[1]);
          qf[kk + kD / 32][hf + 2 * h8] = fatt::pack_bf16(e[0], e[1]);
        }
      }
    }
  }

  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // This thread's rows: wrow0 + lane/4 (accumulator entries 0, 1) and 8
  // below it (entries 2, 3).  l_run holds this thread's share of the sum;
  // the quad's four shares are added at the end.
  const int wrow0 = row0 + warp * 16;
  const int my_row = wrow0 + (lane >> 2);
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  // kMeta: the (segment, position) of this thread's two rows (padded, so
  // rows past Sq read the last row's).
  int2 qm[2] = {make_int2(0, 0), make_int2(0, 0)};
  if constexpr (kMeta) {
    const int2* qrow = qmeta + (int64_t)b * gridDim.z * kBQ;
    qm[0] = qrow[my_row];
    qm[1] = qrow[my_row + 8];
  }
  // kExtra: this thread's first staged bias pair (row my_row, keys
  // 2 (lane % 4) + {0, 1} of stage 0) and its rows' part of the dropout
  // hash.
  const float* bias_my = reinterpret_cast<const float*>(smem + (bias_ring - s_base)) +
                         (my_row - row0) * kBiasPitch + 2 * (lane & 3);
  uint32_t drop_rows[2] = {0u, 0u};
  if constexpr (kExtra) {
    const uint32_t mix = fatt::drop_mix(seed, b, h);
    drop_rows[0] = fatt::drop_row(mix, my_row);
    drop_rows[1] = fatt::drop_row(mix, my_row + 8);
  }
  // kSurface: the query head's ALiBi slope (base 2), whether the clamped
  // mode tracks the row max (clamped_verify), and this thread's first row
  // of the unnormalised P (return_softmax; rows of nk * 64 floats)
  const bool has_alibi = kSurface && alibi2 != nullptr;
  const float slope2 = has_alibi ? alibi2[h] : 0.f;
  const bool track = kSurface && vflag != nullptr;
  const int64_t p_pitch = (int64_t)nk * kBK;
  float* const p_row =
      kProbs ? probs + (((int64_t)b * H + h) * Sq + my_row) * p_pitch : nullptr;

  for (int t = 0; t < n_live; ++t) {
    if (t + kStages - 1 < n_live)
      load_tile((t + kStages - 1) % kStages, tile_of(t + kStages - 1) * kBK);
    fatt::cp_async_commit();
    fatt::cp_async_wait<kStages - 1>();
    fatt::fence_proxy_async();  // cp.async -> wgmma
    __syncthreads();
    const int st = t % kStages;
    const uint32_t ks = kv_base + st * 2 * kTileBytes;
    const uint32_t vs = ks + kTileBytes;
    const int k0 = tile_of(t) * kBK;

    // S = Q K^T: 16 rows x 64 keys as eight n8 tiles.
    float s[kBK / 8][4];
    if constexpr (G::kQSmem) {
      attn_qk_smem<kD>(s, q_tile, ks);
    } else {
      fatt::attn_qk(s, qf, ks);
    }
    if (kLocal && softcap2 > 0.f) {
      const float inv_cap = 1.f / softcap2;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = softcap2 * fatt::tanh_exp2(s[j][e] * inv_cap);
    }
    // kExtra: s = max(s + bias log2 e, -1e30) from the stage's bias (the
    // zero-filled entries past Sq / Sk are masked dead below or never
    // written)
    if (kExtra && has_bias) {
      const float* bs = bias_my + st * (kBiasStage / 4);
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 bv = *reinterpret_cast<const float2*>(bs + hf * 8 * kBiasPitch + j * 8);
          s[j][2 * hf] = fmaxf(__fadd_rn(s[j][2 * hf], __fmul_rn(bv.x, kLog2e)), kNegInf);
          s[j][2 * hf + 1] =
              fmaxf(__fadd_rn(s[j][2 * hf + 1], __fmul_rn(bv.y, kLog2e)), kNegInf);
        }
      }
    }
    // kSurface with ALiBi: s -= slope2 |row + shift - col|, every tile
    if (has_alibi) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int row = my_row + (e >> 1) * 8;
          const float dist = (float)abs(row + shift - col);
          s[j][e] = __fsub_rn(s[j][e], __fmul_rn(slope2, dist));
        }
    }

    // Mask only where this warp's diagonal, a window edge of its rows or
    // Sk's edge crosses the tile, or, with masks, where the list does not
    // say the tile is live throughout.
    bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > wrow0 + shift);
    if constexpr (kIdxWindow) {
      if (wright >= 0) edge = edge || k0 + kBK - 1 > wrow0 + shift + wright;
      if (wleft >= 0) edge = edge || k0 < wrow0 + 15 + shift - wleft;
    }
    if constexpr (kMeta) edge = edge || !(list[t] & kFullBit);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        // keys c and c + 1 of the tile: (segment, position, segment, position)
        int4 km = make_int4(0, 0, 0, 0);
        if constexpr (kMeta)
          km = *reinterpret_cast<const int4*>(meta_s + st * kMetaBytes +
                                              (j * 8 + (lane & 3) * 2) * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          const int row = my_row + (e >> 1) * 8;
          bool dead = col >= Sk || (causal && col > row + shift);
          if constexpr (kIdxWindow)
            dead = dead || (wleft >= 0 && col < row + shift - wleft) ||
                   (wright >= 0 && col > row + shift + wright);
          if constexpr (kMeta) {
            const int kseg = (e & 1) ? km.z : km.x, kpos = (e & 1) ? km.w : km.y;
            dead = dead || kseg != qm[e >> 1].x || kpos > qm[e >> 1].y;
            if constexpr (kPosWindow)
              dead = dead || (wleft >= 0 && kpos < qm[e >> 1].y - wleft) ||
                     (wright >= 0 && kpos > qm[e >> 1].y + wright);
          }
          if (dead) s[j][e] = kNegInf;
        }
      }
    }

    // Softmax in registers; P to bf16 A fragments (keys 16c..16c+15).
    uint32_t pf[kBK / 16][4];
    float alpha[2] = {1.f, 1.f};
    // clamped_verify: the clamped mode keeps the row max too, unsubtracted
    if (!clamped || track) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hf], s[j][2 * hf + 1]));
        const float m_new = fmaxf(m_run[hf], fatt::quad_max(mx));
        if (!clamped) alpha[hf] = exp2f(m_run[hf] - m_new);
        m_run[hf] = m_new;
      }
    }
    float psum[2] = {0.f, 0.f};
    // kProbs: P also into the probabilities' buffer.  A compile-time choice:
    // as a runtime branch here it cost the kSurface instances without the
    // writes 18-22 %, and as a generic lambda over std::true_type /
    // false_type the head_dim 256 instances 2-8 % (outputs bitwise either
    // way; NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 2 and
    // chip_tools/k4_probe.py turns)
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = clamped ? exp2f(fminf(s[j][e], kClamp2)) : exp2f(s[j][e] - m_run[e >> 1]);
        psum[e >> 1] += p[e];
      }
      // kExtra: dropout after the row sums took the undropped P
      if (kExtra && dropout) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
          p[e] = fatt::drop_keep(drop_rows[e >> 1], col, threshold) ? __fdiv_rn(p[e], keep_div)
                                                                    : 0.f;
        }
      }
      if constexpr (kProbs) {
        const int col = k0 + j * 8 + (lane & 3) * 2;
        if (my_row < Sq) *reinterpret_cast<float2*>(p_row + col) = make_float2(p[0], p[1]);
        if (my_row + 8 < Sq)
          *reinterpret_cast<float2*>(p_row + 8 * p_pitch + col) = make_float2(p[2], p[3]);
      }
      fatt::put_p(pf, j, p);
    }
    // online: the running max this tile's P was taken against
    if (kProbs && !clamped && pmax != nullptr && (lane & 3) == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (my_row + hf * 8 < Sq)
          pmax[(((int64_t)b * H + h) * Sq + my_row + hf * 8) * nk + k0 / kBK] = m_run[hf];
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l_run[hf] = l_run[hf] * alpha[hf] + psum[hf];
    if (!clamped) {
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
    }

    // O += P V.
    fatt::attn_pv(o, pf, vs);
    __syncthreads();  // the stage is consumed before the ring refills it
  }
  fatt::cp_async_wait<0>();

  // Finalize: out = O / l (staged in this warp's rows of the drained ring,
  // then written as 16-byte rows); lse in natural-log units.
  float inv[2];
  bool valid[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float l = fatt::quad_sum(l_run[hf]);
    valid[hf] = l > 0.f && (clamped || m_run[hf] > kNegInf / 2);
    inv[hf] = valid[hf] ? 1.f / l : 0.f;
    const int row = my_row + hf * 8;
    if ((lane & 3) == 0 && row < Sq) {
      float x = kNegInf;
      if (valid[hf]) x = clamped ? logf(l) : m_run[hf] * kLn2 + logf(l);
      lse[((int64_t)b * H + h) * Sq + row] = x;
      // clamped_verify: exact where no key is live or the max stayed in
      // [-80, 80]
      if (track)
        vflag[((int64_t)b * H + h) * Sq + row] =
            !valid[hf] || (m_run[hf] <= kClamp2 && m_run[hf] >= kVerifyFloor2) ? 1.f : 0.f;
    }
  }
  const int lr = warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float x0 = valid[hf] ? o[j][2 * hf] * inv[hf] : 0.f;
      const float x1 = valid[hf] ? o[j][2 * hf + 1] * inv[hf] : 0.f;
      *reinterpret_cast<uint32_t*>(Os + swz<kD>(lr + hf * 8, j) + (lane & 3) * 4) =
          fatt::pack_bf16(x0, x1);
    }
  }
  __syncwarp();
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int idx = it * 32 + lane;
    const int r = warp * 16 + idx / kChunks, c = idx % kChunks;
    const int grow = row0 + r;
    if (grow < Sq)
      *reinterpret_cast<uint4*>(out + (((int64_t)b * Sq + grow) * H + h) * kD + c * 8) =
          *reinterpret_cast<const uint4*>(Os + swz<kD>(r, c));
  }
}

// The bias, dropout, ALiBi, return_softmax and clamped_verify arguments of
// the C entry, as the kernel takes them.
struct Extra {
  const float* bias;
  int64_t bs_b, bs_h, bs_q, bs_k;
  int dropout;
  uint32_t seed, threshold;
  float keep_div;
  const float* alibi2;
  float* probs;
  float* pmax;
  float* vflag;
};

template <int kD, bool kMeta, bool kLocal, bool kExtra, bool kSurface = false,
          bool kProbs = false, bool kWinIdx = false>
int launch(const void* q, const void* k, const void* v, const void* cosv,
           const void* sinv, void* out, void* lse, const void* qmeta,
           const void* kmeta, const void* qrange, const void* krange, int* tile_count,
           int B, int Sq, int Sk, int H, int Hk, int rope_bstride, float eff_scale,
           int causal, int clamped, int wleft, int wright, float softcap2, const Extra& x,
           cudaStream_t st) {
  static fatt::SmemLimitSet smem_set;
  constexpr int kSmemBytes = Dims<kD>::kSmemBytes;
  constexpr int kMaxSmem = kSmemBytes + (kExtra ? kBiasBytes : 0) +
                           (kMeta ? kStages * kMetaBytes + kMaxListTiles * 4 : 0);
  cudaError_t e = fatt::smem_limit_once(
      flash_fwd_kernel<kD, kMeta, kLocal, kExtra, kSurface, kProbs, kWinIdx>, kMaxSmem, smem_set);
  if (e != cudaSuccess) return (int)e;
  const int nk = (Sk + kBK - 1) / kBK;
  const int smem = kSmemBytes + (kExtra && x.bias != nullptr ? kBiasBytes : 0) +
                   (kMeta ? kStages * kMetaBytes + nk * 4 : 0);
  dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<kD, kMeta, kLocal, kExtra, kSurface, kProbs, kWinIdx>
      <<<grid, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(cosv),
      static_cast<const float*>(sinv), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), static_cast<const int2*>(qmeta),
      static_cast<const int2*>(kmeta), static_cast<const int4*>(qrange),
      static_cast<const int4*>(krange), tile_count, Sq, Sk, H, Hk, rope_bstride,
      eff_scale, causal, clamped, wleft, wright, softcap2, x.bias, x.bs_b, x.bs_h, x.bs_q,
      x.bs_k, x.dropout, x.seed, x.threshold, x.keep_div, x.alibi2, x.probs, x.pmax, x.vflag);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Sq, int H, int Hk, int D) {
  // Head dims 64 (GPT-2), 128 (Llama-3, Gemma-2-27B) and 256 (Gemma-2-9B) are built.
  return H % Hk != 0 || (D != 64 && D != 128 && D != 256) || B > 65535 ||
         (Sq + kBQ - 1) / kBQ > 65535;
}

// The kSurface instance, with masks or not, with return_softmax's writes or
// not.
template <int kD, bool kMeta>
auto surface_launch(bool probs) {
  return probs ? launch<kD, kMeta, false, true, true, true> : launch<kD, kMeta, false, true, true>;
}

}  // namespace

// cos/sin: [B or 1, Sq, D/2] fp32 with batch stride rope_bstride (0 when
// shared across the batch), or both null for no rotation.
// Segment ids and positions: qmeta [B, ceil(Sq/64)*64] and kmeta [B,
// ceil(Sk/64)*64] int32 pairs (segment, position), padded by repeating the
// last token; qrange [B, ceil(Sq/64)] and krange [B, ceil(Sk/64)] int32
// quads (least segment, least position, greatest segment, greatest
// position); a mask not given is 0 throughout.  All four null: no masks
// (the instance without them).  tile_count: null, or with masks int32[2]
// that head 0's blocks add their live and unmasked key tiles to.
// window_left / window_right: the window's sides (-1 open); softcap2: the
// logit softcap in base-2 units (cap * log2 e), 0 for none; both at
// head_dim 128 and 256 without masks, at 128 with them (the window then
// compares the positions, or with window_idx nonzero the indices: segment
// ids without positions; window_idx is ignored elsewhere).  Masks at
// head_dim 64 and 128.
// bias: null, or fp32 in natural units, element (b, h, i, j) at
// b bs_b + h bs_h + i bs_q + j bs_k (0 on a broadcast axis).  dropout:
// 0, or 1 with the seed's 32 bits, the keep threshold and keep_div =
// f32(1 - rate).  alibi2: null, or [H] fp32 ALiBi slopes times log2 e.
// probs: null, or fp32 [B, H, Sq, ceil(Sk/64)*64], zero-filled, for each
// walked tile's unnormalised P; pmax: null, or (online) fp32 [B, H, Sq,
// ceil(Sk/64)] for the running max each was taken against.  vflag: null,
// or (clamped) fp32 [B, H, Sq] for clamped_verify's row flags.  All of
// these at head_dim 64 and 128, with or without masks, without a window
// or softcap.
extern "C" int fatt_flash_fwd(const void* q, const void* k, const void* v,
                              const void* cosv, const void* sinv, void* out,
                              void* lse, const void* qmeta, const void* kmeta,
                              const void* qrange, const void* krange, int* tile_count,
                              int B, int Sq, int Sk, int H, int Hk, int D,
                              int rope_bstride, float eff_scale, int causal,
                              int clamped, int window_left, int window_right,
                              float softcap2, const float* bias, int64_t bs_b, int64_t bs_h,
                              int64_t bs_q, int64_t bs_k, int dropout, uint32_t seed,
                              uint32_t threshold, float keep_div, const float* alibi2,
                              float* probs, float* pmax, float* vflag, int window_idx,
                              void* stream) {
  const int given = (qmeta != nullptr) + (kmeta != nullptr) + (qrange != nullptr) +
                    (krange != nullptr);
  const bool local = window_left >= 0 || window_right >= 0 || softcap2 > 0.f;
  const bool surface = alibi2 != nullptr || probs != nullptr || vflag != nullptr;
  const bool extra = bias != nullptr || dropout != 0 || surface;
  // With masks a block lists at most kMaxListTiles key tiles.
  if (bad_shape(B, Sq, H, Hk, D) || window_left < -1 || window_right < -1 ||
      !(softcap2 >= 0.f) || (local && (D == 64 || (given != 0 && D != 128) || extra)) ||
      (extra && (D == 256 || !(keep_div > 0.f))) || (vflag != nullptr && !clamped) ||
      (pmax != nullptr && probs == nullptr) ||
      (given != 0 && (given != 4 || D == 256 || (Sk + kBK - 1) / kBK > kMaxListTiles)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Extra x{bias,   bs_b,    bs_h,  bs_q, bs_k, dropout, seed, threshold, keep_div,
                alibi2, probs, pmax, vflag};
  auto fn = D == 256 ? launch<256, false, true, false>
            : D == 64 ? (surface ? (given != 0 ? surface_launch<64, true>(probs != nullptr)
                                               : surface_launch<64, false>(probs != nullptr))
                         : extra ? (given != 0 ? launch<64, true, false, true>
                                               : launch<64, false, false, true>)
                                 : (given != 0 ? launch<64, true, false, false>
                                               : launch<64, false, false, false>))
            : surface    ? (given != 0 ? surface_launch<128, true>(probs != nullptr)
                                       : surface_launch<128, false>(probs != nullptr))
            : extra      ? (given != 0 ? launch<128, true, false, true>
                                       : launch<128, false, false, true>)
            : given != 0 ? (local ? (window_idx
                                         ? launch<128, true, true, false, false, false, true>
                                         : launch<128, true, true, false>)
                                  : launch<128, true, false, false>)
            : local      ? launch<128, false, true, false>
                         : launch<128, false, false, false>;
  return fn(q, k, v, cosv, sinv, out, lse, qmeta, kmeta, qrange, krange, tile_count, B, Sq,
            Sk, H, Hk, rope_bstride, eff_scale, causal, clamped, window_left, window_right,
            softcap2, x, st);
}

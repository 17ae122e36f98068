"""Paged flash-decode: attention of one query token (decode mode, kernel
K8, ``csrc/paged_decode.cu``) or of T causal query tokens (chunk mode, the
chunk kernel K8c, ``csrc/chunk_attn.cu``) per sequence over a pool of KV
pages addressed through a block table.

Port of flash_attn_tpu/ops/paged_decode.py (``paged_flash_decode`` and
``paged_flash_decode_chunk``).  Layouts:

  k_pages, v_pages: [num_pages, Hk, page, D]  bf16, int8 or float8_e4m3fn
                    (page 0 is the null page)
  k_scale, v_scale: [num_pages, Hk, page] fp32 in natural position order
  block_table:      [B, max_pages] int32 page ids
  kv_length:        [B] int32

The TPU's lane-dense [P, Hk, 1, page] scales with their evens-then-odds
order, the packed-fp8 bit decode, the per-call scale reconciliation and
the G-pages-per-grid-step grouping exist only for Mosaic and are not
ported.  A sliding window (each row sees the last ``window`` positions
below its limit) and the logit softcap (cap * tanh(s / cap) on the scaled
scores after the K scale, base 2 when clamped) run on both kernels'
kLocal instances, as JAX's kernel applies them (paged_decode.py:150-160,
224-226, 362-374): the walk starts at the key tile that holds the loosest
row's bound, max(0, kv_length - (T - 1) - window), so no page below the
window is read.

Chunk mode hands K8c the T tokens' query heads as virtual rows in (hk, t,
g) order, row t of a KV head seeing positions < kv_length - (T - 1) + t;
K8c also takes decode calls with more than 16 heads per KV head.  Both
kernels split each sequence's live walk, not the table's reach
(ops/decode.py ``split_bounds``); K8 merges its splits in the kernel, K8c's
merge in one launch of K1m.  Pages are walked up to the table's reach
(max_pages * page) at most, so an idle slot whose length has run past its
capacity reads only its own (null) table entries.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch import _build
from flash_attn_tpu_torch.ops.decode import (
    _KV_TYPES,
    LOG2E,
    NEG_INF,
    _chunk_splits,
    _clamp2,
    _default_softmax_mode,
    _qscale,
    merge_splits,
    split_bounds,
    split_partials,
)

# K8's key tile: a page holds a whole number of them.
TILE = 64
# K8 takes at most this many query rows per KV head; more go to K8c.
_MAX_GROUP = 16
_HEAD_DIMS = (64, 128)
# K8's (sequence, KV head, split) blocks to aim at: three per SM of the
# H100's 132, as many as its registers hold (157-168 a thread).  Measured
# best of 132-792 over both of chip_smoke.py's sets of lengths: more blocks
# add waves and longer merges, fewer lengthen the longest walks
# (chip_tools/k8_probe.py, PERF.md).
_TARGET_BLOCKS = 396


def _plan(batch: int, num_heads_k: int, rows: int, chunk: int, reach: int, num_splits,
          window=None):
    """(num_splits, split_len) of a call with ``rows`` query rows per KV
    head over a table whose reach is ``reach`` positions.  Both kernels cut
    each sequence's live walk into the splits (split_len None, ops/decode.py
    ``split_bounds``), so the host needs no lengths.  K8 (decode mode, at
    most ``_MAX_GROUP`` rows) aims at ``_TARGET_BLOCKS`` blocks, K8c at
    ops/decode.py's warpgroup target; at most one split per key tile of
    the walk's greatest length (``reach``, or with a window the window, the
    chunk and a tile of alignment), and the caller may fix the count."""
    if window is not None:
        reach = min(reach, window + chunk - 1 + TILE)
    if chunk > 1 or rows > _MAX_GROUP:  # K8c
        return _chunk_splits(batch, num_heads_k, rows, reach, num_splits), None
    if num_splits is None:
        num_splits = -(-_TARGET_BLOCKS // (batch * num_heads_k))
    return max(1, min(int(num_splits), -(-reach // TILE))), None


def paged_flash_decode(q, k_pages, v_pages, block_table, kv_length, *,
                       k_scale=None, v_scale=None, scale: float | None = None,
                       return_lse: bool = False, softmax_mode: str | None = None,
                       chunk: int = 1, num_splits: int | None = None,
                       window: int | None = None,
                       logit_softcap: float | None = None):
    """Single-token decode attention over a paged KV pool.

    q: [B, H, D]; pool, scales, table and lengths as the module docstring.
    softmax_mode: "online" or "clamped"; None follows the port's
      _default_softmax_mode (clamped for fp8 pages).
    chunk: internal (use paged_flash_decode_chunk): q rows are virtual
      rows, ``chunk`` tokens per KV head in (t, g) order, for K8c.
    num_splits: split-KV blocks per (sequence, KV head, row block), each
      taking a share of the sequence's live walk; None picks enough to fill
      the card.  Partials merge by the LSE rule: in K8 on the card,
      otherwise through ops/decode.py merge_splits.
    window: attend only to the last ``window`` positions below each row's
      limit; logit_softcap: cap * tanh(s / cap) on the scaled scores.
    Returns out [B, H, D] in q.dtype; with return_lse also lse [B, H] fp32.
    """
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")
    B, H, D = q.shape
    _, Hk, page, _ = k_pages.shape
    max_pages = block_table.shape[1]
    if H % Hk or (H // Hk) % chunk:
        raise ValueError(f"{H} virtual heads do not split into {Hk} KV heads x {chunk} tokens")
    if (k_scale is None) != (k_pages.dtype not in (torch.int8, torch.float8_e4m3fn)):
        raise ValueError("int8/fp8 pages need scales, float pages none")
    if scale is None:
        scale = D ** -0.5
    if softmax_mode is None:
        softmax_mode = _default_softmax_mode(k_pages.dtype, logit_softcap)
    if softmax_mode not in ("online", "clamped"):
        raise ValueError(f"unknown softmax_mode {softmax_mode!r}")
    clamped = softmax_mode == "clamped"
    clamp2 = _clamp2(k_pages.dtype)
    nsplit, split_len = _plan(B, Hk, H // Hk, chunk, max_pages * page, num_splits, window)
    args = (q, k_pages, v_pages, k_scale, v_scale, block_table, kv_length,
            scale, clamped, clamp2, chunk, nsplit, split_len)
    # the kLocal options, only when one is given
    local = {} if window is None and logit_softcap is None else dict(window=window,
                                                                     softcap=logit_softcap)
    fn = paged_flash_decode_cuda if q.is_cuda else paged_flash_decode_plain
    outs, lses = fn(*args, **local)
    out, lse = merge_splits(outs, lses, q.dtype)
    if return_lse:
        return out, lse
    return out


def paged_flash_decode_chunk(q, k_pages, v_pages, block_table, kv_length, *,
                             k_scale=None, v_scale=None,
                             scale: float | None = None,
                             return_lse: bool = False,
                             softmax_mode: str | None = None,
                             num_splits: int | None = None,
                             window: int | None = None,
                             logit_softcap: float | None = None):
    """T query tokens per sequence, causal within the chunk, over a paged
    pool that already holds the chunk's own KV at positions
    kv_length - T .. kv_length - 1 (append first, then score).

    q: [B, T, H, D]; kv_length INCLUDES the chunk's T tokens; num_splits as
    paged_flash_decode's.  Returns out [B, T, H, D] (+ lse [B, T, H] with
    return_lse)."""
    B, T, H, D = q.shape
    Hk = k_pages.shape[1]
    G = H // Hk
    # (hk, t, g)-major virtual heads: each KV head's rows stay contiguous
    q2 = (q.reshape(B, T, Hk, G, D).transpose(1, 2)
          .reshape(B, Hk * T * G, D).contiguous())
    res = paged_flash_decode(
        q2, k_pages, v_pages, block_table, kv_length, k_scale=k_scale,
        v_scale=v_scale, scale=scale, return_lse=return_lse,
        softmax_mode=softmax_mode, chunk=T, num_splits=num_splits, window=window,
        logit_softcap=logit_softcap)

    def unshuffle(x):
        rest = x.shape[2:]
        return (x.reshape(B, Hk, T, G, *rest).transpose(1, 2)
                .reshape(B, T, H, *rest))

    if return_lse:
        return unshuffle(res[0]), unshuffle(res[1])
    return unshuffle(res)


def _gather(pages, block_table):
    """pages [P, Hk, page, ...] -> each sequence's pages in table order,
    [B, Hk, max_pages * page, ...] (fp8 moves as bytes)."""
    fp8 = pages.dtype == torch.float8_e4m3fn
    src = pages.view(torch.uint8) if fp8 else pages
    g = src[block_table.long()]  # [B, mp, Hk, page, ...]
    B, mp, Hk, page = g.shape[:4]
    g = g.transpose(1, 2).reshape(B, Hk, mp * page, *g.shape[4:])
    return g.view(torch.float8_e4m3fn) if fp8 else g


def paged_flash_decode_plain(q, k_pages, v_pages, k_scale, v_scale,
                             block_table, kv_length, scale, clamped, clamp2,
                             chunk, nsplit, split_len, window=None, softcap=None):
    """Plain PyTorch version of K8 and K8c: the sequences' pages gathered
    into contiguous [B, Hk, max_pages * page, D] views, then K1's
    arithmetic with a causal limit per virtual row (and the last
    ``window`` positions below it; ``softcap`` on the scores after the K
    scale, in the softmax's units); ``split_len`` None splits the live walk
    as both kernels do, a windowed walk from a key tile.  Returns per-split
    (out [n, B, H, D] fp32, lse [n, B, H])."""
    B, H, D = q.shape
    Hk = k_pages.shape[1]
    R = H // Hk
    cdt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    k = _gather(k_pages, block_table)
    v = _gather(v_pages, block_table)
    S = k.shape[2]
    qs = (q.to(cdt) * _qscale(scale, clamped, cdt).to(q.device)).float()
    s = torch.einsum("bhrd,bhsd->bhrs", qs.view(B, Hk, R, D), k.to(cdt).float())
    vs = None
    if k_scale is not None:
        s = s * _gather(k_scale, block_table)[:, :, None, :]
        vs = _gather(v_scale, block_table)
    if softcap is not None:
        c = softcap * (LOG2E if clamped else 1.0)
        s = c * torch.tanh(s / c)
    # row r = t * G + g sees positions < kv_length - (chunk - 1) + t
    t = torch.arange(R, device=q.device) // (R // chunk)
    limit = kv_length.to(q.device).long()[:, None] - (chunk - 1) + t[None, :]
    pos = torch.arange(S, device=q.device)[None, None, :]
    valid = pos < limit[:, :, None]
    if window is not None:
        valid = valid & (pos >= limit[:, :, None] - window)
    s = torch.where(valid[:, None], s, torch.full_like(s, NEG_INF))
    bounds = split_bounds(nsplit, split_len, S, kv_length.to(q.device), window, chunk, TILE)
    outs, lses = split_partials(s, v, vs, clamped, clamp2, bounds, cdt)
    return outs.reshape(nsplit, B, H, D), lses.reshape(nsplit, B, H)


def _arrivals(device, batch: int, num_heads_k: int):
    """K8's per-(sequence, KV head) arrival counters: int32 zeros, made once
    per device and shape and reset by the kernel's last split, so that a
    captured CUDA graph replays against the same buffer.  The first call of
    a shape must come before any capture."""
    key = (device, batch, num_heads_k)
    buf = _ARRIVALS.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("K8's first call at this shape must come before CUDA graph "
                               "capture (its arrival counters are made then)")
        buf = _ARRIVALS[key] = torch.zeros((batch, num_heads_k), dtype=torch.int32,
                                           device=device)
    return buf


_ARRIVALS = {}


def paged_flash_decode_cuda(q, k_pages, v_pages, k_scale, v_scale,
                            block_table, kv_length, scale, clamped, clamp2,
                            chunk, nsplit, split_len, window=None, softcap=None):
    """Launch K8 (decode mode, at most 16 heads per KV head) or K8c.  Both
    replace flash_attn_tpu/ops/paged_decode.py:_paged_decode_kernel: K8 in
    decode mode, bound by bytes (csrc/paged_decode.cu); K8c in chunk mode,
    bound by operations at T = 128, and decode calls with more than 16
    heads per KV head (csrc/chunk_attn.cu).  Both take head_dim 64 or 128
    and split the live walk (``split_len`` None); a window or a softcap
    runs their kLocal instances (``fatt_paged_decode_local``,
    ``fatt_chunk_attn_local``), counted also in ``.local_launches`` (K8)
    and ``.chunk_local_launches`` (K8c).  Returns (out, lse): K8 merges its
    splits in the kernel, so out is [1, B, H, D] bf16; K8c writes that with
    one split, else fp32 partials [n, B, H, D] for K1m."""
    B, H, D = q.shape
    P, Hk, page, _ = k_pages.shape
    max_pages = block_table.shape[1]
    R = H // Hk
    if q.dtype != torch.bfloat16:
        raise ValueError("K8 takes a bf16 query")
    if k_pages.dtype not in _KV_TYPES or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"K8 takes bf16, int8 or fp8 pages, got {k_pages.dtype}")
    if D not in _HEAD_DIMS or split_len is not None:
        raise ValueError(f"K8 and K8c need head_dim 64 or 128 and split the live walk "
                         f"(split_len None); got D={D}, split_len={split_len}")
    if page % TILE:
        raise ValueError(f"K8 takes pages of a multiple of {TILE} tokens, got {page}")
    if block_table.dtype != torch.int32 or kv_length.dtype != torch.int32:
        raise ValueError("block_table and kv_length must be int32")
    if block_table.shape[0] != B or kv_length.shape != (B,):
        raise ValueError("block_table must be [B, max_pages] and kv_length [B]")
    tensors = [q, k_pages, v_pages, block_table, kv_length]
    if k_scale is not None:
        for s in (k_scale, v_scale):
            if s.shape != (P, Hk, page) or s.dtype != torch.float32:
                raise ValueError("scales must be [num_pages, Hk, page] fp32")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("K8 takes contiguous CUDA tensors")
    tiled = chunk > 1 or R > _MAX_GROUP
    part = None
    if nsplit > 1:
        part = torch.empty((nsplit, B, H, D), dtype=torch.float32, device=q.device)
    qscale = float(_qscale(scale, clamped, torch.bfloat16))
    local = window is not None or softcap is not None
    # the window and the softcap in the scores' units (base 2 when clamped)
    loc = (window or 0, 0.0 if softcap is None else float(softcap * (LOG2E if clamped else 1.0)))
    p = _build.ptr
    if tiled:
        out = None
        if nsplit == 1:
            out = torch.empty((1, B, H, D), dtype=torch.bfloat16, device=q.device)
        lse = torch.empty((nsplit, B, H), dtype=torch.float32, device=q.device)
        args = (p(q), p(k_pages), p(v_pages), p(k_scale), p(v_scale), p(block_table),
                p(kv_length), p(out), p(part), p(lse), B, Hk, R, chunk, 0, page,
                max_pages, D, _KV_TYPES[k_pages.dtype], nsplit, qscale, int(clamped),
                float(clamp2))
        if local:
            rc = _build.lib().fatt_chunk_attn_local(*args, *loc, _build.stream())
        else:
            rc = _build.lib().fatt_chunk_attn(*args, _build.stream())
        _build.check(rc, "fatt_chunk_attn")
        paged_flash_decode_cuda.chunk_launches += 1
        paged_flash_decode_cuda.chunk_local_launches += local
        paged_flash_decode_cuda.launches += 1
        paged_flash_decode_cuda.d64_launches += D == 64
        return (out if nsplit == 1 else part), lse
    out = torch.empty((1, B, H, D), dtype=torch.bfloat16, device=q.device)
    lse = torch.empty((1, B, H), dtype=torch.float32, device=q.device)
    part_lse = arrivals = None
    if nsplit > 1:
        part_lse = torch.empty((nsplit, B, H), dtype=torch.float32, device=q.device)
        arrivals = _arrivals(q.device, B, Hk)
    args = (p(q), p(k_pages), p(v_pages), p(k_scale), p(v_scale), p(block_table),
            p(kv_length), p(out), p(lse), p(part), p(part_lse), p(arrivals), B, Hk, R, page,
            max_pages, D, _KV_TYPES[k_pages.dtype], nsplit, qscale, int(clamped),
            float(clamp2))
    if local:
        rc = _build.lib().fatt_paged_decode_local(*args, *loc, _build.stream())
    else:
        rc = _build.lib().fatt_paged_decode(*args, _build.stream())
    _build.check(rc, "fatt_paged_decode")
    paged_flash_decode_cuda.launches += 1
    paged_flash_decode_cuda.local_launches += local
    paged_flash_decode_cuda.d64_launches += D == 64
    if nsplit > 1:
        paged_flash_decode_cuda.merges += 1
    return out, lse


# every launch (K8 and K8c), those of them on K8c, K8's in-kernel merges,
# the launches (K8 and K8c) at head_dim 64, and K8's and K8c's on their
# kLocal instances
paged_flash_decode_cuda.launches = 0
paged_flash_decode_cuda.chunk_launches = 0
paged_flash_decode_cuda.local_launches = 0
paged_flash_decode_cuda.chunk_local_launches = 0
paged_flash_decode_cuda.d64_launches = 0
paged_flash_decode_cuda.merges = 0

"""Flash-decode over a contiguous KV cache: attention of one query token
per sequence (``flash_decode``, kernel K1, ``csrc/decode.cu``) or of T
causal query tokens per sequence (``flash_decode_chunk``, the speculative
verify step, on the chunk kernel K1c, ``csrc/chunk_attn.cu``), split-KV
partials merged by the LSE rule.

Port of flash_attn_tpu/ops/decode.py with a bf16, int8 or fp8 cache in
either layout:

  kv_layout="bshd" (the default, as in JAX): k, v [B, S, Hk, D]; scales
      broadcastable to [B, S, Hk, 1].  JAX runs this layout through its
      legacy kernel ``_decode_kernel`` (online softmax only, the softmax
      scale applied to the scores); so does the port.
  kv_layout="bhsd" (the engine's cache): k, v [B, Hk, S, D]; scales
      [B, Hk, S] fp32 in natural position order.  JAX's
      ``_decode_kernel_bhsd``: online or clamped softmax, the softmax scale
      folded into a bf16 q.

K1 serves both layouts through a head stride and a token stride.  Chunk
mode reorders the T tokens' query heads into (hk, t, g) virtual rows; row
t of a KV head sees positions < kv_length - (T - 1) + t.  K1c takes those
rows on a BHSD cache, and decode calls with more than ``ROWS`` heads per
KV head; it splits the live walk, not the capacity (``split_bounds``).  The
TPU's packed e4m3 bit-decode (E4M3_FIX, P_SHIFT*) and its scale-lane
permutation exist only because of Mosaic and are not ported: Hopper
converts e4m3 natively.  A sliding window (the last ``window`` positions
below each row's limit) and the Gemma-2 logit softcap (cap * tanh(s /
cap) on the scaled scores, base 2 when clamped) run over a BHSD cache, as
JAX's ``_decode_kernel_bhsd`` does (decode.py:835-862, 931-940): on K1 in
decode mode, whose windowed call splits the live walk [max(0, len -
window), len), and on K1c's kLocal instances, whose walk starts at the
key tile that holds the loosest chunk row's bound, max(0, len - (T - 1) -
window); neither reads the keys below the window.  The BSHD layout raises
on both.  fp16 computes as bf16, as in JAX.

K1 also reads a shard view in place: a run of positions of a larger
cache buffer (the sequence-sharded decode's rank shard of the engine's
cache, ``parallel/sharded_decode.py``), whose sequence-axis stride it
takes apart from the run's length.  ``flash_decode_partials`` returns
the fp32 split partials and their LSEs unmerged, so that a caller merges
the splits of every shard in one K1m launch.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch import _build
from flash_attn_tpu_torch.ops.lse import lse_merge, lse_merge_cuda

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# Clamped-softmax score ceilings in base-2 units (decode.py:95-96).
CLAMP2_DEC = 80.0
CLAMP2_DEC_FP8 = 40.0
# K1's key tile; split lengths are multiples of it.
TILE = 64
# K1 takes at most this many query rows per KV head; more go to K1c.
ROWS = 8
# K1c's rows per warpgroup, and its warpgroups a block above that many rows
# (kWgRows and kWideW of csrc/chunk_attn.cu).
CHUNK_ROWS = 64
CHUNK_WIDE = 2
# Split-KV blocks to aim at: six per SM of the H100's 132.  Measured best
# of 132-1056 for the decode step at batch 8 (G=4 and G=8), now that a
# merge is one K1m launch (chip_tools/k1_probe.py, PERF.md).  K8 has its
# own target (ops/paged_decode.py).
_TARGET_BLOCKS = 792
# Warpgroups that K1c's and K8c's (sequence, KV head, row block, split)
# blocks aim at: two per SM of the H100's 132, as many as its registers
# hold (206-226 a thread).  Measured best of 66-792 at T=5 (one warpgroup
# a block) and near best at T=128 (two), where 9 splits cost 10-35 % more
# than 5 (chip_tools/chunk_probe.py, PERF.md).
_CHUNK_TARGET_WARPGROUPS = 264

_KV_TYPES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}
_LAYOUTS = ("bshd", "bhsd")


def _default_softmax_mode(kv_dtype, logit_softcap=None) -> str:
    """Clamped for fp8 KV (no running max), online otherwise; online also
    when a softcap's logit bound exceeds the fp8 clamped ceiling
    (decode.py:183-201)."""
    fp8 = kv_dtype.is_floating_point and kv_dtype.itemsize == 1
    if not fp8:
        return "online"
    if logit_softcap is not None and logit_softcap * LOG2E >= CLAMP2_DEC_FP8:
        return "online"
    return "clamped"


def _clamp2(kv_dtype) -> float:
    """The clamped-softmax ceiling (base 2) for this KV type."""
    return CLAMP2_DEC_FP8 if kv_dtype == torch.float8_e4m3fn else CLAMP2_DEC


def _splits(batch: int, num_heads_k: int, seqlen: int, num_splits,
            target: int | None = None):
    """(num_splits, split_len): enough (sequence, KV head, split) blocks to
    reach ``target`` (default ``_TARGET_BLOCKS``) unless the caller fixed
    the count."""
    if num_splits is None:
        num_splits = -(-(target or _TARGET_BLOCKS) // (batch * num_heads_k))
    num_splits = max(1, min(int(num_splits), -(-seqlen // TILE)))
    split_len = -(-(-(-seqlen // num_splits)) // TILE) * TILE
    return -(-seqlen // split_len), split_len


def _chunk_splits(batch: int, num_heads_k: int, rows: int, reach: int, num_splits,
                  target: int | None = None) -> int:
    """K1c's and K8c's split count: enough (sequence, KV head, row block,
    split) blocks to reach ``target`` warpgroups (default
    ``_CHUNK_TARGET_WARPGROUPS``) unless the caller fixed the count; at most
    one split per key tile of ``reach``.  The kernel cuts each sequence's
    live walk into that many splits (``split_bounds``), so the host needs
    no lengths."""
    if num_splits is None:
        wide = 1 if rows <= CHUNK_ROWS else CHUNK_WIDE
        warpgroups = batch * num_heads_k * -(-rows // (CHUNK_ROWS * wide)) * wide
        num_splits = -(-(target or _CHUNK_TARGET_WARPGROUPS) // warpgroups)
    return max(1, min(int(num_splits), -(-reach // TILE)))


def split_bounds(nsplit: int, split_len, S: int, kv_length=None, window=None, chunk: int = 1,
                 align: int = 1):
    """Each split's key range [lo, hi) over S positions.  With ``split_len``
    (K1) split i is [i * split_len, (i + 1) * split_len), the same for
    every sequence.  With ``split_len`` None (K8, K1c, K8c, and K1 with a
    window) it follows each sequence's live walk [w, min(kv_length, S)), as
    the kernels cut it: w = max(0, kv_length - (chunk - 1) - window), the
    loosest chunk row's bound, rounded down to a multiple of ``align``
    (K1: 1; the chunk kernel and K8, whose tiles keep to pages: TILE), 0
    without a window; n = ceil(walk / TILE) tiles from w, c = ceil(n /
    nsplit) a split, split i the tiles [i * c, (i + 1) * c); lo and hi are
    then [B] tensors."""
    if split_len is not None:
        return [(i * split_len, min(S, (i + 1) * split_len)) for i in range(nsplit)]
    kv = kv_length.long()
    start = torch.zeros_like(kv)
    if window is not None:
        start = torch.clamp(kv - (chunk - 1) - window, min=0) // align * align
    n = -(-torch.clamp(torch.clamp(kv, 0, S) - start, min=0) // TILE)
    per = -(-n // nsplit) * TILE
    return [(start + i * per, start + (i + 1) * per) for i in range(nsplit)]


def _heads_len(k, kv_layout):
    """(Hk, S) of a cache in ``kv_layout``."""
    if kv_layout not in _LAYOUTS:
        raise ValueError(f"unknown kv_layout {kv_layout!r}")
    return (k.shape[1], k.shape[2]) if kv_layout == "bhsd" else (k.shape[2], k.shape[1])


def _as_bf16(x):
    return x.to(torch.bfloat16) if x is not None and x.dtype == torch.float16 else x


def _check(k, k_scale, H, Hk, window, logit_softcap, kv_layout):
    if (window is not None or logit_softcap is not None) and kv_layout != "bhsd":
        raise NotImplementedError("window and logit_softcap are ported over a BHSD cache "
                                  "(K1, K1c), not for the BSHD layout")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")
    if H % Hk:
        raise ValueError(f"num_heads {H} not divisible by num_heads_k {Hk}")
    if (k_scale is None) != (k.dtype not in (torch.int8, torch.float8_e4m3fn)):
        raise ValueError("int8/fp8 caches need scales, float caches none")


def _mode(softmax_mode, kv_dtype, kv_layout, logit_softcap=None) -> bool:
    """Whether the softmax is clamped: the default follows the KV type and
    the softcap on BHSD (``_default_softmax_mode``); BSHD always runs
    online, as JAX's BSHD paths do (decode.py:248-249), whatever the mode
    asked."""
    if softmax_mode is None:
        softmax_mode = _default_softmax_mode(kv_dtype, logit_softcap)
    if softmax_mode not in ("online", "clamped"):
        raise ValueError(f"unknown softmax_mode {softmax_mode!r}")
    return softmax_mode == "clamped" and kv_layout == "bhsd"


def _bshd_scales(s, B, S, Hk):
    """BSHD scales broadcastable to [B, S, Hk, 1] -> contiguous [B, S, Hk]
    fp32, as JAX's scales_arg broadcasts them (decode.py:664-668)."""
    if s is None:
        return None
    return torch.broadcast_to(s, (B, S, Hk, 1))[..., 0].float().contiguous()


def flash_decode(q, k, v, *, kv_length=None, scale: float | None = None,
                 num_splits: int | None = None, k_scale=None, v_scale=None,
                 return_lse: bool = False, kv_layout: str = "bshd",
                 softmax_mode: str | None = None, window: int | None = None,
                 logit_softcap: float | None = None):
    """Single-token decode attention over a (possibly quantized) cache.

    q: [B, H, D]; k, v: [B, S, Hk, D] (kv_layout="bshd", the default) or
      [B, Hk, S, D] ("bhsd"), bf16, fp16, int8 or float8_e4m3fn (fp32 on
      the CPU);
    k_scale, v_scale: dequant scales of int8/fp8 caches, broadcastable to
      [B, S, Hk, 1] (bshd) or [B, Hk, S] fp32 (bhsd);
    kv_length: [B] int32 valid entries per sequence (None = all S); a
      value past S counts as S.
    num_splits: split-KV blocks per (sequence, KV head); None picks enough
      to fill the card.  Partials merge by the LSE rule (merge_splits).
    softmax_mode: "online" or "clamped"; None follows
      _default_softmax_mode (clamped for fp8 KV, online when a softcap
      reaches the fp8 ceiling).  BSHD runs online.
    window: attend only to the last ``window`` positions below kv_length
      (BHSD); logit_softcap: cap * tanh(s / cap) on the scaled scores
      (BHSD).
    Returns out [B, H, D] in q.dtype; with return_lse also lse [B, H] fp32.
    """
    if torch.float16 in (q.dtype, k.dtype):
        res = flash_decode(
            _as_bf16(q), _as_bf16(k), _as_bf16(v), kv_length=kv_length,
            scale=scale, num_splits=num_splits, k_scale=k_scale,
            v_scale=v_scale, return_lse=return_lse, kv_layout=kv_layout,
            softmax_mode=softmax_mode, window=window,
            logit_softcap=logit_softcap)
        return _restore_fp16(res, q.dtype, return_lse)
    out, lse = _decode(q, k, v, kv_length, scale, num_splits, k_scale, v_scale, kv_layout,
                       softmax_mode, window, logit_softcap, merge=True)
    return (out, lse) if return_lse else out


def flash_decode_partials(q, k, v, *, kv_length=None, scale: float | None = None,
                          num_splits: int | None = None, k_scale=None, v_scale=None,
                          kv_layout: str = "bshd", softmax_mode: str | None = None):
    """``flash_decode``'s split-KV partials before their merge: (out [n,
    B, H, D] fp32, lse [n, B, H] fp32), n the splits it plans for this
    cache, a split that sees no position at out 0 and lse -1e30.  Merged by
    the LSE rule (``merge_splits``) they give ``flash_decode``'s output.
    The cache may be a shard view (a run of positions of a larger buffer,
    sliced in place): K1 reads it where it lies.  fp16 computes as bf16."""
    q, k, v = _as_bf16(q), _as_bf16(k), _as_bf16(v)
    return _decode(q, k, v, kv_length, scale, num_splits, k_scale, v_scale, kv_layout,
                   softmax_mode, None, None, merge=False)


def _decode(q, k, v, kv_length, scale, num_splits, k_scale, v_scale, kv_layout,
            softmax_mode, window, logit_softcap, merge):
    B, H, D = q.shape
    Hk, S = _heads_len(k, kv_layout)
    _check(k, k_scale, H, Hk, window, logit_softcap, kv_layout)
    clamped = _mode(softmax_mode, k.dtype, kv_layout, logit_softcap)
    if kv_layout == "bshd":
        k_scale, v_scale = _bshd_scales(k_scale, B, S, Hk), _bshd_scales(v_scale, B, S, Hk)
    return _attend(q, k, v, k_scale, v_scale, kv_length, scale, clamped,
                   1, kv_layout, num_splits, window, logit_softcap, merge)


def flash_decode_chunk(q, k, v, *, kv_length, scale: float | None = None,
                       num_splits: int | None = None, k_scale=None,
                       v_scale=None, return_lse: bool = False,
                       kv_layout: str = "bhsd",
                       softmax_mode: str | None = None,
                       window: int | None = None,
                       logit_softcap: float | None = None):
    """T query tokens per sequence, causal within the chunk, over a cache
    that already holds the chunk's own KV at positions kv_length - T ..
    kv_length - 1 (append first, then score): the speculative verify step.

    q: [B, T, H, D]; kv_length [B] INCLUDES the chunk's T tokens; the
    cache and scales as ``flash_decode``'s, in kv_layout "bhsd" (the
    default, as in JAX) or "bshd".  The default softmax follows
    _default_softmax_mode (clamped for fp8) on BHSD.  BSHD chunks run
    online and only on the CPU: JAX sends them to its jnp oracle, and no
    path of the port needs them on the card.  window / logit_softcap as
    ``flash_decode``'s, row t's window ending at its own limit (BHSD; K1c's
    kLocal instances).  Returns out [B, T, H, D] (+ lse [B, T, H] with
    return_lse)."""
    if torch.float16 in (q.dtype, k.dtype):
        res = flash_decode_chunk(
            _as_bf16(q), _as_bf16(k), _as_bf16(v), kv_length=kv_length,
            scale=scale, num_splits=num_splits, k_scale=k_scale,
            v_scale=v_scale, return_lse=return_lse, kv_layout=kv_layout,
            softmax_mode=softmax_mode, window=window,
            logit_softcap=logit_softcap)
        return _restore_fp16(res, q.dtype, return_lse)
    B, T, H, D = q.shape
    Hk, S = _heads_len(k, kv_layout)
    _check(k, k_scale, H, Hk, window, logit_softcap, kv_layout)
    clamped = _mode(softmax_mode, k.dtype, kv_layout, logit_softcap)
    if kv_layout == "bshd":
        k_scale, v_scale = _bshd_scales(k_scale, B, S, Hk), _bshd_scales(v_scale, B, S, Hk)
    G = H // Hk
    # (hk, t, g)-major virtual heads: each KV head's rows stay contiguous
    q2 = q.reshape(B, T, Hk, G, D).transpose(1, 2).reshape(B, Hk * T * G, D).contiguous()
    out, lse = _attend(q2, k, v, k_scale, v_scale, kv_length, scale, clamped,
                       T, kv_layout, num_splits, window, logit_softcap)

    def unshuffle(x):
        rest = x.shape[2:]
        return x.reshape(B, Hk, T, G, *rest).transpose(1, 2).reshape(B, T, H, *rest)

    out = unshuffle(out)
    return (out, unshuffle(lse)) if return_lse else out


def _restore_fp16(res, dtype, return_lse):
    if dtype != torch.float16:
        return res
    if return_lse:
        return res[0].to(torch.float16), res[1]
    return res.to(torch.float16)


def _attend(q, k, v, k_scale, v_scale, kv_length, scale, clamped, chunk,
            layout, num_splits, window=None, softcap=None, merge=True):
    """(out in q.dtype, lse) of q [B, Hk * R, D] rows, R = chunk * G per KV
    head in (t, g) order, through K1 or K1c on the card or their plain
    version; without ``merge`` the fp32 split partials (K1 only).  A
    windowed call plans its splits on the walk's greatest length (K1:
    min(window, S); K1c: the window, the chunk and a tile of alignment), a
    count fixed by the shapes, and cuts them over each sequence's live
    walk."""
    B, rows, D = q.shape
    Hk, S = _heads_len(k, layout)
    if scale is None:
        scale = D ** -0.5
    if kv_length is None:
        kv_length = torch.full((B,), S, dtype=torch.int32, device=q.device)
    R = rows // Hk
    if layout == "bhsd" and (chunk > 1 or R > ROWS):  # K1c
        reach = S if window is None else min(S, window + chunk - 1 + TILE)
        nsplit, split_len = _chunk_splits(B, Hk, R, reach, num_splits), None
    elif window is not None:  # K1 over the live walk
        nsplit, split_len = _splits(B * -(-R // ROWS), Hk, min(window, S), num_splits)[0], None
    else:
        nsplit, split_len = _splits(B * -(-R // ROWS), Hk, S, num_splits)
    args = (q, k, v, k_scale, v_scale, kv_length, scale, clamped, _clamp2(k.dtype),
            nsplit, split_len, chunk, layout, window, softcap)
    if q.is_cuda:
        outs, lses = flash_decode_cuda(*args, partials=not merge)
    else:
        outs, lses = flash_decode_plain(*args)
    return merge_splits(outs, lses, q.dtype) if merge else (outs, lses)


def merge_splits(outs, lses, dtype):
    """(out in ``dtype``, lse) from per-split partials [n, ...] by the LSE
    rule; one split is taken as it is.  Several splits on the card merge
    in one launch of K1m, on the CPU through its plain version."""
    if outs.shape[0] == 1:
        return outs[0].to(dtype), lses[0]
    if outs.is_cuda:
        return lse_merge_cuda(outs, lses, dtype)
    out, lse = lse_merge(outs, lses, axis=0)
    return out.to(dtype), lse


def _qscale(scale, clamped, dtype):
    """The softmax scale folded into q, rounded to the compute dtype as the
    TPU kernel rounds it (log2(e) rides along in clamped mode)."""
    return torch.tensor(scale * (LOG2E if clamped else 1.0), dtype=dtype)


def flash_decode_plain(q, k, v, k_scale, v_scale, kv_length, scale, clamped,
                       clamp2, nsplit, split_len, chunk=1, layout="bhsd", window=None,
                       softcap=None):
    """Plain PyTorch version of K1 and K1c: returns per-split (out [n, B,
    rows, D] fp32, lse [n, B, rows]) for q [B, rows, D] (``chunk`` tokens
    per KV head in (t, g) order), with the kernels' roundings: on BHSD the
    bf16 q pre-scale, on BSHD the scale applied to the fp32 scores; bf16
    p * v_scale before PV; fp32 throughout for fp32 q.  ``split_len`` None
    splits the live walk as K1c and a windowed K1 do (``split_bounds``;
    K1c's windowed walk starts on a key tile).  ``softcap`` caps the
    scores after the K scale, in the softmax's units (base 2 when clamped);
    ``window`` keeps the last ``window`` positions below each row's
    limit."""
    B, rows, D = q.shape
    if layout == "bshd":
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        if k_scale is not None:
            k_scale, v_scale = k_scale.transpose(1, 2), v_scale.transpose(1, 2)
    _, Hk, S, _ = k.shape
    R = rows // Hk
    fold = layout == "bhsd"
    cdt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    qs = (q.to(cdt) * _qscale(scale if fold else 1.0, clamped, cdt).to(q.device)).float()
    s = torch.einsum("bhrd,bhsd->bhrs", qs.reshape(B, Hk, R, D), k.to(cdt).float())
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    if not fold:
        s = s * scale
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
    align = TILE if layout == "bhsd" and (chunk > 1 or R > ROWS) else 1  # K1c
    bounds = split_bounds(nsplit, split_len, S, kv_length.to(q.device), window, chunk, align)
    outs, lses = split_partials(s, v, v_scale, clamped, clamp2, bounds, cdt)
    return outs.reshape(nsplit, B, rows, D), lses.reshape(nsplit, B, rows)


def split_partials(s, v, v_scale, clamped, clamp2, bounds, cdt):
    """Softmax and PV of masked scores s [B, Hk, R, S] (fp32, NEG_INF where
    masked) against v [B, Hk, S, D] (v_scale [B, Hk, S] or None), one
    partial per key range of ``bounds`` (``split_bounds``): (out [n, B, Hk,
    R, D] fp32, lse [n, B, Hk, R]).  p * v_scale is rounded to ``cdt``
    before PV, as the kernels round it."""
    outs, lses = [], []
    pos = torch.arange(s.shape[-1], device=s.device)
    for lo, hi in bounds:
        if isinstance(lo, int):
            sl, vl = s[..., lo:hi], v[:, :, lo:hi]
            vsl = None if v_scale is None else v_scale[..., lo:hi]
        else:  # per-sequence ranges: mask the keys outside
            inside = (pos >= lo[:, None]) & (pos < hi[:, None])
            sl = torch.where(inside[:, None, None], s, torch.full_like(s, NEG_INF))
            vl, vsl = v, v_scale
        if clamped:
            p = torch.exp2(torch.clamp(sl, max=clamp2))
            m = None
        else:
            m = sl.amax(dim=-1, keepdim=True)
            p = torch.exp(sl - m)
        l = p.sum(dim=-1)  # [B, Hk, G]
        pv = p if vsl is None else p * vsl[:, :, None]
        o = torch.einsum("bhgs,bhsd->bhgd", pv.to(cdt).float(), vl.to(cdt).float())
        ok = l > 0
        lse = torch.log(torch.where(ok, l, torch.ones_like(l)))
        if m is not None:
            ok = ok & (m[..., 0] > NEG_INF / 2)
            lse = lse + m[..., 0]
        outs.append(torch.where(ok[..., None], o / torch.where(
            ok, l, torch.ones_like(l))[..., None], torch.zeros_like(o)))
        lses.append(torch.where(ok, lse, torch.full_like(lse, NEG_INF)))
    return torch.stack(outs), torch.stack(lses)


def _view_cap(t, layout):
    """The sequence-axis length of the buffer that ``t`` (K or V [B, Hk, S,
    D] / [B, S, Hk, D], or scales [B, Hk, S] / [B, S, Hk], in ``layout``)
    is a run of S positions of, sliced in place: S when ``t`` is
    contiguous; None when it is no such view."""
    if t.is_contiguous():
        return t.shape[2 if layout == "bhsd" else 1]
    shape, st = t.shape, t.stride()
    inner = shape[3] if t.ndim == 4 else 1
    if layout == "bhsd":  # [B, Hk, S(, D)]
        seq, cap = shape[2], st[1] // inner
        want = (shape[1] * cap * inner, cap * inner, inner)
    else:  # [B, S, Hk(, D)]
        seq, cap = shape[1], st[0] // (shape[2] * inner)
        want = (cap * shape[2] * inner, shape[2] * inner, inner)
    want += (1,) if t.ndim == 4 else ()
    ok = cap >= seq and all(s == w or n == 1 for s, w, n in zip(st, want, shape))
    return cap if ok else None


def flash_decode_cuda(q, k, v, k_scale, v_scale, kv_length, scale, clamped,
                      clamp2, nsplit, split_len, chunk=1, layout="bhsd", window=None,
                      softcap=None, partials=False):
    """Launch K1 or, for chunk > 1 or more than ``ROWS`` rows a KV head,
    K1c.  K1 replaces flash_attn_tpu/ops/decode.py:_decode_kernel_bhsd in
    decode mode (with its window and softcap; head_dim up to 256) and, on a BSHD
    cache, _decode_kernel; bound by bytes (see the source note in
    csrc/decode.cu).  A windowed K1 call takes ``split_len`` None and cuts
    each sequence's live walk in the kernel.  K1c replaces
    _decode_kernel_bhsd in chunk mode and takes BHSD decode calls with more
    than ``ROWS`` heads per KV head; bound by bytes at the verify step
    (csrc/chunk_attn.cu); a window or a softcap runs its kLocal instances
    (``fatt_chunk_attn_local``).  Returns (out, lse): with one split out is
    [1, B, rows, D] bf16 written by the kernel, else (and with ``partials``,
    K1 only) fp32 partials [n, B, rows, D].  K1 reads K, V and scales that
    are shard views (``_view_cap``) in place, through its view instances
    (``fatt_decode_view``), which also serve ``partials``.  Besides
    ``.launches`` it counts K1's windowed launches in ``.window_launches``,
    K1c's kLocal ones in ``.chunk_local_launches``,
    those at head_dim 256 in ``.d256_launches``, K1's and K1c's at
    head_dim 64 in ``.d64_launches``, and K1's through its view instances
    in ``.view_launches``."""
    B, rows, D = q.shape
    Hk, S = _heads_len(k, layout)
    if q.dtype != torch.bfloat16:
        raise ValueError("K1 takes a bf16 query")
    if k.dtype not in _KV_TYPES or v.dtype != k.dtype or v.shape != k.shape:
        raise ValueError(f"K1 takes a bf16, int8 or fp8 cache, got {k.dtype}")
    if rows % Hk or (rows // Hk) % chunk or D > 256 or D % 32:
        raise ValueError(f"K1 needs rows a multiple of Hk * chunk, D % 32 == 0 and "
                         f"D <= 256; got rows={rows}, Hk={Hk}, chunk={chunk}, D={D}")
    R = rows // Hk
    tiled = chunk > 1 or R > ROWS
    if layout == "bshd" and tiled:
        raise NotImplementedError(f"K1 takes a BSHD cache in decode mode, at most "
                                  f"{ROWS} heads per KV head")
    if (window is not None or softcap is not None) and layout == "bshd":
        raise NotImplementedError("K1 and K1c take a window and a softcap over a BHSD "
                                  "cache only")
    local = window is not None or softcap is not None
    if local and tiled and D not in (64, 128):
        raise NotImplementedError("K1c takes a window and a softcap at head_dim 64 and 128; "
                                  "above that K1 takes them in decode mode")
    live_walk = window is not None
    if (tiled or live_walk) != (split_len is None) or (tiled and D not in (64, 128)):
        raise ValueError("K1c (chunk > 1 or more than ROWS heads per KV head) and a "
                         "windowed K1 take split_len None, K1c D = 64 or 128; K1 a split_len")
    if kv_length.dtype != torch.int32 or kv_length.shape != (B,):
        raise ValueError("kv_length must be [B] int32")
    if partials and tiled:
        raise ValueError("K1c merges its own partials")
    if k_scale is not None:
        sshape = (B, Hk, S) if layout == "bhsd" else (B, S, Hk)
        for s in (k_scale, v_scale):
            if s.shape != sshape or s.dtype != torch.float32:
                raise ValueError(f"scales must be {list(sshape)} fp32")
    cache = (k, v) if k_scale is None else (k, v, k_scale, v_scale)
    for t in (q, kv_length, *cache):
        if not t.is_cuda:
            raise ValueError("K1 takes contiguous CUDA tensors")
    if not (q.is_contiguous() and kv_length.is_contiguous()):
        raise ValueError("K1 takes contiguous CUDA tensors")
    kv_cap = sc_cap = S
    if not all(t.is_contiguous() for t in cache):  # K1 reads shard views in place
        caps = [None if tiled else _view_cap(t, layout) for t in cache]
        if (None in caps or caps[0] != caps[1] or caps[-1] != caps[-2] or k.data_ptr() % 16
                or v.data_ptr() % 16):
            raise ValueError("K1 takes contiguous CUDA tensors or, in decode mode, 16-byte "
                             "aligned runs of positions of contiguous buffers")
        kv_cap, sc_cap = caps[0], caps[-1]
    # the view instances: shard views, and calls whose partials the caller merges
    view = not tiled and (partials or kv_cap != S or sc_cap != S)
    if nsplit == 1 and not view:
        out = torch.empty((1, B, rows, D), dtype=torch.bfloat16, device=q.device)
        part = None
    else:
        out = None
        part = torch.empty((nsplit, B, rows, D), dtype=torch.float32, device=q.device)
    lse = torch.empty((nsplit, B, rows), dtype=torch.float32, device=q.device)
    if layout == "bhsd":  # B1: scale folded into a bf16 q
        qscale, sscale = float(_qscale(scale, clamped, torch.bfloat16)), 1.0
    else:  # B12: scale applied to the scores
        qscale, sscale = 1.0, float(scale)
    p = _build.ptr
    # the softcap in the scores' units: base 2 when clamped
    cap = 0.0 if softcap is None else float(softcap * (LOG2E if clamped else 1.0))
    if tiled:
        args = (p(q), p(k), p(v), p(k_scale), p(v_scale), None, p(kv_length), p(out),
                p(part), p(lse), B, Hk, R, chunk, S, 0, 0, D, _KV_TYPES[k.dtype], nsplit,
                qscale, int(clamped), float(clamp2))
        if local:
            rc = _build.lib().fatt_chunk_attn_local(*args, window or 0, cap, _build.stream())
        else:
            rc = _build.lib().fatt_chunk_attn(*args, _build.stream())
        _build.check(rc, "fatt_chunk_attn")
        flash_decode_cuda.chunk_launches += 1
        flash_decode_cuda.chunk_local_launches += local
    else:
        args = (B, Hk, R, S, D, int(layout == "bshd"), _KV_TYPES[k.dtype], nsplit,
                split_len or 0, qscale, sscale, int(clamped), float(clamp2), window or 0, cap,
                _build.stream())
        if view:
            rc = _build.lib().fatt_decode_view(
                p(q), p(k), p(v), p(k_scale), p(v_scale), p(kv_length), p(part), p(lse),
                *args[:4], kv_cap, sc_cap, *args[4:])
            flash_decode_cuda.view_launches += 1
        else:
            rc = _build.lib().fatt_decode(p(q), p(k), p(v), p(k_scale), p(v_scale),
                                          p(kv_length), p(out), p(part), p(lse), *args)
        _build.check(rc, "fatt_decode")
        flash_decode_cuda.window_launches += live_walk
        flash_decode_cuda.d256_launches += D == 256
    flash_decode_cuda.launches += 1
    flash_decode_cuda.d64_launches += D == 64
    if layout == "bshd":
        flash_decode_cuda.bshd_launches += 1
    return (out if part is None else part), lse


# every launch (K1 and K1c), those of them on K1c (and on its kLocal
# instances) and on a BSHD cache, K1's with a window, at head_dim 256 and
# through the view instances, and K1's and K1c's at head_dim 64
flash_decode_cuda.launches = 0
flash_decode_cuda.chunk_local_launches = 0
flash_decode_cuda.view_launches = 0
flash_decode_cuda.chunk_launches = 0
flash_decode_cuda.bshd_launches = 0
flash_decode_cuda.window_launches = 0
flash_decode_cuda.d256_launches = 0
flash_decode_cuda.d64_launches = 0

"""FlashAttention-2 forward (kernel K4, ``csrc/flash_fwd.cu``).

Port of flash_attn_tpu/ops/flash_fwd.py:flash_fwd: BSHD layout, GQA,
head_dim 64, 128 or 256 on the card (any in the plain version),
bottom-right causal mask, segment ids and positions (the packed and
chunked prefill's masks; at head_dim 64 and 128 on the card), an additive
fp32 bias and reproducible dropout (the C ABI's attn_mask and dropout),
ALiBi, ``return_softmax`` and the ``clamped_verify`` flags (head_dim 64 and
128 on the card, with or without segment ids and positions), a sliding
window and the Gemma-2 logit softcap (at head_dim 128 and 256 on the
card; with segment ids and positions at 128, the window on the positions
where they are given, else on the indices), q-side RoPE inside the
kernel, softmax_mode "online", "clamped", "clamped_verify" or "auto",
fp32 LSE.  fp16 computes as bf16 and casts the output back, as JAX does.
A window or a softcap with a bias, dropout, ALiBi, ``return_softmax`` or
``clamped_verify`` raises ``NotImplementedError``, as does
``FlashConfig(softmax_dtype="bf16")``.

As on the TPU, the softmax scale and log2(e) are folded into q (rounded
to the input dtype), q is rotated in fp32 and rounded again before QK^T,
scores are base-2, and p is rounded to the V dtype before PV.  A (query,
key) pair is live only where every mask given holds, as ``_apply_mask``
composes them: causal by index, the window by index (by the positions
where they are given: flash_fwd.py:320-333), equal segment ids, kv
position <= q position.  The softcap is ``c * tanh(s / c)`` on the
scaled base-2 scores with c = cap * log2(e), before the mask
(flash_fwd.py:363-367, 757-761).  The bias is added to the base-2
scores as ``bias * log2(e)`` and clamped, ``max(s + bias, -1e30)``
(flash_fwd.py:369-372, 764-766).  ALiBi subtracts ``slope_h * log2(e) *
|i + Sk - Sq - j|`` after the bias and before the masks, on the query
head's slope and the row and column indices (never the positions), as
flash_fwd.py:374-388 and 872-876.  Dropout keeps an element where
``dropout_keep_mask`` (the JAX package's integer hash of the seed, the
batch and query-head index and the absolute row and column) says so and
scales it by 1 / (1 - rate) before PV; the row sums and the LSE are the
undropped P's (flash_fwd.py:451-456).  ``return_softmax`` has K4 write the
post-dropout P of each 64-key tile it walks, unnormalised (2^(s - m) with
the row's running max m, also written a tile; clamped: 2^min(s, 80)), and
``softmax_probs`` renormalises it outside as ``P = praw * exp(m ln 2 -
lse)`` (flash_fwd.py:1048-1061); tiles K4 skips stay 0.
``clamped_verify`` also tracks each row's running max in the clamped
mode, without subtracting it, and flags a row exact when it has no live
key or its max lies in [-80, 80] (flash_fwd.py:516-524).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from flash_attn_tpu_torch import _build
from flash_attn_tpu_torch.ops.rope import rope_rotate

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# Clamped-softmax score ceiling, base-2 units (flash_fwd.py:42), and the
# clamped_verify window's floor (flash_fwd.py:47).
CLAMP2 = 80.0
VERIFY_FLOOR2 = -80.0
SOFTMAX_MODES = ("online", "clamped", "clamped_verify", "auto")
TILE = 64  # K4's query rows a block and keys a tile
# K4 builds each block's list of live key tiles in shared memory
MAX_LIST_TILES = 4096


@dataclass(frozen=True)
class FlashConfig:
    """JAX's kernel configuration (flash_attn_tpu/ops/flash_fwd.py:51-116),
    field for field, so that code written against JAX builds one.

    ``softmax_mode`` is honoured: "online" (running max), "clamped" (no
    running max, p = 2^min(s, 80); exact for natural-units logits in
    (-87, 55]), "clamped_verify" (clamped, and ``flash_fwd`` also returns
    each row's exactness flag) or "auto" (clamped, rerun online when a row
    left the window).  ``block_q``, ``block_k``, ``vmem_limit_bytes``,
    ``split_causal_mask`` and ``triangular`` are the TPU's schedule knobs:
    K4's blocks are 64 queries by 64 keys whatever they say, so they change
    nothing here.  ``exp2=False`` changes only roundings on the TPU (the
    scores in natural units); K4 stays in base 2 and ignores it.
    ``softmax_dtype="bf16"`` changes results and is not ported: it raises
    ``NotImplementedError``."""

    block_q: int = 128
    block_k: int = 128
    vmem_limit_bytes: int | None = None
    exp2: bool = True
    split_causal_mask: bool = True
    triangular: bool = False
    softmax_dtype: str = "f32"
    softmax_mode: str = "online"


class Dropout(NamedTuple):
    """Dropout as the kernels take it: ``rate`` in (0, 1), ``seed`` an
    int32."""

    rate: float
    seed: int


_M32 = 0xFFFFFFFF
# the hash's constants (flash_fwd.py:182-185, 207-210), as uint32
_C1, _C2 = 0x9E3779B1, 0x85EBCA77
_M1, _M2, _F1, _F2 = 0x9E3779B9, 0x7FEB352D, 0x85EBCA6B, 0xC2B2AE35


def seed32(seed) -> int:
    """``seed`` as the int32 JAX makes of it (``jnp.asarray(seed,
    jnp.int32)``): a Python or numpy integer, or a one-element tensor, in
    [-2^31, 2^31); outside it raises ``OverflowError`` as JAX does."""
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(-1)[0].item()
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"Python integer {seed} out of bounds for int32")
    return seed


def seed_add(seed: int, offset: int) -> int:
    """seed + offset with int32 wraparound, as JAX adds int32 seeds (the
    rings' and Ulysses' per-rank seeds)."""
    return (seed + offset + 2 ** 31) % 2 ** 32 - 2 ** 31


def dropout_threshold(rate: float) -> int:
    """Bits at or above this are kept (flash_fwd.py:216-217)."""
    return min(int(rate * 4294967296.0), 4294967295)


def _mix_seed(seed, b, h) -> int:
    """Per-(batch, query head) seed, uint32 bits (flash_fwd.py:173-187)."""
    return (seed32(seed) & _M32) ^ ((int(b) * _C1) & _M32) ^ ((int(h) * _C2) & _M32)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and c < 2^32, without
    leaving int64: c in 16-bit halves."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def dropout_keep_mask(seed, b, h, row0, col0, block_q, block_k, rate, device=None):
    """Counter-based dropout keep-mask, [block_q, block_k] bool: JAX's
    ``dropout_keep_mask`` (flash_fwd.py:190-218) bit for bit, for any int32
    seed, batch index ``b``, query head ``h`` and absolute offsets.  The
    hash runs in int64 held to 32 bits, which is JAX's int32 arithmetic
    with wraparound and logical shifts."""
    row = torch.arange(block_q, dtype=torch.int64, device=device)[:, None] + int(row0)
    col = torch.arange(block_k, dtype=torch.int64, device=device)[None, :] + int(col0)
    x = (_mix_seed(seed, b, h) + _mul32(row, _M1) + _mul32(col, _M2)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, _F1)
    x = x ^ (x >> 13)
    x = _mul32(x, _F2)
    return (x ^ (x >> 16)) >= dropout_threshold(rate)


def keep_mask(dropout: Dropout, B: int, H: int, Sq: int, Sk: int, device, head0: int = 0):
    """[B, H, Sq, Sk] bool: every (batch, query head) plane of
    ``dropout_keep_mask``, query heads from ``head0``; made a plane at a
    time, so that the int64 hash needs a plane's memory, not the whole
    tensor's."""
    keep = torch.empty((B, H, Sq, Sk), dtype=torch.bool, device=device)
    for b in range(B):
        for h in range(H):
            keep[b, h] = dropout_keep_mask(dropout.seed, b, head0 + h, 0, 0, Sq, Sk,
                                           dropout.rate, device)
    return keep


def bias4(bias, B: int, H: int, Sq: int, Sk: int):
    """``bias`` as an fp32 [B, H, Sq, Sk] view (broadcast axes at stride 0;
    nothing materialised), or None.  Any shape that broadcasts to it is
    taken (flash_fwd.py:804-808)."""
    if bias is None:
        return None
    bias = bias if bias.dtype == torch.float32 else bias.float()
    try:
        return torch.broadcast_to(bias, (B, H, Sq, Sk))
    except RuntimeError:
        raise ValueError(f"bias of shape {tuple(bias.shape)} does not broadcast to "
                         f"[{B}, {H}, {Sq}, {Sk}]") from None


def dropout_arg(dropout_rate, dropout_seed):
    """A ``Dropout`` for a rate above 0, else None.  The seed is checked
    as an int32 either way, as JAX converts it either way."""
    seed = seed32(dropout_seed)
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout_rate must be in [0, 1), got {rate}")
    return Dropout(rate, seed) if rate > 0.0 else None


class Masks(NamedTuple):
    """Segment ids ([B, Sq] / [B, Sk]) and positions, each pair or None."""

    q_segment_ids: torch.Tensor | None
    kv_segment_ids: torch.Tensor | None
    q_positions: torch.Tensor | None
    kv_positions: torch.Tensor | None


def _masks(q_segment_ids, kv_segment_ids, q_positions, kv_positions, B, Sq, Sk):
    """The masks given, checked (each with its partner, [B, Sq] / [B, Sk]),
    or None when none is."""
    pairs = (("q_segment_ids", q_segment_ids, "kv_segment_ids", kv_segment_ids),
             ("q_positions", q_positions, "kv_positions", kv_positions))
    for qn, qv, kn, kv in pairs:
        if (qv is None) != (kv is None):
            given, missing = (qn, kn) if kv is None else (kn, qn)
            raise ValueError(f"{given} given without {missing}")
        if qv is not None and (tuple(qv.shape) != (B, Sq) or tuple(kv.shape) != (B, Sk)):
            raise ValueError(f"{qn} / {kn} must be [{B}, {Sq}] / [{B}, {Sk}], got "
                             f"{tuple(qv.shape)} / {tuple(kv.shape)}")
    if q_segment_ids is None and q_positions is None:
        return None
    return Masks(q_segment_ids, kv_segment_ids, q_positions, kv_positions)


def _window(window):
    """``window`` as a (left, right) pair of ints (-1: open), or None when
    both sides are open."""
    if window is None:
        return None
    left, right = (int(x) for x in window)
    if left < -1 or right < -1:
        raise ValueError(f"window sides must be >= -1, got {window}")
    return None if left == right == -1 else (left, right)


def local_args(window, softcap):
    """K4's, K9's and K10's window sides (-1 open) and softcap in base-2
    units (0 for none), as their C entries take them."""
    return (*(window or (-1, -1)), 0.0 if softcap is None else float(softcap * LOG2E))


def window_idx(window, masks) -> int:
    """K4's, K9's and K10's ``window_idx``: 1 where a window comes with
    segment ids and no positions, so that it compares the bottom-right
    aligned indices (``live_pairs``), else 0."""
    return int(window is not None and masks is not None and masks.q_positions is None)


def alibi_arg(alibi_slopes, H: int, device):
    """``alibi_slopes`` as an fp32 [H] tensor on ``device`` (no gradient),
    or None."""
    if alibi_slopes is None:
        return None
    if isinstance(alibi_slopes, torch.Tensor):
        alibi_slopes = alibi_slopes.detach()
    alibi = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=device).reshape(-1)
    if alibi.shape[0] != H:
        raise ValueError(f"alibi_slopes must be [{H}] (one a query head), got "
                         f"{tuple(alibi.shape)}")
    return alibi


def resolve_mode(softmax_mode, config) -> str:
    """The softmax mode a call runs: ``softmax_mode`` when given, else the
    config's ("online" without one); checks the config's softmax dtype."""
    cfg = config or FlashConfig()
    if cfg.softmax_dtype == "bf16":
        raise NotImplementedError("FlashConfig(softmax_dtype='bf16') is not ported yet")
    if cfg.softmax_dtype != "f32":
        raise ValueError(f"unknown softmax_dtype {cfg.softmax_dtype!r}")
    mode = cfg.softmax_mode if softmax_mode is None else softmax_mode
    if mode not in SOFTMAX_MODES:
        raise ValueError(f"unknown softmax_mode {mode!r}")
    return mode


def clamped_lse_valid(lse, seqlen_q: int, seqlen_k: int, *, causal: bool = False, window=None):
    """A 0-d bool tensor: every row of a clamped-mode forward was exact
    (flash_attn_tpu/ops/flash_fwd.py:543-582).  Reads only the [B, H, Sq]
    lse: a clamped element forces lse >= CLAMP2 ln 2, and lse >=
    VERIFY_FLOOR2 ln 2 bounds the mass lost to underflow below fp32
    rounding; lse = -1e30 is exact only where the row is dead by causal
    and window liveness (other masks need ``clamped_verify``)."""
    i = torch.arange(seqlen_q, dtype=torch.int32, device=lse.device)
    shift = seqlen_k - seqlen_q
    lo = torch.zeros_like(i)
    if causal:
        hi = torch.clamp(i + shift, max=seqlen_k - 1)
    else:
        hi = torch.full_like(i, seqlen_k - 1)
    if window is not None:
        wl, wr = window
        if wl >= 0:
            lo = torch.clamp(i + shift - wl, min=0)
        if wr >= 0:
            hi = torch.minimum(hi, i + shift + wr)
    row_live = hi >= lo
    finite = lse > NEG_INF / 2
    ok_rows = torch.where(finite, (lse <= CLAMP2 * LN2) & (lse >= VERIFY_FLOOR2 * LN2),
                          ~row_live[None, None, :])
    return ok_rows.all()


def flash_fwd(q, k, v, *, bias=None, causal: bool = False, scale: float | None = None,
              dropout_rate: float = 0.0, dropout_seed=0,
              rope_cos=None, rope_sin=None, softmax_mode: str | None = None,
              q_segment_ids=None, kv_segment_ids=None, q_positions=None,
              kv_positions=None, window=None, logit_softcap: float | None = None,
              alibi_slopes=None, config: FlashConfig | None = None,
              return_softmax: bool = False, **unported):
    """q: [B, Sq, H, D]; k, v: [B, Sk, Hk, D].  Returns (out [B, Sq, H, D]
    in q.dtype, lse [B, H, Sq] fp32); with ``return_softmax`` also the
    post-dropout probabilities [B, H, Sq, Sk] fp32, with softmax_mode
    "clamped_verify" also each row's exactness flag [B, H, Sq] fp32 (1
    exact, 0 not).

    bias: an additive fp32 bias that broadcasts to [B, H, Sq, Sk] (natural
    units; -inf entries are dead).  dropout_rate / dropout_seed (an int32):
    counter-based dropout of P before PV, the mask JAX's.
    rope_cos/rope_sin ([B, Sq, D/2] or [Sq, D/2] fp32): rotate the
    un-rotated q inside the kernel (K must come rotated).
    q_segment_ids/kv_segment_ids ([B, Sq] / [B, Sk] int): a query sees
    only keys of its own segment.  q_positions/kv_positions: a key is live
    only where kv_pos <= q_pos (per-sequence causality on a packed batch,
    or a chunk over a cache).  window (left, right): query i sees key j
    only where i + Sk - Sq - left <= j <= i + Sk - Sq + right, -1 leaving
    a side open (bottom-right aligned, as causal is); with positions
    q_pos - left <= kv_pos <= q_pos + right instead.  logit_softcap:
    scores become cap * tanh(s / cap) before the masks.  alibi_slopes
    ([H]): -slope_h * |i + Sk - Sq - j| on the scores (``ops/alibi``).
    softmax_mode: as ``FlashConfig.softmax_mode``, over the config's
    (``config``, default ``FlashConfig()``); "auto" on the card reads one
    flag on the host (one synchronisation) and so raises under CUDA graph
    capture.  A row with no live key gives 0 and lse -1e30."""
    for name, val in unported.items():
        if val is None or val is False or (isinstance(val, float) and val == 0.0):
            continue
        raise NotImplementedError(f"flash_fwd option {name!r} is not ported yet")
    mode = resolve_mode(softmax_mode, config)
    if mode == "auto":
        return _auto(q, k, v, dict(
            bias=bias, causal=causal, scale=scale, dropout_rate=dropout_rate,
            dropout_seed=dropout_seed, rope_cos=rope_cos, rope_sin=rope_sin,
            q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
            q_positions=q_positions, kv_positions=kv_positions, window=window,
            logit_softcap=logit_softcap, alibi_slopes=alibi_slopes), return_softmax)
    verify = mode == "clamped_verify"
    if verify and return_softmax:
        raise ValueError("clamped_verify does not compose with return_softmax")
    dtype = q.dtype
    if dtype == torch.float16:
        # fp16 computes as bf16 and the output is cast back (flash_fwd.py:636-656)
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    B, Sq, H, D = q.shape
    _, Sk, Hk, _ = k.shape
    if H % Hk:
        raise ValueError(f"num_heads {H} not divisible by num_heads_k {Hk}")
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("rope_cos and rope_sin go together")
    if rope_cos is not None and rope_cos.shape[-2:] != (Sq, D // 2):
        raise ValueError(f"rope tables must be [B, {Sq}, {D // 2}] or [{Sq}, {D // 2}]")
    masks = _masks(q_segment_ids, kv_segment_ids, q_positions, kv_positions, B, Sq, Sk)
    window = _window(window)
    bias = bias4(bias, B, H, Sq, Sk)
    dropout = dropout_arg(dropout_rate, dropout_seed)
    alibi = alibi_arg(alibi_slopes, H, q.device)
    if (window is not None or logit_softcap is not None) and (
            bias is not None or dropout is not None or alibi is not None
            or return_softmax or verify):
        raise NotImplementedError("flash_fwd: a window or a softcap with a bias, dropout, "
                                  "ALiBi, return_softmax or clamped_verify is not ported yet")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")
    if scale is None:
        scale = D ** -0.5
    clamped = mode != "online"
    args = (q, k, v, causal, scale, rope_cos, rope_sin, clamped, masks, window, logit_softcap,
            bias, dropout)
    fn = flash_fwd_cuda if q.is_cuda else flash_fwd_plain
    res = fn(*args, alibi=alibi, probs=return_softmax, verify=verify)
    out, lse = res[0].to(dtype), res[1]
    if return_softmax:
        return out, lse, softmax_probs(res[2], res[3], lse, Sk)
    if verify:
        return out, lse, res[2]
    return out, lse


def _auto(q, k, v, kw, return_softmax):
    """softmax_mode "auto" (flash_fwd.py:679-744): the clamped call, and
    the online one when some row left the clamped mode's exact window.
    Without a bias, segment ids or positions the clamped lse decides
    (``clamped_lse_valid``), else the clamped_verify flags.  JAX decides on
    the device (``lax.cond``); here the flag is read on the host."""
    if return_softmax:
        return flash_fwd(q, k, v, softmax_mode="online", return_softmax=True, **kw)
    if q.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("flash_fwd softmax_mode='auto' reads a flag on the host and cannot "
                           "be captured in a CUDA graph; pass 'clamped' or 'online'")
    if kw["bias"] is None and kw["q_segment_ids"] is None and kw["q_positions"] is None:
        out, lse = flash_fwd(q, k, v, softmax_mode="clamped", **kw)
        ok = clamped_lse_valid(lse, q.shape[1], k.shape[1], causal=kw["causal"],
                               window=_window(kw["window"]))
    else:
        out, lse, valid = flash_fwd(q, k, v, softmax_mode="clamped_verify", **kw)
        ok = valid.min() > 0.5
    if bool(ok):
        return out, lse
    return flash_fwd(q, k, v, softmax_mode="online", **kw)


def softmax_probs(praw, pmax, lse, Sk: int):
    """The probabilities [B, H, Sq, Sk] from K4's (or its plain version's)
    unnormalised tiles, in place: ``praw`` [B, H, Sq, nk*64] times exp(m
    ln 2 - lse) with ``pmax`` [B, H, Sq, nk] the running max m of each tile
    (base 2; None in clamped mode, m = 0); rows with lse -1e30 are 0
    (flash_fwd.py:1048-1061).  A view when Sk is not a multiple of 64."""
    B, H, Sq, W = praw.shape
    if pmax is None:
        scale = torch.exp(-lse)[..., None, None]
    else:
        scale = torch.exp(pmax * LN2 - lse[..., None])[..., None]
    p = praw.view(B, H, Sq, W // TILE, TILE).mul_(scale).view(B, H, Sq, W)
    p.masked_fill_((lse <= NEG_INF / 2)[..., None], 0.0)
    return p[..., :Sk]


def live_pairs(masks: Masks | None, causal: bool, Sq: int, Sk: int, device, window=None):
    """[B or 1, Sq, Sk] bool: the (query, key) pairs every mask leaves live;
    the window compares the positions where they are given, else the
    bottom-right aligned indices."""
    live = torch.ones((1, Sq, Sk), dtype=torch.bool, device=device)
    rows = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    cols = torch.arange(Sk, device=device)[None, :]
    if causal:
        live = live & (cols <= rows)
    if window is not None and masks is not None and masks.q_positions is not None:
        rows, cols = masks.q_positions[:, :, None], masks.kv_positions[:, None, :]
    if window is not None:
        left, right = window
        if left >= 0:
            live = live & (cols >= rows - left)
        if right >= 0:
            live = live & (cols <= rows + right)
    if masks is not None:
        qs, ks, qp, kp = masks
        if qs is not None:
            live = live & (qs[:, :, None] == ks[:, None, :])
        if qp is not None:
            live = live & (kp[:, None, :] <= qp[:, :, None])
    return live


def alibi_dist(Sq: int, Sk: int, device):
    """[Sq, Sk] fp32 |i + Sk - Sq - j|: ALiBi's distance, by index."""
    rows = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    cols = torch.arange(Sk, device=device)[None, :]
    return (rows - cols).abs().float()


def flash_fwd_plain(q, k, v, causal, scale, rope_cos, rope_sin, clamped, masks=None,
                    window=None, softcap=None, bias=None, dropout=None, head0=0, *,
                    alibi=None, probs=False, verify=False):
    """Plain PyTorch version of K4 (whole rows at once, same roundings).
    ``bias``: fp32 [B, H, Sq, Sk] (a view); ``dropout``: a ``Dropout``;
    ``head0``: the index of q's first query head, which keys the dropout
    (0 but for a run over a slice of the heads); ``alibi``: fp32 [H]
    slopes.  Returns (out, lse), with ``probs`` also K4's unnormalised
    tiles and their running maxima (``softmax_probs``' inputs: each 64-key
    tile's 2^(s - m) after dropout, m the running max of the row over the
    tiles up to it; None in clamped mode), with ``verify`` (clamped) also
    the exactness flags [B, H, Sq] fp32."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    if rope_cos is not None:
        qs = rope_rotate(qs, rope_cos.float(), rope_sin.float())
    kf = k.float().repeat_interleave(H // Hk, dim=2)
    vf = v.repeat_interleave(H // Hk, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kf)
    if softcap is not None:
        c2 = softcap * LOG2E  # the cap in base-2 units, as the scores
        s = c2 * torch.tanh(s / c2)
    if bias is not None:
        # base-2 units, clamped so that -inf entries stay finite
        s = torch.clamp(s + bias * LOG2E, min=NEG_INF)
    if alibi is not None:
        s = s - (alibi.float() * LOG2E)[None, :, None, None] * alibi_dist(Sq, Sk, q.device)
    if causal or masks is not None or window is not None:
        live = live_pairs(masks, causal, Sq, Sk, q.device, window)
        s = s.masked_fill(~live[:, None], NEG_INF)
    if clamped:
        p = torch.exp2(torch.clamp(s, max=CLAMP2))
        m = None
    else:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
    l = p.sum(dim=-1)  # [B, H, Sq]
    keep = div = None
    if dropout is not None:
        keep = keep_mask(dropout, B, H, Sq, Sk, q.device, head0)
        div = torch.full((), 1.0 - dropout.rate, dtype=torch.float32, device=q.device)
        p = torch.where(keep, p / div, torch.zeros((), device=q.device))
    extra = ()
    if probs:
        extra = _plain_tiles(s, clamped, keep, div)
    del keep
    if verify:
        mrow = s.amax(dim=-1)
        extra = (((l <= 0) | ((mrow <= CLAMP2) & (mrow >= VERIFY_FLOOR2))).float(),)
    del s
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
    ok = l > 0
    lse = torch.log(torch.where(ok, l, torch.ones_like(l)))
    if m is not None:
        ok = ok & (m[..., 0] > NEG_INF / 2)
        lse = lse + m[..., 0] * LN2
    lse = torch.where(ok, lse, torch.full_like(lse, NEG_INF))
    l_b = torch.where(ok, l, torch.ones_like(l)).transpose(1, 2)[..., None]
    out = torch.where(ok.transpose(1, 2)[..., None], o / l_b, torch.zeros_like(o))
    return (out.to(q.dtype), lse, *extra)


def _plain_tiles(s, clamped, keep, div):
    """(praw [B, H, Sq, nk*64], pmax [B, H, Sq, nk] or None) as K4 writes
    them for ``return_softmax``, from the masked base-2 scores ``s``: each
    64-key tile's 2^(s - m) with m the running max over the tiles up to it
    (clamped: 2^min(s, 80)), dropped by ``keep`` / ``div``."""
    B, H, Sq, Sk = s.shape
    nk = -(-Sk // TILE)
    sp = torch.nn.functional.pad(s, (0, nk * TILE - Sk), value=NEG_INF)
    if clamped:
        praw, pmax = torch.exp2(torch.clamp(sp, max=CLAMP2)), None
    else:
        tiles = sp.view(B, H, Sq, nk, TILE)
        pmax = torch.cummax(tiles.amax(dim=-1), dim=-1).values
        praw = torch.exp2(tiles - pmax[..., None]).view(B, H, Sq, nk * TILE)
    if keep is not None:
        praw[..., :Sk] = torch.where(keep, praw[..., :Sk] / div, torch.zeros((), device=s.device))
    return praw, pmax


def tile_meta(segment_ids, positions, B: int, S: int):
    """K4's view of one side's masks: ``meta`` [B, n*64, 2] int32 (segment
    id, position) a token, padded to whole 64-token tiles by repeating the
    last token, and ``ranges`` [B, n, 4] int32 a tile (least segment, least
    position, greatest segment, greatest position).  A mask not given is
    0 throughout, which every tile test passes."""
    dev = (segment_ids if segment_ids is not None else positions).device
    zero = torch.zeros((B, S), dtype=torch.int32, device=dev)
    meta = torch.stack([zero if x is None else x.to(torch.int32)
                        for x in (segment_ids, positions)], dim=-1)
    n = -(-S // TILE)
    if n * TILE > S:
        meta = torch.cat([meta, meta[:, -1:].expand(B, n * TILE - S, 2)], dim=1)
    lo, hi = torch.aminmax(meta.view(B, n, TILE, 2), dim=2)
    return meta.contiguous(), torch.cat([lo, hi], dim=-1).contiguous()


def _tiles(masks: Masks, B: int, Sq: int, Sk: int):
    """(qmeta, kmeta, qranges, kranges) of ``masks`` for K4, made once for
    the same mask tensors: a prefill's layers pass the same ones, so only
    its first layer pays for the reductions.  The last call's tensors are
    held; another tensor, shape, or an in-place change to one (its
    version) makes them anew, and so does every call on inference tensors,
    which keep no version."""
    given = [x for x in masks if x is not None]
    key = None
    if not any(x.is_inference() for x in given):
        key = (B, Sq, Sk, tuple(x._version for x in given))
    last = _tiles.last
    if key is None or last is None or last[0] != key or not all(
            a is b for a, b in zip(last[1], masks)):
        qmeta, qranges = tile_meta(masks.q_segment_ids, masks.q_positions, B, Sq)
        kmeta, kranges = tile_meta(masks.kv_segment_ids, masks.kv_positions, B, Sk)
        last = (key, tuple(masks), (qmeta, kmeta, qranges, kranges))
        _tiles.last = last if key is not None else None
    return last[2]


_tiles.last = None


def extra_args(bias, dropout):
    """The bias pointer and its four strides, and the dropout's flag,
    seed bits, threshold and divisor f32(1 - rate), as K4's C entry takes
    them (K9's and K10's take the multiplier 1 / (1 - rate) instead)."""
    strides = (0, 0, 0, 0) if bias is None else bias.stride()
    if dropout is None:
        return (_build.ptr(bias), *strides, 0, 0, 0, 1.0)
    return (_build.ptr(bias), *strides, 1, dropout.seed & _M32,
            dropout_threshold(dropout.rate), 1.0 - dropout.rate)


def surface_args(alibi2=None, praw=None, pmax=None, valid=None):
    """The ALiBi slopes (times log2 e), the unnormalised-P and running-max
    buffers of ``return_softmax`` and the clamped_verify flags, as K4's C
    entry takes them after the dropout's (null for none)."""
    return tuple(_build.ptr(t) for t in (alibi2, praw, pmax, valid))


def flash_fwd_cuda(q, k, v, causal, scale, rope_cos, rope_sin, clamped, masks=None,
                   window=None, softcap=None, bias=None, dropout=None, *, alibi=None,
                   probs=False, verify=False):
    """Launch K4.  Replaces flash_attn_tpu/ops/flash_fwd.py:_fwd_kernel;
    bound by operations (see the source note in csrc/flash_fwd.cu).  A
    window or a softcap runs an instance of its own (kLocal) at head_dim
    128 or 256, and with masks one at 128 (kMeta and kLocal, counted also
    in ``.masked_local_launches``; its window compares the positions, or
    in its twin the indices where segment ids come without positions); at
    64 it raises.  A bias or dropout runs
    an instance of its own (kExtra) at head_dim 64 or 128, with or without
    masks; ALiBi (``alibi``: fp32 [H] slopes), ``probs`` (return_softmax)
    or ``verify`` (clamped_verify) one beside it that extends it
    (kSurface).  Returns (out, lse), with
    ``probs`` also praw and pmax (``softmax_probs``' inputs; pmax None when
    clamped), with ``verify`` also the flags.  With masks it counts its
    launches also in ``.seg_launches`` (segment ids given) and
    ``.pos_launches`` (positions given); at head_dim 256 also in
    ``.d256_launches``, at 64 in ``.d64_launches``, with a window in
    ``.window_launches``, every launch of a kLocal instance (a window
    or a softcap, at any head dim: D = 256 always) in
    ``.local_launches``, and every launch of a kExtra or kSurface
    instance in ``.extra_launches`` (with dropout also in
    ``.dropout_launches``, with
    ALiBi in ``.alibi_launches``, with probs in ``.probs_launches``, with
    the flags in ``.verify_launches``)."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError("K4 takes bf16 q, k, v (fp16 computes as bf16 in flash_fwd)")
    if D not in (64, 128, 256):
        raise ValueError(f"K4 takes head_dim 64 (GPT-2), 128 (Llama-3) or 256 (Gemma-2-9B), "
                         f"got {D}")
    local = window is not None or softcap is not None
    surface = alibi is not None or probs or verify
    extra = bias is not None or dropout is not None or surface
    if D == 256 and (masks is not None or extra):
        raise NotImplementedError("K4 takes segment ids, positions, a bias, dropout, ALiBi, "
                                  "return_softmax and clamped_verify at head_dim 64 and 128")
    if local and (D == 64 or extra):
        raise NotImplementedError("K4 takes a window and a softcap at head_dim 128 and 256, "
                                  "without a bias or dropout")
    if verify and not clamped:
        raise ValueError("K4's clamped_verify flags come with the clamped mode")
    tensors = [q, k, v]
    bstride = 0
    if rope_cos is not None:
        if rope_cos.dtype != torch.float32 or rope_sin.dtype != torch.float32:
            raise ValueError("rope tables must be fp32")
        if rope_cos.ndim == 3 and rope_cos.shape[0] == B and B > 1:
            bstride = Sq * (D // 2)
        tensors += [rope_cos, rope_sin]
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("K4 takes contiguous CUDA tensors")
    if masks is not None:
        if not all(x.is_cuda for x in masks if x is not None):
            raise ValueError("K4 takes CUDA segment ids and positions")
        if -(-Sk // TILE) > MAX_LIST_TILES:
            raise ValueError(f"K4 with masks takes Sk <= {MAX_LIST_TILES * TILE}, got {Sk}")
    if bias is not None and (not bias.is_cuda or bias.dtype != torch.float32):
        raise ValueError("K4 takes an fp32 CUDA bias")
    if alibi is not None and (not alibi.is_cuda or alibi.shape != (H,)):
        raise ValueError(f"K4 takes [{H}] CUDA ALiBi slopes")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    alibi2 = None if alibi is None else (alibi.float() * LOG2E).contiguous()
    nk = -(-Sk // TILE)
    praw = pmax = valid = None
    if probs:
        # tiles K4 skips stay 0 (praw) and -1e30 (pmax): P = 0 there
        praw = torch.zeros((B, H, Sq, nk * TILE), dtype=torch.float32, device=q.device)
        if not clamped:
            pmax = torch.full((B, H, Sq, nk), NEG_INF, dtype=torch.float32, device=q.device)
    if verify:
        valid = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    p = _build.ptr
    tiles = (None,) * 4 if masks is None else _tiles(masks, B, Sq, Sk)
    rc = _build.lib().fatt_flash_fwd(
        p(q), p(k), p(v), p(rope_cos), p(rope_sin), p(out), p(lse), *(p(t) for t in tiles),
        None, B, Sq, Sk, H, Hk, D, bstride, float(scale * LOG2E), int(causal), int(clamped),
        *local_args(window, softcap), *extra_args(bias, dropout),
        *surface_args(alibi2, praw, pmax, valid), window_idx(window, masks), _build.stream())
    _build.check(rc, "fatt_flash_fwd")
    fn = flash_fwd_cuda
    fn.launches += 1
    if masks is not None:
        fn.seg_launches += masks.q_segment_ids is not None
        fn.pos_launches += masks.q_positions is not None
    fn.d256_launches += D == 256
    fn.d64_launches += D == 64
    fn.window_launches += window is not None
    fn.local_launches += local or D == 256
    fn.masked_local_launches += local and masks is not None
    fn.extra_launches += extra
    fn.dropout_launches += dropout is not None
    fn.alibi_launches += alibi is not None
    fn.probs_launches += bool(probs)
    fn.verify_launches += bool(verify)
    if probs:
        return out, lse, praw, pmax
    if verify:
        return out, lse, valid
    return out, lse


for _name in ("launches", "seg_launches", "pos_launches", "d256_launches", "d64_launches",
              "window_launches", "local_launches", "masked_local_launches", "extra_launches",
              "dropout_launches", "alibi_launches", "probs_launches", "verify_launches"):
    setattr(flash_fwd_cuda, _name, 0)

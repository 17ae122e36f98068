"""FlashAttention-2 forward (kernel K4, ``csrc/flash_fwd.cu``).

Port of flash_attn_tpu/ops/flash_fwd.py:flash_fwd for the subset the
Llama, Gemma-2 and GPT-2 prefill paths use: BSHD layout, GQA, head_dim
64, 128 or 256 on the card (any in the plain version), bottom-right causal mask,
segment ids and positions (the packed and chunked prefill's masks; at
head_dim 64 and 128 on the card), an additive fp32 bias and reproducible
dropout (the C ABI's attn_mask and dropout; head_dim 64 and 128 on the
card, with or without segment ids and positions), a sliding window and the
Gemma-2 logit softcap (at head_dim 128 and 256 on the card), q-side RoPE
inside the kernel, softmax_mode "clamped" or "online", fp32 LSE.  fp16
computes as bf16 and casts the output back, as JAX does.  A window or a
softcap with segment ids, positions, a bias or dropout, ALiBi and
return_softmax are still to port and raise ``NotImplementedError``.

As on the TPU, the softmax scale and log2(e) are folded into q (rounded
to the input dtype), q is rotated in fp32 and rounded again before QK^T,
scores are base-2, and p is rounded to the V dtype before PV.  A (query,
key) pair is live only where every mask given holds, as ``_apply_mask``
composes them: causal by index, the window by index, equal segment ids,
kv position <= q position.  The softcap is ``c * tanh(s / c)`` on the
scaled base-2 scores with c = cap * log2(e), before the mask
(flash_fwd.py:363-367, 757-761).  The bias is added to the base-2
scores as ``bias * log2(e)`` and clamped, ``max(s + bias, -1e30)``
(flash_fwd.py:369-372, 764-766).  Dropout keeps an element where
``dropout_keep_mask`` (the JAX package's integer hash of the seed, the
batch and query-head index and the absolute row and column) says so and
scales it by 1 / (1 - rate) before PV; the row sums and the LSE are the
undropped P's (flash_fwd.py:451-456).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from flash_attn_tpu_torch import _build
from flash_attn_tpu_torch.ops.rope import rope_rotate

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# Clamped-softmax score ceiling, base-2 units (flash_fwd.py:42).
CLAMP2 = 80.0
TILE = 64  # K4's query rows a block and keys a tile
# K4 builds each block's list of live key tiles in shared memory
MAX_LIST_TILES = 4096


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


def flash_fwd(q, k, v, *, bias=None, causal: bool = False, scale: float | None = None,
              dropout_rate: float = 0.0, dropout_seed=0,
              rope_cos=None, rope_sin=None, softmax_mode: str = "online",
              q_segment_ids=None, kv_segment_ids=None, q_positions=None,
              kv_positions=None, window=None, logit_softcap: float | None = None,
              **unported):
    """q: [B, Sq, H, D]; k, v: [B, Sk, Hk, D].  Returns (out [B, Sq, H, D]
    in q.dtype, lse [B, H, Sq] fp32).

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
    a side open (bottom-right aligned, as causal is).  logit_softcap:
    scores become cap * tanh(s / cap) before the masks.  A row with no
    live key gives 0 and lse -1e30."""
    for name, val in unported.items():
        if val is None or val is False or (isinstance(val, float) and val == 0.0):
            continue
        raise NotImplementedError(f"flash_fwd option {name!r} is not ported yet")
    dtype = q.dtype
    if dtype == torch.float16:
        # fp16 computes as bf16 and the output is cast back (flash_fwd.py:636-656)
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    B, Sq, H, D = q.shape
    _, Sk, Hk, _ = k.shape
    if H % Hk:
        raise ValueError(f"num_heads {H} not divisible by num_heads_k {Hk}")
    if softmax_mode not in ("online", "clamped"):
        raise NotImplementedError(f"softmax_mode {softmax_mode!r} is not ported yet")
    if (rope_cos is None) != (rope_sin is None):
        raise ValueError("rope_cos and rope_sin go together")
    if rope_cos is not None and rope_cos.shape[-2:] != (Sq, D // 2):
        raise ValueError(f"rope tables must be [B, {Sq}, {D // 2}] or [{Sq}, {D // 2}]")
    masks = _masks(q_segment_ids, kv_segment_ids, q_positions, kv_positions, B, Sq, Sk)
    window = _window(window)
    bias = bias4(bias, B, H, Sq, Sk)
    dropout = dropout_arg(dropout_rate, dropout_seed)
    if (window is not None or logit_softcap is not None) and (
            masks is not None or bias is not None or dropout is not None):
        raise NotImplementedError("flash_fwd: a window or a softcap with segment ids, "
                                  "positions, a bias or dropout is not ported yet")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")
    if scale is None:
        scale = D ** -0.5
    clamped = softmax_mode == "clamped"
    args = (q, k, v, causal, scale, rope_cos, rope_sin, clamped, masks, window, logit_softcap,
            bias, dropout)
    out, lse = flash_fwd_cuda(*args) if q.is_cuda else flash_fwd_plain(*args)
    return out.to(dtype), lse


def live_pairs(masks: Masks | None, causal: bool, Sq: int, Sk: int, device, window=None):
    """[B or 1, Sq, Sk] bool: the (query, key) pairs every mask leaves live."""
    live = torch.ones((1, Sq, Sk), dtype=torch.bool, device=device)
    rows = torch.arange(Sq, device=device)[:, None] + (Sk - Sq)
    cols = torch.arange(Sk, device=device)[None, :]
    if causal:
        live = live & (cols <= rows)
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


def flash_fwd_plain(q, k, v, causal, scale, rope_cos, rope_sin, clamped, masks=None,
                    window=None, softcap=None, bias=None, dropout=None, head0=0):
    """Plain PyTorch version of K4 (whole rows at once, same roundings).
    ``bias``: fp32 [B, H, Sq, Sk] (a view); ``dropout``: a ``Dropout``;
    ``head0``: the index of q's first query head, which keys the dropout
    (0 but for a run over a slice of the heads)."""
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
    if dropout is not None:
        keep = keep_mask(dropout, B, H, Sq, Sk, q.device, head0)
        div = torch.full((), 1.0 - dropout.rate, dtype=torch.float32, device=q.device)
        p = torch.where(keep, p / div, torch.zeros((), device=q.device))
        del keep
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vf)
    ok = l > 0
    lse = torch.log(torch.where(ok, l, torch.ones_like(l)))
    if m is not None:
        ok = ok & (m[..., 0] > NEG_INF / 2)
        lse = lse + m[..., 0] * LN2
    lse = torch.where(ok, lse, torch.full_like(lse, NEG_INF))
    l_b = torch.where(ok, l, torch.ones_like(l)).transpose(1, 2)[..., None]
    out = torch.where(ok.transpose(1, 2)[..., None], o / l_b, torch.zeros_like(o))
    return out.to(q.dtype), lse


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


def flash_fwd_cuda(q, k, v, causal, scale, rope_cos, rope_sin, clamped, masks=None,
                   window=None, softcap=None, bias=None, dropout=None):
    """Launch K4.  Replaces flash_attn_tpu/ops/flash_fwd.py:_fwd_kernel;
    bound by operations (see the source note in csrc/flash_fwd.cu).  A
    window or a softcap runs an instance of its own (kLocal) at head_dim
    128 or 256; at 64, or with masks, it raises.  A bias or dropout runs
    an instance of its own (kExtra) at head_dim 64 or 128, with or without
    masks.  With masks it counts its
    launches also in ``.seg_launches`` (segment ids given) and
    ``.pos_launches`` (positions given); at head_dim 256 also in
    ``.d256_launches``, at 64 in ``.d64_launches``, with a window in
    ``.window_launches``, every launch of a kLocal instance (a window
    or a softcap, at any head dim: D = 256 always) in
    ``.local_launches``, and every launch of a kExtra instance in
    ``.extra_launches`` (with dropout also in ``.dropout_launches``)."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError("K4 takes bf16 q, k, v (fp16 computes as bf16 in flash_fwd)")
    if D not in (64, 128, 256):
        raise ValueError(f"K4 takes head_dim 64 (GPT-2), 128 (Llama-3) or 256 (Gemma-2-9B), "
                         f"got {D}")
    local = window is not None or softcap is not None
    extra = bias is not None or dropout is not None
    if D == 256 and (masks is not None or extra):
        raise NotImplementedError("K4 takes segment ids, positions, a bias and dropout at "
                                  "head_dim 64 and 128")
    if local and (D == 64 or masks is not None or extra):
        raise NotImplementedError("K4 takes a window and a softcap at head_dim 128 and 256, "
                                  "without segment ids, positions, a bias or dropout")
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
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    p = _build.ptr
    tiles = (None,) * 4 if masks is None else _tiles(masks, B, Sq, Sk)
    rc = _build.lib().fatt_flash_fwd(
        p(q), p(k), p(v), p(rope_cos), p(rope_sin), p(out), p(lse), *(p(t) for t in tiles),
        None, B, Sq, Sk, H, Hk, D, bstride, float(scale * LOG2E), int(causal), int(clamped),
        *local_args(window, softcap), *extra_args(bias, dropout), _build.stream())
    _build.check(rc, "fatt_flash_fwd")
    flash_fwd_cuda.launches += 1
    if masks is not None:
        flash_fwd_cuda.seg_launches += masks.q_segment_ids is not None
        flash_fwd_cuda.pos_launches += masks.q_positions is not None
    flash_fwd_cuda.d256_launches += D == 256
    flash_fwd_cuda.d64_launches += D == 64
    flash_fwd_cuda.window_launches += window is not None
    flash_fwd_cuda.local_launches += local or D == 256
    flash_fwd_cuda.extra_launches += extra
    flash_fwd_cuda.dropout_launches += dropout is not None
    return out, lse


flash_fwd_cuda.launches = 0
flash_fwd_cuda.seg_launches = 0
flash_fwd_cuda.pos_launches = 0
flash_fwd_cuda.d256_launches = 0
flash_fwd_cuda.d64_launches = 0
flash_fwd_cuda.window_launches = 0
flash_fwd_cuda.local_launches = 0
flash_fwd_cuda.extra_launches = 0
flash_fwd_cuda.dropout_launches = 0

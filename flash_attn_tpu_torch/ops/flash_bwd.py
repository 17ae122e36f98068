"""FlashAttention-2 backward (kernels K9 and K10, ``csrc/flash_bwd.cu``).

Port of flash_attn_tpu/ops/flash_bwd.py:flash_bwd for the subset the
GPT-2, Llama and Gemma-2 training steps, packed-document training and the
C ABI's backward entry points use: BSHD layout, GQA, bottom-right causal
mask, q-side RoPE, ``scale``, a sliding window and the logit softcap,
segment ids, positions, an additive bias and dropout (``_recompute_p_ds``,
flash_bwd.py:48-131).  On the card: head_dim 64 (GPT-2) and 128 (Llama-3)
with segment ids, positions, a bias or dropout and without window and
softcap, 128 (Gemma-2-27B) with them, causal or not, also with segment
ids and positions (Mistral-7B on packed documents, the windowed ring), or
256 (Gemma-2-9B) causal with or without them; ALiBi and dbias at head_dim
64 and 128 beside those options.  fp16 computes as bf16 and the gradients
are cast back (flash_bwd.py:300-312).  A window or a softcap with a bias,
dropout or ALiBi raises ``NotImplementedError`` (K4 has no such forward).

As on the TPU: ``delta = rowsum(dout * out)`` is plain fp32 arithmetic
outside the kernels; the dq pass (K9) and the dk/dv pass (K10) each
recompute P from (R(q), k, lse) and are deterministic (no atomics).  K9
runs first: it rotates q once and also writes R(q) in bf16, which K10
reads as it is.  K10 writes dk/dv per query head in fp32 and the GQA group
is summed here.  The recompute works in natural units, s = (R(q) k^T) *
scale, unlike the forward's base-2 scores, so P differs from the
forward's by rounding, as in the reference.  With the softcap, s becomes
cap * tanh(s / cap) before P, and dS = P (dP - delta) (1 - tanh^2) feeds
dq and dk while dv takes P.  The window (left, right; -1 open) keeps key
j for query i only where i + Sk - Sq - left <= j <= i + Sk - Sq + right,
or with positions where q_pos - left <= kv_pos <= q_pos + right.
The bias is added to the natural-unit scores after the cap; segment ids
and positions keep a pair where qs == ks and kp <= qp; dropout replays
the forward's mask: dP becomes keep ? dP / (1 - rate) : 0 before dS and
dv takes P dropped alike.  ALiBi subtracts slope_h * |i + Sk - Sq - j|
from the natural-unit scores after the bias (an additive constant: no
chain-rule factor on dS).  With ``want_dbias`` the dq pass (K9) also
writes dS = P (dP - delta), the bias's gradient before any broadcast, in
fp32 [B, H, Sq, Sk] (JAX writes it from the dk/dv pass; K9 holds dS in
the row-major order of that output), and ``_reduce_to_shape`` sums it
over the bias's broadcast axes (flash_bwd.py:549-620).
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch import _build
from flash_attn_tpu_torch.ops.flash_fwd import (
    LOG2E,
    MAX_LIST_TILES,
    _M32,
    _masks,
    _tiles,
    _window,
    alibi_arg,
    alibi_dist,
    bias4,
    dropout_arg,
    dropout_threshold,
    keep_mask,
    live_pairs,
    local_args,
    window_idx,
)
from flash_attn_tpu_torch.ops.rope import rope_rotate, rope_unrotate

NEG_INF = -1e30


def _unset(val) -> bool:
    return val is None or val is False or (isinstance(val, (int, float)) and val == 0)


def flash_bwd(q, k, v, out, lse, dout, *, bias=None, q_segment_ids=None,
              kv_segment_ids=None, q_positions=None, kv_positions=None,
              causal: bool = False, scale: float | None = None, dropout_rate: float = 0.0,
              dropout_seed=0, rope_cos=None, rope_sin=None, window=None,
              logit_softcap: float | None = None, alibi_slopes=None, want_dbias: bool = False,
              config=None, **unported):
    """q, out, dout: [B, Sq, H, D]; k, v: [B, Sk, Hk, D]; lse [B, H, Sq]
    fp32.  Returns (dq, dk, dv) in the dtypes of q, k, v, and with
    ``want_dbias`` (dq, dk, dv, dbias), dbias the bias's shape and dtype.

    rope_cos/rope_sin ([B, Sq, D/2] or [Sq, D/2] fp32): q arrives
    un-rotated, as in the forward; dq is w.r.t. the un-rotated q.
    bias, segment ids, positions, dropout, window, logit_softcap and
    alibi_slopes as the forward took them (``flash_fwd``); the dropout
    mask is replayed from the same seed.  ``config`` (a ``FlashConfig``)
    holds only the TPU's block shapes here and changes nothing."""
    del config
    for name, val in unported.items():
        if not _unset(val):
            raise NotImplementedError(f"flash_bwd option {name!r} is not ported yet")
    if want_dbias and bias is None:
        raise ValueError("want_dbias=True requires a bias")
    dtype = q.dtype
    if dtype == torch.float16:
        # fp16 computes as bf16 and the gradients are cast back (flash_bwd.py:300-312)
        q, k, v, out, dout = (x.to(torch.bfloat16) for x in (q, k, v, out, dout))
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
    bias_in = bias
    bias = bias4(bias, B, H, Sq, Sk)
    dropout = dropout_arg(dropout_rate, dropout_seed)
    alibi = alibi_arg(alibi_slopes, H, q.device)
    if (window is not None or logit_softcap is not None) and (
            bias is not None or dropout is not None or alibi is not None):
        raise NotImplementedError("flash_bwd: a window or a softcap with a bias, dropout or "
                                  "ALiBi is not ported yet")
    if logit_softcap is not None and not logit_softcap > 0:
        raise ValueError(f"logit_softcap must be > 0, got {logit_softcap}")
    if scale is None:
        scale = D ** -0.5
    # softmax_d (flash_attn.h:73): fp32 elementwise product and row sum
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, dout, lse, delta, causal, scale, rope_cos, rope_sin, window,
            logit_softcap, masks, bias, dropout)
    fn = flash_bwd_cuda if q.is_cuda else flash_bwd_plain
    res = fn(*args, alibi=alibi, want_ds=want_dbias)
    dq, dk, dv = res[:3]
    group = H // Hk

    def reduce(g, like):  # [B, H, Sk, D] per query head -> [B, Sk, Hk, D]
        g = g.reshape(B, Hk, group, Sk, D).sum(2) if group > 1 else g
        return g.transpose(1, 2).to(like.dtype)

    grads = tuple(g.to(dtype) for g in (dq.to(q.dtype), reduce(dk, k), reduce(dv, v)))
    if not want_dbias:
        return grads
    return (*grads, _reduce_to_shape(res[3], bias_in.shape).to(bias_in.dtype))


def _reduce_to_shape(g, bias_shape):
    """Sum ds [B, H, Sq, Sk] down to the (broadcastable) bias shape
    (flash_bwd.py:614-620)."""
    pad = (1,) * (4 - len(bias_shape)) + tuple(bias_shape)
    for axis, (bs, fs) in enumerate(zip(pad, g.shape)):
        if bs == 1 and fs != 1:
            g = g.sum(dim=axis, keepdim=True)
    return g.reshape(bias_shape)


def flash_bwd_plain(q, k, v, dout, lse, delta, causal, scale, rope_cos, rope_sin,
                    window=None, softcap=None, masks=None, bias=None, dropout=None,
                    head0=0, *, alibi=None, want_ds=False):
    """Plain PyTorch version of K9 + K10 (whole rows at once, the kernels'
    roundings: R(q) in q's dtype, P in dout's and dS in k's/q's dtype
    before their products, fp32 accumulation).  Returns dq [B, Sq, H, D]
    and dk, dv [B, H, Sk, D] per query head, all fp32, and with
    ``want_ds`` dS [B, H, Sq, Sk] fp32 (before the softcap's factor).
    ``masks``: as flash_fwd's; ``bias``: fp32 [B, H, Sq, Sk] (a view);
    ``dropout``: a ``Dropout``; ``head0`` as flash_fwd_plain's;
    ``alibi``: fp32 [H] slopes."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    qr = q if rope_cos is None else rope_rotate(q, rope_cos.float(), rope_sin.float())
    kf = k.float().repeat_interleave(H // Hk, dim=2)
    vf = v.float().repeat_interleave(H // Hk, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qr.float(), kf) * scale
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    if bias is not None:
        s = s + bias
    if alibi is not None:
        s = s - alibi.float()[None, :, None, None] * alibi_dist(Sq, Sk, q.device)
    live = (lse > NEG_INF / 2)[..., None]
    if causal or window is not None or masks is not None:
        live = live & live_pairs(masks, causal, Sq, Sk, q.device, window)[:, None]
    lse_safe = torch.clamp(lse, min=NEG_INF / 2)[..., None]
    p = torch.where(live, torch.exp(s - lse_safe), torch.zeros_like(s))
    del s, live
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vf)
    p_v = p
    if dropout is not None:
        keep = keep_mask(dropout, B, H, Sq, Sk, q.device, head0)
        inv_keep = 1.0 / (1.0 - dropout.rate)
        zero = torch.zeros((), device=q.device)
        p_v = torch.where(keep, p * inv_keep, zero)
        dp = torch.where(keep, dp * inv_keep, zero)
        del keep
    ds = p * (dp - delta[..., None])
    ds_bias = ds
    if softcap is not None:
        ds = ds * (1.0 - t * t)  # through cap * tanh(s / cap)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kf) * scale
    if rope_cos is not None:
        dq = rope_unrotate(dq, rope_cos.float(), rope_sin.float())
    dv = torch.einsum("bhqk,bqhd->bhkd", p_v.to(dout.dtype).float(), dout.float())
    dk = torch.einsum("bhqk,bqhd->bhkd", ds.to(q.dtype).float(), qr.float()) * scale
    return (dq, dk, dv, ds_bias) if want_ds else (dq, dk, dv)


def _check_cuda(q, k, v, dout, lse, delta, rope_cos, rope_sin, name, causal=True,
                window=None, softcap=None, masks=None, bias=None, dropout=None, alibi=None,
                want_ds=False):
    """Raise on anything the kernels do not take; returns the rope tables'
    batch stride (0 when shared across the batch or absent)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    extra = bias is not None or dropout is not None or alibi is not None or want_ds
    local = window is not None or softcap is not None
    if D == 64 and local:
        raise NotImplementedError(f"{name} takes a window and a softcap at head_dim 128 and 256")
    if D == 256 and not causal:
        raise NotImplementedError(f"{name} at head_dim 256 is causal only")
    if (masks is not None or extra) and D == 256:
        raise NotImplementedError(f"{name} takes segment ids, positions, a bias, dropout, ALiBi "
                                  "and dbias at head_dim 64 and 128")
    if extra and local:
        raise NotImplementedError(f"{name} takes a window and a softcap with segment ids and "
                                  "positions, not with a bias, dropout, ALiBi or dbias")
    if not (q.dtype == k.dtype == v.dtype == dout.dtype == torch.bfloat16):
        raise ValueError(f"{name} takes bf16 q, k, v, dout (fp16 computes as bf16 in "
                         "flash_bwd)")
    if D not in (64, 128, 256):
        raise ValueError(f"{name} takes head_dim 64 (GPT-2), 128 (Llama-3) or 256 "
                         f"(Gemma-2-9B), got {D}")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise ValueError(f"{name} takes fp32 lse and delta")
    tensors = [q, k, v, dout, lse, delta]
    bstride = 0
    if rope_cos is not None:
        if rope_cos.dtype != torch.float32 or rope_sin.dtype != torch.float32:
            raise ValueError("rope tables must be fp32")
        if rope_cos.ndim == 3 and rope_cos.shape[0] == B and B > 1:
            bstride = Sq * (D // 2)
        tensors += [rope_cos, rope_sin]
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} takes contiguous, 16-byte aligned CUDA tensors")
    if masks is not None:
        if not all(x.is_cuda for x in masks if x is not None):
            raise ValueError(f"{name} takes CUDA segment ids and positions")
        if max(-(-Sq // 64), -(-Sk // 64)) > MAX_LIST_TILES:
            raise ValueError(f"{name} with masks takes Sq, Sk <= {MAX_LIST_TILES * 64}")
    if bias is not None and (not bias.is_cuda or bias.dtype != torch.float32):
        raise ValueError(f"{name} takes an fp32 CUDA bias")
    if alibi is not None and (not alibi.is_cuda or alibi.shape != (H,)):
        raise ValueError(f"{name} takes [{H}] CUDA ALiBi slopes")
    return bstride


def opt_args(masks, bias, dropout, B, Sq, Sk):
    """K9's and K10's option arguments: the four tile-metadata tensors (K4's,
    made once for the same mask tensors), the bias and its strides, and the
    dropout's flag, seed bits, threshold and 1 / (1 - rate)."""
    p = _build.ptr
    tiles = (None,) * 4 if masks is None else _tiles(masks, B, Sq, Sk)
    strides = (0, 0, 0, 0) if bias is None else bias.stride()
    drop = (0, 0, 0, 1.0) if dropout is None else (
        1, dropout.seed & _M32, dropout_threshold(dropout.rate), 1.0 / (1.0 - dropout.rate))
    return (*(p(t) for t in tiles), p(bias), *strides, *drop)


def _slopes2(alibi):
    """ALiBi's slopes times log2 e (fp32, as K4 takes them), or None."""
    return None if alibi is None else (alibi.float() * LOG2E).contiguous()


def _count(fn, D, window, softcap, masks=None, bias=None, dropout=None, alibi=None,
           want_ds=False):
    fn.launches += 1
    fn.d256_launches += D == 256
    fn.d64_launches += D == 64
    fn.window_launches += window is not None
    # a kLocal instance: a window or a softcap, or head_dim 256 (built so only)
    fn.local_launches += window is not None or softcap is not None or D == 256
    # a kOpt instance: segment ids, positions, a bias, dropout, ALiBi or dS
    # (with a window or a softcap, the kLocal and kOpt one: counted in both)
    fn.opt_launches += (masks is not None or bias is not None or dropout is not None
                        or alibi is not None or want_ds)
    fn.seg_launches += masks is not None and masks.q_segment_ids is not None
    fn.alibi_launches += alibi is not None
    fn.ds_launches += bool(want_ds)


def flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, scale, rope_cos, rope_sin,
                      window=None, softcap=None, masks=None, bias=None, dropout=None, *,
                      alibi=None, want_ds=False):
    """Launch K9 (replaces flash_attn_tpu/ops/flash_bwd.py:_dq_kernel;
    bound by operations at head_dim 128 and 256, by bytes at 64, see
    csrc/flash_bwd.cu).  Returns dq [B, Sq, H, D] fp32 and R(q)
    [B, Sq, H, D] bf16, the rotated q that K9 writes for K10 (q itself
    without rope tables), and with ``want_ds`` dS [B, H, Sq, Sk] fp32 (0
    where no key is live or K9 walks no tile).  Counts its launches also
    in ``.d256_launches`` (head_dim 256), ``.d64_launches`` (head_dim 64),
    ``.window_launches``, ``.local_launches`` (an instance with the window
    and the softcap: either given, or head_dim 256), ``.opt_launches`` (an
    instance with segment ids, positions, a bias and dropout, kOpt, or one
    that extends it with ALiBi and dS, kSurface: any given),
    ``.seg_launches`` (segment ids given), ``.alibi_launches`` (ALiBi
    given) and ``.ds_launches`` (dS written); a window or a softcap with
    segment ids or positions runs the kLocal and kOpt instance (its twin
    with the window on the indices where no positions are given), counted
    in both ``.local_launches`` and ``.opt_launches``."""
    bstride = _check_cuda(q, k, v, dout, lse, delta, rope_cos, rope_sin, "K9", causal,
                          window, softcap, masks, bias, dropout, alibi, want_ds)
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    dq = torch.empty((B, Sq, H, D), dtype=torch.float32, device=q.device)
    rq = q if rope_cos is None else torch.empty_like(q)
    ds = torch.zeros((B, H, Sq, Sk), dtype=torch.float32, device=q.device) if want_ds else None
    p = _build.ptr
    rc = _build.lib().fatt_flash_bwd_dq(
        p(q), p(k), p(v), p(dout), p(lse), p(delta), p(rope_cos), p(rope_sin),
        p(dq), p(rq), B, Sq, Sk, H, Hk, D, bstride, float(scale), int(causal),
        *local_args(window, softcap), *opt_args(masks, bias, dropout, B, Sq, Sk),
        p(_slopes2(alibi)), p(ds), window_idx(window, masks), _build.stream())
    _build.check(rc, "fatt_flash_bwd_dq")
    _count(flash_bwd_dq_cuda, D, window, softcap, masks, bias, dropout, alibi, want_ds)
    return (dq, rq, ds) if want_ds else (dq, rq)


def flash_bwd_dkv_cuda(rq, k, v, dout, lse, delta, causal, scale, window=None, softcap=None,
                       masks=None, bias=None, dropout=None, *, alibi=None):
    """Launch K10 (replaces flash_attn_tpu/ops/flash_bwd.py:_dkv_kernel;
    bound as K9) on R(q) from K9.  Returns dk, dv [B, H, Sk, D]
    fp32 per query head.  Counts its launches as K9 does."""
    _check_cuda(rq, k, v, dout, lse, delta, None, None, "K10", causal, window, softcap, masks,
                bias, dropout, alibi)
    B, Sq, H, D = rq.shape
    Sk, Hk = k.shape[1], k.shape[2]
    dk = torch.empty((B, H, Sk, D), dtype=torch.float32, device=rq.device)
    dv = torch.empty_like(dk)
    p = _build.ptr
    rc = _build.lib().fatt_flash_bwd_dkv(
        p(rq), p(k), p(v), p(dout), p(lse), p(delta), p(dk), p(dv),
        B, Sq, Sk, H, Hk, D, float(scale), int(causal), *local_args(window, softcap),
        *opt_args(masks, bias, dropout, B, Sq, Sk), p(_slopes2(alibi)),
        window_idx(window, masks), _build.stream())
    _build.check(rc, "fatt_flash_bwd_dkv")
    _count(flash_bwd_dkv_cuda, D, window, softcap, masks, bias, dropout, alibi)
    return dk, dv


def flash_bwd_cuda(q, k, v, dout, lse, delta, causal, scale, rope_cos, rope_sin,
                   window=None, softcap=None, masks=None, bias=None, dropout=None, *,
                   alibi=None, want_ds=False):
    """K9, then K10 on K9's R(q); each wrapper counts its own launches.
    Returns what flash_bwd_plain returns."""
    res = flash_bwd_dq_cuda(q, k, v, dout, lse, delta, causal, scale, rope_cos, rope_sin,
                            window, softcap, masks, bias, dropout, alibi=alibi,
                            want_ds=want_ds)
    dk, dv = flash_bwd_dkv_cuda(res[1], k, v, dout, lse, delta, causal, scale, window, softcap,
                                masks, bias, dropout, alibi=alibi)
    return (res[0], dk, dv, *res[2:])


for _fn in (flash_bwd_dq_cuda, flash_bwd_dkv_cuda):
    _fn.launches = _fn.d256_launches = _fn.d64_launches = _fn.window_launches = 0
    _fn.local_launches = _fn.opt_launches = _fn.seg_launches = 0
    _fn.alibi_launches = _fn.ds_launches = 0

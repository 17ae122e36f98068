"""Flash-decode: one query token per sequence against a BHSD KV cache
(kernel K1, ``csrc/decode.cu``), split-KV partials merged by the LSE rule.

Port of flash_attn_tpu/ops/decode.py:flash_decode for ``kv_layout="bhsd"``
with a bf16, int8 or fp8 cache.  Scales are [B, Hk, S] fp32 in natural
position order.  The TPU's packed e4m3 bit-decode (E4M3_FIX, P_SHIFT*)
and its scale-lane permutation exist only because of Mosaic and are not
ported: Hopper converts e4m3 natively.  Sliding windows and logit
softcaps are not on the Llama-3 path and raise for now.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch import _build
from flash_attn_tpu_torch.ops.lse import lse_merge

NEG_INF = -1e30
LOG2E = 1.4426950408889634
# Clamped-softmax score ceilings in base-2 units (decode.py:95-96).
CLAMP2_DEC = 80.0
CLAMP2_DEC_FP8 = 40.0
# K1's key tile; split lengths are multiples of it.
TILE = 64
# Blocks that fill the H100's 132 SMs twice over.
_TARGET_BLOCKS = 264

_KV_TYPES = {torch.bfloat16: 0, torch.int8: 1, torch.float8_e4m3fn: 2}


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


def _splits(batch: int, num_heads_k: int, seqlen: int, num_splits):
    """(num_splits, split_len): enough (sequence, KV head, split) blocks to
    fill the card unless the caller fixed the count."""
    if num_splits is None:
        num_splits = -(-_TARGET_BLOCKS // (batch * num_heads_k))
    num_splits = max(1, min(int(num_splits), -(-seqlen // TILE)))
    split_len = -(-(-(-seqlen // num_splits)) // TILE) * TILE
    return -(-seqlen // split_len), split_len


def flash_decode(q, k, v, *, kv_length=None, scale: float | None = None,
                 num_splits: int | None = None, k_scale=None, v_scale=None,
                 return_lse: bool = False, kv_layout: str = "bhsd",
                 softmax_mode: str | None = None, window: int | None = None,
                 logit_softcap: float | None = None):
    """Single-token decode attention over a (possibly quantized) cache.

    q: [B, H, D]; k, v: [B, Hk, S, D] (bf16, int8 or float8_e4m3fn);
    k_scale, v_scale: [B, Hk, S] fp32 dequant scales (quantized caches);
    kv_length: [B] int32 valid entries per sequence (None = all S); a
      value past S counts as S.
    num_splits: split-KV blocks per (sequence, KV head); None picks enough
      to fill the card.  Partials merge with ops.lse.lse_merge.
    softmax_mode: "online" or "clamped"; None follows
      _default_softmax_mode (clamped for fp8 KV).
    Returns out [B, H, D] in q.dtype; with return_lse also lse [B, H] fp32.
    """
    if kv_layout != "bhsd":
        raise NotImplementedError("only kv_layout='bhsd' is ported")
    if window is not None or logit_softcap is not None:
        raise NotImplementedError("window and logit_softcap are not ported yet")
    B, H, D = q.shape
    _, Hk, S, _ = k.shape
    if H % Hk:
        raise ValueError(f"num_heads {H} not divisible by num_heads_k {Hk}")
    if (k_scale is None) != (k.dtype not in (torch.int8, torch.float8_e4m3fn)):
        raise ValueError("int8/fp8 caches need scales, float caches none")
    if scale is None:
        scale = D ** -0.5
    if softmax_mode is None:
        softmax_mode = _default_softmax_mode(k.dtype, logit_softcap)
    if softmax_mode not in ("online", "clamped"):
        raise ValueError(f"unknown softmax_mode {softmax_mode!r}")
    clamped = softmax_mode == "clamped"
    clamp2 = _clamp2(k.dtype)
    if kv_length is None:
        kv_length = torch.full((B,), S, dtype=torch.int32, device=q.device)
    nsplit, split_len = _splits(B, Hk, S, num_splits)
    args = (q, k, v, k_scale, v_scale, kv_length, scale, clamped, clamp2,
            nsplit, split_len)
    if q.is_cuda:
        outs, lses = flash_decode_cuda(*args)
    else:
        outs, lses = flash_decode_plain(*args)
    out, lse = merge_splits(outs, lses, q.dtype)
    if return_lse:
        return out, lse
    return out


def merge_splits(outs, lses, dtype):
    """(out in ``dtype``, lse) from per-split partials [n, ...] by the LSE
    rule; one split is taken as it is."""
    if outs.shape[0] == 1:
        return outs[0].to(dtype), lses[0]
    out, lse = lse_merge(outs, lses, dim=0)
    return out.to(dtype), lse


def _qscale(scale, clamped, dtype):
    """The softmax scale folded into q, rounded to the compute dtype as the
    TPU kernel rounds it (log2(e) rides along in clamped mode)."""
    return torch.tensor(scale * (LOG2E if clamped else 1.0), dtype=dtype)


def flash_decode_plain(q, k, v, k_scale, v_scale, kv_length, scale, clamped,
                       clamp2, nsplit, split_len):
    """Plain PyTorch version of K1: returns per-split (out [n, B, H, D]
    fp32, lse [n, B, H]) with the kernel's roundings (bf16 q pre-scale,
    bf16 p * v_scale before PV; fp32 throughout for fp32 q)."""
    B, H, D = q.shape
    _, Hk, S, _ = k.shape
    G = H // Hk
    cdt = torch.float32 if q.dtype == torch.float32 else torch.bfloat16
    qs = (q.to(cdt) * _qscale(scale, clamped, cdt).to(q.device)).float()
    s = torch.einsum("bhgd,bhsd->bhgs", qs.view(B, Hk, G, D),
                     k.to(cdt).float())
    if k_scale is not None:
        s = s * k_scale[:, :, None, :]
    pos = torch.arange(S, device=q.device)
    valid = pos[None, :] < kv_length.to(q.device).long()[:, None]  # [B, S]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    outs, lses = split_partials(s, v, v_scale, clamped, clamp2, nsplit,
                                split_len, cdt)
    return outs.reshape(nsplit, B, H, D), lses.reshape(nsplit, B, H)


def split_partials(s, v, v_scale, clamped, clamp2, nsplit, split_len, cdt):
    """Softmax and PV of masked scores s [B, Hk, R, S] (fp32, NEG_INF where
    masked) against v [B, Hk, S, D] (v_scale [B, Hk, S] or None), one
    partial per ``split_len`` keys: (out [n, B, Hk, R, D] fp32, lse
    [n, B, Hk, R]).  p * v_scale is rounded to ``cdt`` before PV, as the
    kernels round it."""
    S = s.shape[-1]
    outs, lses = [], []
    for i in range(nsplit):
        lo, hi = i * split_len, min(S, (i + 1) * split_len)
        sl = s[..., lo:hi]
        if clamped:
            p = torch.exp2(torch.clamp(sl, max=clamp2))
            m = None
        else:
            m = sl.amax(dim=-1, keepdim=True)
            p = torch.exp(sl - m)
        l = p.sum(dim=-1)  # [B, Hk, G]
        pv = p if v_scale is None else p * v_scale[:, :, None, lo:hi]
        o = torch.einsum("bhgs,bhsd->bhgd", pv.to(cdt).float(),
                         v[:, :, lo:hi].to(cdt).float())
        ok = l > 0
        lse = torch.log(torch.where(ok, l, torch.ones_like(l)))
        if m is not None:
            ok = ok & (m[..., 0] > NEG_INF / 2)
            lse = lse + m[..., 0]
        outs.append(torch.where(ok[..., None], o / torch.where(
            ok, l, torch.ones_like(l))[..., None], torch.zeros_like(o)))
        lses.append(torch.where(ok, lse, torch.full_like(lse, NEG_INF)))
    return torch.stack(outs), torch.stack(lses)


def flash_decode_cuda(q, k, v, k_scale, v_scale, kv_length, scale, clamped,
                      clamp2, nsplit, split_len):
    """Launch K1.  Replaces flash_attn_tpu/ops/decode.py:_decode_kernel_bhsd;
    bound by bytes (see the source note in csrc/decode.cu).  Returns
    (out, lse): with one split out is [1, B, H, D] bf16 written by the
    kernel, else fp32 partials [n, B, H, D]."""
    B, H, D = q.shape
    _, Hk, S, _ = k.shape
    if q.dtype != torch.bfloat16:
        raise ValueError("K1 takes a bf16 query")
    if k.dtype not in _KV_TYPES or v.dtype != k.dtype:
        raise ValueError(f"K1 takes a bf16, int8 or fp8 cache, got {k.dtype}")
    if H // Hk > 8 or D > 128 or D % 32:
        raise ValueError(f"K1 needs H/Hk <= 8 and D % 32 == 0, D <= 128; "
                         f"got H={H}, Hk={Hk}, D={D}")
    if kv_length.dtype != torch.int32:
        raise ValueError("kv_length must be int32")
    tensors = [q, k, v, kv_length]
    if k_scale is not None:
        if k_scale.shape != (B, Hk, S) or k_scale.dtype != torch.float32:
            raise ValueError("scales must be [B, Hk, S] fp32")
        tensors += [k_scale, v_scale]
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("K1 takes contiguous CUDA tensors")
    if nsplit == 1:
        out = torch.empty((1, B, H, D), dtype=torch.bfloat16, device=q.device)
        part = None
    else:
        out = None
        part = torch.empty((nsplit, B, H, D), dtype=torch.float32,
                           device=q.device)
    lse = torch.empty((nsplit, B, H), dtype=torch.float32, device=q.device)
    qscale = float(_qscale(scale, clamped, torch.bfloat16))
    p = _build.ptr
    rc = _build.lib().fatt_decode_bhsd(
        p(q), p(k), p(v), p(k_scale), p(v_scale), p(kv_length), p(out),
        p(part), p(lse), B, H, Hk, S, D, _KV_TYPES[k.dtype], nsplit,
        split_len, qscale, int(clamped), float(clamp2), _build.stream())
    _build.check(rc, "fatt_decode_bhsd")
    flash_decode_cuda.launches += 1
    return (out if nsplit == 1 else part), lse


flash_decode_cuda.launches = 0


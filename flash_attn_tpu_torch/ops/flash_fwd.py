"""FlashAttention-2 forward (kernel K4, ``csrc/flash_fwd.cu``).

Port of flash_attn_tpu/ops/flash_fwd.py:flash_fwd for the subset the
Llama prefill uses: BSHD layout, GQA, bottom-right causal mask, q-side
RoPE inside the kernel, softmax_mode "clamped" or "online", fp32 LSE.
Bias, segment ids, positions, windows, softcap, ALiBi, dropout and
return_softmax are still to port and raise ``NotImplementedError``.

As on the TPU, the softmax scale and log2(e) are folded into q (rounded
to the input dtype), q is rotated in fp32 and rounded again before QK^T,
scores are base-2, and p is rounded to the V dtype before PV.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch import _build
from flash_attn_tpu_torch.ops.rope import rope_rotate

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# Clamped-softmax score ceiling, base-2 units (flash_fwd.py:42).
CLAMP2 = 80.0


def flash_fwd(q, k, v, *, causal: bool = False, scale: float | None = None,
              rope_cos=None, rope_sin=None, softmax_mode: str = "online",
              **unported):
    """q: [B, Sq, H, D]; k, v: [B, Sk, Hk, D].  Returns (out [B, Sq, H, D]
    in q.dtype, lse [B, H, Sq] fp32).

    rope_cos/rope_sin ([B, Sq, D/2] or [Sq, D/2] fp32): rotate the
    un-rotated q inside the kernel (K must come rotated)."""
    for name, val in unported.items():
        if val is None or val is False or (isinstance(val, float) and val == 0.0):
            continue
        raise NotImplementedError(f"flash_fwd option {name!r} is not ported yet")
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
    if scale is None:
        scale = D ** -0.5
    clamped = softmax_mode == "clamped"
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, causal, scale, rope_cos, rope_sin, clamped)
    return flash_fwd_plain(q, k, v, causal, scale, rope_cos, rope_sin, clamped)


def flash_fwd_plain(q, k, v, causal, scale, rope_cos, rope_sin, clamped):
    """Plain PyTorch version of K4 (whole rows at once, same roundings)."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    qs = (q.float() * (scale * LOG2E)).to(q.dtype)
    if rope_cos is not None:
        qs = rope_rotate(qs, rope_cos.float(), rope_sin.float())
    kf = k.float().repeat_interleave(H // Hk, dim=2)
    vf = v.repeat_interleave(H // Hk, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qs.float(), kf)
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        cols = torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    if clamped:
        p = torch.exp2(torch.clamp(s, max=CLAMP2))
        m = None
    else:
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
    l = p.sum(dim=-1)  # [B, H, Sq]
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


def flash_fwd_cuda(q, k, v, causal, scale, rope_cos, rope_sin, clamped):
    """Launch K4.  Replaces flash_attn_tpu/ops/flash_fwd.py:_fwd_kernel;
    bound by operations (see the source note in csrc/flash_fwd.cu)."""
    B, Sq, H, D = q.shape
    Sk, Hk = k.shape[1], k.shape[2]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise ValueError("K4 takes bf16 q, k, v")
    if D != 128:
        raise ValueError(f"K4 takes head_dim 128 (Llama-3), got {D}")
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
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    p = _build.ptr
    rc = _build.lib().fatt_flash_fwd(
        p(q), p(k), p(v), p(rope_cos), p(rope_sin), p(out), p(lse),
        B, Sq, Sk, H, Hk, D, bstride, float(scale * LOG2E), int(causal),
        int(clamped), _build.stream())
    _build.check(rc, "fatt_flash_fwd")
    flash_fwd_cuda.launches += 1
    return out, lse


flash_fwd_cuda.launches = 0

"""Naive attention oracle: the port's own correctness spec.

Port of flash_attn_tpu/ops/reference.py:mha_reference for the options
this slice needs (causal bottom-right, GQA, scale, LSE).
"""

from __future__ import annotations

import torch


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, scale: float | None = None,
                  return_lse: bool = False):
    """Softmax-GEMM-GEMM attention in fp32.

    q: [B, Sq, H, D]; k, v: [B, Sk, Hk, D] with H % Hk == 0 (GQA).
    causal: bottom-right aligned (row i sees col j iff j <= i + Sk - Sq).
    Returns out [B, Sq, H, D] in q.dtype, and with return_lse also
    lse [B, H, Sq] fp32.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q/k/v must be rank-4 BSHD, got {q.shape}/{k.shape}/{v.shape}")
    _, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if h % hk:
        raise ValueError(f"num_heads {h} not divisible by num_heads_k {hk}")
    if scale is None:
        scale = d ** -0.5
    kf = k.float().repeat_interleave(h // hk, dim=2)
    vf = v.float().repeat_interleave(h // hk, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        cols = torch.arange(sk, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)  # [B, H, Sq]
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)
    if return_lse:
        return out, lse
    return out

"""LSE-merge algebra: combines partial attentions over disjoint KV sets.

Port of flash_attn_tpu/ops/lse.py:lse_merge.

    lse = logsumexp_i(lse_i)
    out = sum_i exp(lse_i - lse) * out_i

Fully-masked partials (lse = -inf, or the kernels' finite -1e30) weigh 0.
"""

from __future__ import annotations

import torch


def lse_merge(outs: torch.Tensor, lses: torch.Tensor, dim: int = 0):
    """Merge partial results stacked along ``dim``.

    outs: [..., D] stack of partial outputs (accumulated in fp32);
    lses: matching stack of LSE values (outs.shape minus the last axis).
    Returns (out in outs.dtype, lse fp32) with the stack axis reduced.
    """
    out_dtype = outs.dtype
    outs = outs.float()
    lses = lses.float()
    lse = torch.logsumexp(lses, dim=dim)
    safe_lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    w = torch.exp(lses - safe_lse.unsqueeze(dim))
    w = torch.where(torch.isfinite(lses), w, torch.zeros_like(w))
    out = (outs * w[..., None]).sum(dim=dim)
    return out.to(out_dtype), lse

"""LSE-merge algebra: combines partial attentions over disjoint KV sets.

Port of flash_attn_tpu/ops/lse.py:lse_merge (``lse_merge``, the plain
version) and lse_merge2 (``lse_merge2``, the ring's pairwise merge), and
the split-KV combine kernel K1m (``csrc/lse_merge.cu``,
``lse_merge_cuda``) that merges the decode kernels' partials on the card.

    lse = logsumexp_i(lse_i)
    out = sum_i exp(lse_i - lse) * out_i

Fully-masked partials (lse = -inf, or the kernels' finite -1e30) weigh 0.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch import _build

# an LSE at or below this is a dead partial: -inf, or the kernels' -1e30
DEAD_LSE = -1e30 / 2


def lse_merge(outs: torch.Tensor, lses: torch.Tensor, axis: int = 0):
    """Merge partial results stacked along ``axis`` (JAX's keyword).

    outs: [..., D] stack of partial outputs (accumulated in fp32);
    lses: matching stack of LSE values (outs.shape minus the last axis).
    Returns (out in outs.dtype, lse fp32) with the stack axis reduced.
    """
    out_dtype = outs.dtype
    outs = outs.float()
    lses = lses.float()
    lse = torch.logsumexp(lses, dim=axis)
    safe_lse = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    w = torch.exp(lses - safe_lse.unsqueeze(axis))
    w = torch.where(torch.isfinite(lses), w, torch.zeros_like(w))
    out = (outs * w[..., None]).sum(dim=axis)
    return out.to(out_dtype), lse


def lse_merge2(out1, lse1, out2, lse2):
    """Pairwise merge, the form the ring's steps use (port of
    flash_attn_tpu/ops/lse.py:lse_merge2; plain torch, as JAX leaves it
    to XLA).  out*: [..., D]; lse*: out.shape[:-1].  Returns (out, lse)
    in fp32.  A partial whose lse is -inf (JAX's dead rows, a ring's
    skipped step) or at most -1e30 / 2 (the port kernels' dead rows)
    weighs 0; where both are dead the result is out 0, lse -inf."""
    out1, out2, lse1, lse2 = (x.float() for x in (out1, out2, lse1, lse2))
    live1, live2 = lse1 > DEAD_LSE, lse2 > DEAD_LSE
    zero = torch.zeros((), device=lse1.device)
    dead = torch.full((), float("-inf"), device=lse1.device)
    m = torch.maximum(torch.where(live1, lse1, dead), torch.where(live2, lse2, dead))
    m = torch.where(live1 | live2, m, zero)
    e1 = torch.where(live1, torch.exp(lse1 - m), zero)
    e2 = torch.where(live2, torch.exp(lse2 - m), zero)
    s = e1 + e2
    lse = torch.where(s > 0.0, m + torch.log(torch.clamp(s, min=1e-37)), dead)
    denom = torch.clamp(s, min=1e-37)[..., None]
    out = (out1 * e1[..., None] + out2 * e2[..., None]) / denom
    return out, lse


def lse_merge_cuda(outs: torch.Tensor, lses: torch.Tensor, dtype):
    """Launch K1m: merge partials stacked on dim 0 (outs [n, ..., D] fp32,
    lses [n, ...] fp32) into (out [..., D] in ``dtype``, bf16 or fp32;
    lse [...] fp32), as ``lse_merge`` does.  Replaces the eager merge of
    ops/lse.py, which the JAX package leaves to XLA; bound by bytes (see
    the source note in csrc/lse_merge.cu)."""
    if outs.dtype != torch.float32 or lses.dtype != torch.float32:
        raise ValueError("K1m takes fp32 partials and LSEs")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K1m writes bf16 or fp32, got {dtype}")
    n, D = outs.shape[0], outs.shape[-1]
    if lses.shape != outs.shape[:-1] or D % 4:
        raise ValueError(f"K1m needs lses {list(outs.shape[:-1])} and D % 4 == 0, "
                         f"got {list(lses.shape)} and D={D}")
    for t in (outs, lses):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("K1m takes contiguous CUDA tensors")
    rows = lses[0].numel()
    out = torch.empty(outs.shape[1:], dtype=dtype, device=outs.device)
    lse = torch.empty(lses.shape[1:], dtype=torch.float32, device=outs.device)
    p = _build.ptr
    rc = _build.lib().fatt_lse_merge(p(outs), p(lses), p(out), p(lse), n, rows, D,
                                     int(dtype == torch.float32), _build.stream())
    _build.check(rc, "fatt_lse_merge")
    lse_merge_cuda.launches += 1
    return out, lse


lse_merge_cuda.launches = 0

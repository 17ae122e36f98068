"""Naive attention oracle: the port's own correctness spec.

Port of flash_attn_tpu/ops/reference.py: ``attention_bias``,
``mha_reference`` with every option (an additive mask, segment ids, the
window, the softcap, ALiBi, dropout, ``return_lse``, ``return_softmax``)
and ``mha_reference_vjp``, straight-line PyTorch in fp32.  Dropout draws
its keep mask from a ``torch.Generator`` in place of JAX's PRNG key: the
same rate and scaling, other bits.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def _broadcast_kv_heads(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """GQA/MQA: repeat KV heads across query-head groups."""
    num_heads_k = k.shape[2]
    if num_heads_k == num_heads:
        return k
    if num_heads % num_heads_k != 0:
        raise ValueError(f"num_heads ({num_heads}) must be a multiple of num_heads_k "
                         f"({num_heads_k})")
    return k.repeat_interleave(num_heads // num_heads_k, dim=2)


def attention_bias(*, seqlen_q: int, seqlen_k: int, causal: bool = False, mask=None,
                   q_segment_ids=None, kv_segment_ids=None, window=None,
                   dtype=torch.float32, device=None):
    """Every masking mechanism as one additive bias that broadcasts to
    [B, H, Sq, Sk] (0 live, -inf dead, plus ``mask``); None for no masking.
    ``device``: where the causal/window part is made when neither the mask
    nor the segment ids say (default the CPU)."""
    if device is None:
        device = next((x.device for x in (mask, q_segment_ids) if x is not None), "cpu")
    bias = None

    def add(b):
        nonlocal bias
        bias = b if bias is None else bias + b

    if causal or window is not None:
        qi = torch.arange(seqlen_q, device=device)[:, None]
        kj = torch.arange(seqlen_k, device=device)[None, :]
        # bottom-right alignment: q row i may see k cols j <= i + (Sk - Sq)
        shift = seqlen_k - seqlen_q
        allowed = torch.ones((seqlen_q, seqlen_k), dtype=torch.bool, device=device)
        if causal:
            allowed &= kj <= qi + shift
        if window is not None:
            left, right = window
            if left >= 0:
                allowed &= kj >= qi + shift - left
            if right >= 0:
                allowed &= kj <= qi + shift + right
        add(_dead(allowed, dtype)[None, None])
    if q_segment_ids is not None:
        if kv_segment_ids is None:
            raise ValueError("q_segment_ids given without kv_segment_ids")
        same = q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :]
        add(_dead(same, dtype))
    if mask is not None:
        add(mask.to(dtype))
    return bias


def _dead(allowed, dtype):
    """0 where ``allowed``, -inf elsewhere."""
    zero = torch.zeros((), dtype=dtype, device=allowed.device)
    return torch.where(allowed, zero, torch.full((), NEG_INF, dtype=dtype,
                                                 device=allowed.device))


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
                  mask=None, q_segment_ids=None, kv_segment_ids=None, window=None,
                  scale: float | None = None, dropout_rate: float = 0.0, dropout_rng=None,
                  logit_softcap: float | None = None, alibi_slopes=None,
                  return_lse: bool = False, return_softmax: bool = False):
    """Softmax-GEMM-GEMM attention in fp32.

    q: [B, Sq, H, D]; k, v: [B, Sk, Hk, D] with H % Hk == 0 (GQA).
    causal: bottom-right aligned (row i sees col j iff j <= i + Sk - Sq).
    mask: an additive bias that broadcasts to [B, H, Sq, Sk].
    q_segment_ids / kv_segment_ids ([B, Sq] / [B, Sk]): attention only
    within equal ids.  window (left, right; -1 open).  logit_softcap: cap *
    tanh(s / cap) on the scaled scores, before the bias and the masks.
    alibi_slopes ([H]): -slope_h * |i + Sk - Sq - j| after the softcap.
    dropout_rate with ``dropout_rng`` (a ``torch.Generator`` on q's
    device): keep each probability with 1 - rate and scale it by 1 / (1 -
    rate); the mask's bits are not JAX's.  Returns out [B, Sq, H, D] in
    q.dtype, then with ``return_lse`` lse [B, H, Sq] fp32 (-inf for a row
    with no live key), then with ``return_softmax`` the post-dropout
    probabilities [B, H, Sq, Sk], as a tuple in that order.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"q/k/v must be rank-4 BSHD, got {q.shape}/{k.shape}/{v.shape}")
    _, seqlen_q, num_heads, head_dim = q.shape
    seqlen_k = k.shape[1]
    if scale is None:
        scale = head_dim ** -0.5
    k = _broadcast_kv_heads(k, num_heads)
    v = _broadcast_kv_heads(v, num_heads)
    qf, kf, vf = q.float(), k.float(), v.float()

    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if logit_softcap is not None:
        scores = logit_softcap * torch.tanh(scores / logit_softcap)
    if alibi_slopes is not None:
        i = torch.arange(seqlen_q, device=q.device)[:, None] + (seqlen_k - seqlen_q)
        j = torch.arange(seqlen_k, device=q.device)[None, :]
        sl = torch.as_tensor(alibi_slopes, dtype=torch.float32, device=q.device)
        scores = scores - sl[None, :, None, None] * (i - j).abs().float()[None, None]
    bias = attention_bias(seqlen_q=seqlen_q, seqlen_k=seqlen_k, causal=causal, mask=mask,
                          q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                          window=window, device=q.device)
    if bias is not None:
        scores = scores + bias

    row_max = scores.amax(dim=-1, keepdim=True)
    # rows with no live key: probabilities 0, lse -inf
    safe_max = torch.where(torch.isfinite(row_max), row_max, torch.zeros_like(row_max))
    unnorm = torch.exp(scores - safe_max)
    unnorm = torch.where(torch.isfinite(scores), unnorm, torch.zeros_like(unnorm))
    denom = unnorm.sum(dim=-1, keepdim=True)
    lse = torch.where(denom[..., 0] > 0.0,
                      safe_max[..., 0] + torch.log(torch.clamp(denom[..., 0], min=1e-37)),
                      torch.full_like(denom[..., 0], NEG_INF))
    probs = torch.where(denom > 0.0, unnorm / torch.clamp(denom, min=1e-37),
                        torch.zeros_like(unnorm))
    if dropout_rate > 0.0:
        if dropout_rng is None:
            raise ValueError("dropout_rate > 0 requires dropout_rng")
        keep = torch.rand(probs.shape, generator=dropout_rng, device=probs.device) < (
            1.0 - dropout_rate)
        probs = torch.where(keep, probs / (1.0 - dropout_rate), torch.zeros_like(probs))

    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(q.dtype)
    results = (out,)
    if return_lse:
        results += (lse,)
    if return_softmax:
        results += (probs,)
    return results if len(results) > 1 else out


def mha_reference_vjp(q, k, v, dout, *, causal=False, mask=None, q_segment_ids=None,
                      kv_segment_ids=None, window=None, scale=None):
    """(dq, dk, dv) of the oracle by ``torch.autograd.grad`` of
    sum(out * dout): the oracle for the backward kernels, without
    dropout."""
    q_, k_, v_ = (x.detach().requires_grad_(True) for x in (q, k, v))
    with torch.enable_grad():
        out = mha_reference(q_, k_, v_, causal=causal, mask=mask, q_segment_ids=q_segment_ids,
                            kv_segment_ids=kv_segment_ids, window=window, scale=scale)
        loss = (out.float() * dout.float()).sum()
        return torch.autograd.grad(loss, (q_, k_, v_))

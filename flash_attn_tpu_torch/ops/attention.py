"""FlashAttention entry points: dense (differentiable) and varlen.

Port of flash_attn_tpu/ops/attention.py:flash_attention,
flash_attention_varlen and varlen_segments: the forward is ``flash_fwd``
(K4 on the card) and, where autograd needs it, the backward is
``flash_bwd`` (K9 + K10), joined by a ``torch.autograd.Function`` in
place of the ``jax.custom_vjp``.  A sliding window and the logit softcap
go through both (Gemma-2's training path); segment ids and positions are
forward-only (K9/K10 take neither yet) and raise ``NotImplementedError``
when autograd would need a gradient; so do the options that
ops/flash_fwd.py and ops/flash_bwd.py do not port yet.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.ops.flash_bwd import flash_bwd
from flash_attn_tpu_torch.ops.flash_fwd import flash_fwd
from flash_attn_tpu_torch.ops.varlen import (
    cu_seqlens_to_segment_ids,
    segment_ids_to_positions,
)


class _FlashAttention(torch.autograd.Function):
    """Residuals as the reference saves them (q, k, v, out, lse and the
    rope tables), through ``save_for_backward`` so that a checkpointed
    block that reruns the forward gets them again; the window and the
    softcap go to both passes."""

    @staticmethod
    def forward(ctx, q, k, v, rope_cos, rope_sin, causal, scale, window, logit_softcap,
                softmax_mode, unported):
        out, lse = flash_fwd(q, k, v, causal=causal, scale=scale, rope_cos=rope_cos,
                             rope_sin=rope_sin, window=window, logit_softcap=logit_softcap,
                             softmax_mode=softmax_mode, **unported)
        ctx.save_for_backward(q, k, v, out, lse, rope_cos, rope_sin)
        ctx.causal, ctx.scale = causal, scale
        ctx.window, ctx.logit_softcap = window, logit_softcap
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, rope_cos, rope_sin = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
                               scale=ctx.scale, rope_cos=rope_cos, rope_sin=rope_sin,
                               window=ctx.window, logit_softcap=ctx.logit_softcap)
        # the rope tables are constants: no gradient (JAX returns zeros);
        # the other arguments are options
        return dq, dk, dv, None, None, None, None, None, None, None, None


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal: bool = False, mask=None,
                    q_segment_ids=None, kv_segment_ids=None,
                    q_positions=None, kv_positions=None,
                    scale: float | None = None, dropout_rate: float = 0.0,
                    window=None, rope_cos=None, rope_sin=None,
                    logit_softcap=None, alibi_slopes=None,
                    return_lse: bool = False, return_softmax: bool = False,
                    softmax_mode: str | None = None):
    """FlashAttention-2.  q: [B, Sq, H, D]; k, v: [B, Sk, Hk, D].

    softmax_mode: "online" (default) or "clamped" (no running max; exact
    for natural-units logits in (-87, 55], the Llama prefill's choice).
    rope_cos/rope_sin ([B, Sq, D/2] fp32): rotate q inside the kernel.
    q_segment_ids/kv_segment_ids ([B, Sq] / [B, Sk]): attention only
    within equal ids; q_positions/kv_positions: a key is live only where
    kv_pos <= q_pos; these two are forward-only.  window (left, right;
    -1 open): the sliding window, bottom-right aligned; logit_softcap:
    Gemma-2's cap * tanh(s / cap) on the scaled scores.
    Returns out [B, Sq, H, D], differentiable w.r.t. q, k and v when no
    segment ids or positions are given; with ``return_lse`` (out, lse
    [B, H, Sq]) from the forward alone, as in the reference.  Forward-only
    calls raise when autograd would need a gradient of q, k or v.
    """
    unported = dict(bias=mask, dropout_rate=dropout_rate, alibi_slopes=alibi_slopes,
                    return_softmax=return_softmax)
    fwd_only = dict(q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                    q_positions=q_positions, kv_positions=kv_positions)
    given = [name for name, x in fwd_only.items() if x is not None]
    mode = softmax_mode or "online"
    if not return_lse and not given:
        return _FlashAttention.apply(q, k, v, rope_cos, rope_sin, causal, scale, window,
                                     logit_softcap, mode, unported)
    if _needs_grad(q, k, v):
        what = (f"{', '.join(given)} are forward-only (K9/K10 take none yet)"
                if given else "return_lse is forward-only")
        raise NotImplementedError(f"flash_attention: {what}; call it under torch.no_grad()")
    out, lse = flash_fwd(q, k, v, causal=causal, scale=scale, rope_cos=rope_cos,
                         rope_sin=rope_sin, window=window, logit_softcap=logit_softcap,
                         softmax_mode=mode, **fwd_only, **unported)
    return (out, lse) if return_lse else out


def flash_attention_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k, *, causal: bool = False,
                           mask=None, scale: float | None = None,
                           dropout_rate: float = 0.0, return_lse: bool = False,
                           return_softmax: bool = False, softmax_mode: str | None = None):
    """Varlen (packed ragged batch) attention, forward only.

    q: [total_q, H, D]; k, v: [total_k, Hk, D]; cu_seqlens_*: [b+1] int32
    prefix sums.  Converted at this edge to segment ids over a singleton
    batch; with ``causal`` each sequence is causal within itself
    (bottom-right aligned per pair of sequences, through positions).
    ``mask`` and ``return_softmax`` are still to port and raise.  Returns
    out [total_q, H, D], or (out, lse [H, total_q]) with ``return_lse``."""
    if q.ndim != 3:
        raise ValueError(f"varlen q must be [total_q, H, D], got {tuple(q.shape)}")
    for name, val in (("mask", mask), ("return_softmax", return_softmax)):
        if val is not None and val is not False:
            raise NotImplementedError(f"flash_attention_varlen option {name!r} is not ported yet")
    qseg, kseg, qpos, kpos, causal = varlen_segments(
        cu_seqlens_q, cu_seqlens_k, q.shape[0], k.shape[0], causal)
    out = flash_attention(q[None], k[None], v[None], causal=causal,
                          q_segment_ids=qseg, kv_segment_ids=kseg,
                          q_positions=qpos, kv_positions=kpos, scale=scale,
                          dropout_rate=dropout_rate, return_lse=return_lse,
                          softmax_mode=softmax_mode)
    if return_lse:
        return out[0][0], out[1][0]
    return out[0]


def varlen_segments(cu_seqlens_q, cu_seqlens_k, total_q: int, total_k: int, causal: bool):
    """cu_seqlens -> the kernel's masks ``(q_segment_ids, kv_segment_ids,
    q_positions, kv_positions, causal)``, each [1, total] or None.

    Per-sequence causality on a packed batch: the global bottom-right
    alignment is wrong, so each sequence pair's alignment goes into
    positions compared in the kernel (kv_pos <= q_pos), and the returned
    ``causal`` is False."""
    qseg = cu_seqlens_to_segment_ids(cu_seqlens_q, total_q)[None]
    kseg = cu_seqlens_to_segment_ids(cu_seqlens_k, total_k)[None]
    qpos = kpos = None
    if causal:
        # each query's own q- and k-sequence lengths, for the bottom-right
        # shift within its sequence pair
        qlen = _segment_lengths(cu_seqlens_q, qseg[0])
        klen_for_q = _segment_lengths(cu_seqlens_k, qseg[0])
        qpos = (segment_ids_to_positions(qseg[0]) + (klen_for_q - qlen))[None]
        kpos = segment_ids_to_positions(kseg[0])[None]
        causal = False
    return qseg, kseg, qpos, kpos, causal


def _segment_lengths(cu_seqlens, segment_ids):
    """Each token's own segment's length (id 0, padding: length 0)."""
    lens = torch.diff(cu_seqlens.to(torch.int32))
    lens = torch.cat([torch.zeros((1,), dtype=torch.int32, device=lens.device), lens])
    return lens[torch.clamp(segment_ids.long(), 0, lens.shape[0] - 1)]

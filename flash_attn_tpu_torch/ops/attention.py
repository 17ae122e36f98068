"""FlashAttention entry point, differentiable.

Port of flash_attn_tpu/ops/attention.py:flash_attention: the forward is
``flash_fwd`` (K4 on the card) and, where autograd needs it, the
backward is ``flash_bwd`` (K9 + K10), joined by a
``torch.autograd.Function`` in place of the ``jax.custom_vjp``.  The
options that ops/flash_fwd.py and ops/flash_bwd.py do not port yet raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.ops.flash_bwd import flash_bwd
from flash_attn_tpu_torch.ops.flash_fwd import flash_fwd


class _FlashAttention(torch.autograd.Function):
    """Residuals as the reference saves them (q, k, v, out, lse and the
    rope tables), through ``save_for_backward`` so that a checkpointed
    block that reruns the forward gets them again."""

    @staticmethod
    def forward(ctx, q, k, v, rope_cos, rope_sin, causal, scale, softmax_mode, unported):
        out, lse = flash_fwd(q, k, v, causal=causal, scale=scale, rope_cos=rope_cos,
                             rope_sin=rope_sin, softmax_mode=softmax_mode, **unported)
        ctx.save_for_backward(q, k, v, out, lse, rope_cos, rope_sin)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, rope_cos, rope_sin = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout.contiguous(), causal=ctx.causal,
                               scale=ctx.scale, rope_cos=rope_cos, rope_sin=rope_sin)
        # the rope tables are constants: no gradient (JAX returns zeros)
        return dq, dk, dv, None, None, None, None, None, None


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
    Returns out [B, Sq, H, D], differentiable w.r.t. q, k and v; with
    ``return_lse`` (out, lse [B, H, Sq]) from the forward alone, as in
    the reference: it raises when autograd would need a gradient of q, k
    or v.
    """
    unported = dict(bias=mask, q_segment_ids=q_segment_ids,
                    kv_segment_ids=kv_segment_ids, q_positions=q_positions,
                    kv_positions=kv_positions, dropout_rate=dropout_rate, window=window,
                    logit_softcap=logit_softcap, alibi_slopes=alibi_slopes,
                    return_softmax=return_softmax)
    mode = softmax_mode or "online"
    if not return_lse:
        return _FlashAttention.apply(q, k, v, rope_cos, rope_sin, causal, scale, mode,
                                     unported)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError("flash_attention: return_lse is forward-only; "
                                  "call it under torch.no_grad()")
    return flash_fwd(q, k, v, causal=causal, scale=scale, rope_cos=rope_cos,
                     rope_sin=rope_sin, softmax_mode=mode, **unported)

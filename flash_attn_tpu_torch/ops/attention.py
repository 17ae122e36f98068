"""FlashAttention entry point (forward only).

Port of flash_attn_tpu/ops/attention.py:flash_attention without the
backward pass; the options that ops/flash_fwd.py does not port yet raise
``NotImplementedError``.
"""

from __future__ import annotations

from flash_attn_tpu_torch.ops.flash_fwd import flash_fwd


def flash_attention(q, k, v, *, causal: bool = False, mask=None,
                    q_segment_ids=None, kv_segment_ids=None,
                    q_positions=None, kv_positions=None,
                    scale: float | None = None, dropout_rate: float = 0.0,
                    window=None, rope_cos=None, rope_sin=None,
                    logit_softcap=None, alibi_slopes=None,
                    return_lse: bool = False, return_softmax: bool = False,
                    softmax_mode: str | None = None):
    """FlashAttention-2 forward.  q: [B, Sq, H, D]; k, v: [B, Sk, Hk, D].

    softmax_mode: "online" (default) or "clamped" (no running max; exact
    for natural-units logits in (-87, 55], the Llama prefill's choice).
    rope_cos/rope_sin ([B, Sq, D/2] fp32): rotate q inside the kernel.
    Returns out [B, Sq, H, D] (and lse [B, H, Sq] with return_lse).
    """
    out, lse = flash_fwd(
        q, k, v, causal=causal, scale=scale, rope_cos=rope_cos,
        rope_sin=rope_sin, softmax_mode=softmax_mode or "online",
        bias=mask, q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids, q_positions=q_positions,
        kv_positions=kv_positions, dropout_rate=dropout_rate, window=window,
        logit_softcap=logit_softcap, alibi_slopes=alibi_slopes,
        return_softmax=return_softmax,
    )
    if return_lse:
        return out, lse
    return out

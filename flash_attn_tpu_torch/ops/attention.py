"""FlashAttention entry points: dense and varlen, both differentiable.

Port of flash_attn_tpu/ops/attention.py:flash_attention,
flash_attention_varlen and varlen_segments: the forward is ``flash_fwd``
(K4 on the card) and, where autograd needs it, the backward is
``flash_bwd`` (K9 + K10), joined by a ``torch.autograd.Function`` in
place of the ``jax.custom_vjp``.  Every option the two take goes through
both: the additive mask (with its gradient, dbias, when it requires
grad), ALiBi, dropout (the backward replays the forward's mask from the
saved seed), segment ids and positions, a sliding window and the logit
softcap.  ``return_softmax`` and ``return_lse`` are forward-only.
"""

from __future__ import annotations

import dataclasses

import torch

from flash_attn_tpu_torch.ops.flash_bwd import flash_bwd
from flash_attn_tpu_torch.ops.flash_fwd import FlashConfig, alibi_arg, flash_fwd, seed32
from flash_attn_tpu_torch.ops.varlen import (
    cu_seqlens_to_segment_ids,
    segment_ids_to_positions,
)


def _fwd_config(config, softmax_mode):
    """``softmax_mode`` over the (explicit or default) forward config, as
    JAX's ``_fwd_config`` (attention.py:26-43); "clamped_verify" is the
    kernel-internal half of "auto" and raises here."""
    if softmax_mode is not None:
        config = dataclasses.replace(config or FlashConfig(), softmax_mode=softmax_mode)
    if config is not None and config.softmax_mode == "clamped_verify":
        raise ValueError("use softmax_mode='auto' (clamped_verify is the kernel-internal half "
                         "of it)")
    return config


class _FlashAttention(torch.autograd.Function):
    """Residuals as the reference saves them (q, k, v, out, lse, the rope
    tables, the mask and the slopes), through ``save_for_backward`` so
    that a checkpointed block that reruns the forward gets them again; the
    options (the segment ids and positions, the dropout's rate and seed,
    the window and the softcap) go to both passes.  The mask gets its
    gradient when it requires one; the slopes get zeros, as JAX gives
    them."""

    @staticmethod
    def forward(ctx, q, k, v, mask, alibi, rope_cos, rope_sin, causal, scale, config, opts):
        out, lse = flash_fwd(q, k, v, bias=mask, alibi_slopes=alibi, causal=causal,
                             scale=scale, rope_cos=rope_cos, rope_sin=rope_sin, config=config,
                             **opts)
        ctx.save_for_backward(q, k, v, out, lse, rope_cos, rope_sin, mask, alibi)
        ctx.causal, ctx.scale, ctx.opts = causal, scale, opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, rope_cos, rope_sin, mask, alibi = ctx.saved_tensors
        want_dbias = mask is not None and ctx.needs_input_grad[3]
        grads = flash_bwd(q, k, v, out, lse, dout.contiguous(), bias=mask, alibi_slopes=alibi,
                          want_dbias=want_dbias, causal=ctx.causal, scale=ctx.scale,
                          rope_cos=rope_cos, rope_sin=rope_sin, **ctx.opts)
        dmask = grads[3] if want_dbias else None
        dalibi = torch.zeros_like(alibi) if ctx.needs_input_grad[4] else None
        # the rope tables are constants: no gradient (JAX returns zeros);
        # the other arguments are options
        return (*grads[:3], dmask, dalibi, None, None, None, None, None, None)


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal: bool = False, mask=None,
                    q_segment_ids=None, kv_segment_ids=None,
                    q_positions=None, kv_positions=None,
                    scale: float | None = None, dropout_rate: float = 0.0,
                    dropout_seed=0, window=None, rope_cos=None, rope_sin=None,
                    logit_softcap=None, alibi_slopes=None,
                    return_lse: bool = False, return_softmax: bool = False,
                    config: FlashConfig | None = None, softmax_mode: str | None = None):
    """FlashAttention-2.  q: [B, Sq, H, D]; k, v: [B, Sk, Hk, D].

    mask: an additive bias that broadcasts to [B, H, Sq, Sk]; a mask that
    requires grad gets its gradient (summed over its broadcast axes).
    dropout_rate / dropout_seed (an int32): reproducible dropout, the
    backward replaying the forward's mask.  softmax_mode: over the config's
    (``FlashConfig``, default "online"): "clamped" (no running max; exact
    for natural-units logits in (-87, 55], the Llama prefill's choice) or
    "auto" (clamped, rerun online when a row left that window; one host
    synchronisation a call).  rope_cos/rope_sin ([B, Sq, D/2] fp32): rotate
    q inside the kernel.  q_segment_ids/kv_segment_ids ([B, Sq] / [B,
    Sk]): attention only within equal ids; q_positions/kv_positions: a key
    is live only where kv_pos <= q_pos.  window (left, right; -1 open):
    the sliding window, bottom-right aligned; logit_softcap: Gemma-2's cap
    * tanh(s / cap) on the scaled scores.  alibi_slopes ([H] fp32):
    -slope_h * |i + Sk - Sq - j| on the scores (``ops/alibi``), constants.
    Returns out [B, Sq, H, D], differentiable w.r.t. q, k, v and the mask;
    with ``return_lse`` (out, lse [B, H, Sq]) and with ``return_softmax``
    (out, lse, probs [B, H, Sq, Sk]) from the forward alone, as in the
    reference, which raise when autograd would need a gradient.
    """
    config = _fwd_config(config, softmax_mode)
    opts = dict(q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids,
                q_positions=q_positions, kv_positions=kv_positions,
                dropout_rate=float(dropout_rate), dropout_seed=seed32(dropout_seed),
                window=window, logit_softcap=logit_softcap)
    if return_lse or return_softmax:
        if _needs_grad(q, k, v, mask):
            what = "return_softmax" if return_softmax else "return_lse"
            raise NotImplementedError(f"flash_attention: {what} is forward-only; call it under "
                                      "torch.no_grad()")
        return flash_fwd(q, k, v, bias=mask, causal=causal, scale=scale, rope_cos=rope_cos,
                         rope_sin=rope_sin, alibi_slopes=alibi_slopes, config=config,
                         return_softmax=return_softmax, **opts)
    alibi = alibi_slopes
    if not (isinstance(alibi, torch.Tensor) and alibi.requires_grad):
        alibi = alibi_arg(alibi_slopes, q.shape[2], q.device)
    return _FlashAttention.apply(q, k, v, mask, alibi, rope_cos, rope_sin, causal, scale, config,
                                 opts)


def flash_attention_varlen(q, k, v, cu_seqlens_q, cu_seqlens_k, *, causal: bool = False,
                           mask=None, scale: float | None = None,
                           dropout_rate: float = 0.0, dropout_seed=0,
                           return_lse: bool = False, return_softmax: bool = False,
                           config: FlashConfig | None = None,
                           softmax_mode: str | None = None):
    """Varlen (packed ragged batch) attention, differentiable w.r.t. q, k,
    v and the mask.

    q: [total_q, H, D]; k, v: [total_k, Hk, D]; cu_seqlens_*: [b+1] int32
    prefix sums.  Converted at this edge to segment ids over a singleton
    batch; with ``causal`` each sequence is causal within itself
    (bottom-right aligned per pair of sequences, through positions).
    ``mask``: an additive bias over the packed axes, [total_q, total_k] or
    [H, total_q, total_k]; cross-sequence entries stay dead whatever its
    value.  Returns out [total_q, H, D], or (out, lse [H, total_q]) with
    ``return_lse``, or (out, lse, probs [H, total_q, total_k]) with
    ``return_softmax``."""
    if q.ndim != 3:
        raise ValueError(f"varlen q must be [total_q, H, D], got {tuple(q.shape)}")
    qseg, kseg, qpos, kpos, causal = varlen_segments(
        cu_seqlens_q, cu_seqlens_k, q.shape[0], k.shape[0], causal)
    if mask is not None:
        if mask.ndim not in (2, 3):
            raise ValueError("varlen mask must be [total_q, total_k] or "
                             f"[H, total_q, total_k], got {tuple(mask.shape)}")
        mask = mask[None, None] if mask.ndim == 2 else mask[None]
    out = flash_attention(q[None], k[None], v[None], causal=causal, mask=mask,
                          q_segment_ids=qseg, kv_segment_ids=kseg,
                          q_positions=qpos, kv_positions=kpos, scale=scale,
                          dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                          return_lse=return_lse, return_softmax=return_softmax,
                          config=config, softmax_mode=softmax_mode)
    if return_softmax:
        return out[0][0], out[1][0], out[2][0]
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

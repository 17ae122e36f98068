"""Ulysses sequence parallelism: all-to-all head <-> sequence reshards.

Port of flash_attn_tpu/parallel/ulysses.py in the mesh's single-process
form.  Tokens arrive split over the ranks along the sequence; one
all-to-all regroups them so that each rank holds the whole sequence for
H / n of the heads; each rank runs the port's differentiable
``flash_attention`` (K4 forward, K9 + K10 backward on the card); a second
all-to-all restores the sequence split.  With fewer KV heads than ranks
the KV heads are repeated first, so that each rank gets one (exact: GQA
repeats them anyway).  Dropout seeds are offset by the rank, since the
kernels key their masks by the local head index.  Options as
``flash_attention`` takes them, refused where it refuses (on rank 0's
call, before any launch); the bias is split over its head axis, the
layout after the all-to-all.  Gradients flow through the reshards by
autograd.
"""

from __future__ import annotations

from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.ops.flash_fwd import seed32, seed_add
from flash_attn_tpu_torch.parallel.mesh import SEQUENCE_AXIS, all_to_all, shard, unshard


def ulysses_attention(q, k, v, *, mesh, axis_name: str = SEQUENCE_AXIS, causal: bool = False,
                      scale: float | None = None, bias=None, window=None,
                      logit_softcap: float | None = None, dropout_rate: float = 0.0,
                      dropout_seed=0):
    """q: [B, S, H, D]; k, v: [B, S, Hk, D], global, split over the
    ``axis_name`` ranks along S; H divisible by the ranks, and Hk and the
    ranks dividing one way.  bias: [B, H, S, S], split over heads.
    Returns out [B, S, H, D], differentiable w.r.t. q, k and v."""
    n = len(mesh.axis_devices(axis_name))
    H, Hk = q.shape[2], k.shape[2]
    if H % n:
        raise ValueError(f"num_heads {H} not divisible by axis size {n}")
    if Hk % n:
        if n % Hk:
            raise ValueError(f"num_kv_heads {Hk} and axis size {n} must divide one way")
        # rank d's query heads use KV head d // rep, which replica d holds
        k = k.repeat_interleave(n // Hk, dim=2)
        v = v.repeat_interleave(n // Hk, dim=2)
    spec = (None, axis_name, None, None)
    seed = seed32(dropout_seed)

    def to_heads(x):  # [B, S_loc, H, D] a rank -> [B, S, H / n, D]
        return all_to_all(mesh, shard(mesh, x, spec), split_dim=2, concat_dim=1, axis=axis_name)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    bs = [None] * n if bias is None else shard(mesh, bias, (None, axis_name, None, None))
    outs = [flash_attention(qh[r], kh[r], vh[r], causal=causal, scale=scale, mask=bs[r],
                            window=window, logit_softcap=logit_softcap,
                            dropout_rate=dropout_rate, dropout_seed=seed_add(seed, r))
            for r in range(n)]
    back = all_to_all(mesh, outs, split_dim=1, concat_dim=2, axis=axis_name)
    return unshard(mesh, back, spec, q.device)


def make_ulysses_attention(mesh, *, axis_name: str = SEQUENCE_AXIS, causal: bool = False,
                           scale: float | None = None, has_bias: bool = False, window=None,
                           logit_softcap: float | None = None, dropout_rate: float = 0.0):
    """``ulysses_attention`` bound to ``mesh`` and its options: fn(q, k, v),
    or fn(q, k, v, bias) with ``has_bias``; the dropout seed is 0."""
    kw = dict(mesh=mesh, axis_name=axis_name, causal=causal, scale=scale, window=window,
              logit_softcap=logit_softcap, dropout_rate=dropout_rate)
    if has_bias:
        return lambda q, k, v, bias: ulysses_attention(q, k, v, bias=bias, **kw)
    return lambda q, k, v: ulysses_attention(q, k, v, **kw)

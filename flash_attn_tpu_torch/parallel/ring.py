"""Ring attention: sequence-parallel exact attention over the mesh's ring.

Port of flash_attn_tpu/parallel/ring.py.  Each rank holds a query shard
and, at step t, the KV shard of rank (r - t) mod n; the KV shards rotate
one rank a step (``mesh.ppermute``), and each rank merges its step's
partial attention into its running (out, lse) by the LSE algebra
(``ops/lse.lse_merge2``).  Every step runs the port's ``flash_fwd`` (K4 on
the card); the backward, one ``torch.autograd.Function`` over the whole
ring, recomputes each step with ``flash_bwd`` (K9 + K10) from the merged
LSE, accumulates dq on its rank and rotates dk/dv with their shard, so
that after n steps each is back at its home rank (ring.py:246-378).

The single-process form: one process drives every rank of
``mesh.axis_devices(axis_name)``, rank by rank within each step, on
global [B, S, H, D] tensors split over the axis.  On one card the ranks
are logical ranks and the rotation moves no bytes.

Layouts (ring.py:18-34): "contiguous" (rank d holds tokens
[d*S_loc, (d+1)*S_loc); causal steps split three ways: earlier shards in
full, the diagonal causal, later shards skipped) and "striped" (rank d
holds tokens d, d+n, ...; see ``stripe_sequence``; every causal step is
triangular, the strict ones, sources after the rank, on the shard's first
S_loc - 1 keys).

Options as the single-device kernels take them: causal, GQA, dropout
(each (q-shard, kv-shard) pair seeded by ``_step_seed``; the backward
replays it), an additive bias [B, H, S, S] sharded on its query axis
(with its gradient when it requires one: each step's column block of
dS goes into a full-K fp32 accumulator of the rank's rows, as JAX's
``_ring_core_bwd`` does, ring.py:256, 292, 311-349, 364-370) and
``logit_softcap`` without a bias or dropout.  A window (contiguous
layout, causal, no bias or dropout; head_dim 128 on the card) goes
through the positions path, as JAX's ``use_pos`` (ring.py:117-148,
246-274): every live step passes the shards' global positions, which the
window and ``kv_pos <= q_pos`` compare, with no causal flag (K4's masked
kLocal instance forward, K9's and K10's kLocal and kOpt instances
backward); later shards are skipped as in the causal ring.  The striped
layout with a window raises, as JAX does (ring.py:418-419).  Every
refusal comes before any launch.  Each step's output is rounded to q's
dtype and taken to fp32 before the merge, as JAX does (ring.py:163).
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.ops.flash_bwd import flash_bwd
from flash_attn_tpu_torch.ops.flash_fwd import _window, flash_fwd, seed32, seed_add
from flash_attn_tpu_torch.ops.lse import lse_merge2
from flash_attn_tpu_torch.parallel.mesh import SEQUENCE_AXIS, ppermute, shard, unshard

NEG_INF = -1e30  # the port's dead-row LSE, which K9 and K10 take
LAYOUTS = ("contiguous", "striped")


def stripe_sequence(x, n, axis=1):
    """Contiguous -> striped sequence order: after it, an even contiguous
    split of ``axis`` over n ranks puts global token g on rank g % n at
    local slot g // n.  Apply it to q, k, v (and to both sequence axes of
    a bias) before a striped ring; RoPE runs before it."""
    s = x.shape[axis]
    if s % n:
        raise ValueError(f"sequence {s} not divisible by ring size {n}")
    parts = list(x.shape[:axis]) + [s // n, n] + list(x.shape[axis + 1:])
    return x.reshape(parts).movedim(axis + 1, axis).reshape(x.shape)


def unstripe_sequence(x, n, axis=1):
    """Inverse of ``stripe_sequence``."""
    s = x.shape[axis]
    parts = list(x.shape[:axis]) + [n, s // n] + list(x.shape[axis + 1:])
    return x.reshape(parts).movedim(axis, axis + 1).reshape(x.shape)


def _step_seed(seed: int, my: int, kv_idx: int, n: int) -> int:
    """The dropout seed of the (q-shard ``my``, kv-shard ``kv_idx``) pair:
    seed + my * n + kv_idx with int32 wraparound, as JAX adds it.  The
    same in the forward and the backward, so the backward replays."""
    return seed_add(seed, my * n + kv_idx)


def _slice_bias_cols(bias, kv_idx: int, s_loc: int):
    """bias [B, H, S_loc, S] -> this step's [B, H, S_loc, s_loc] key
    columns (a view; striped rings stripe the bias's key axis too)."""
    return None if bias is None else bias[..., kv_idx * s_loc:(kv_idx + 1) * s_loc]


def _step(causal: bool, striped: bool, my: int, kv_idx: int):
    """(causal_step, strict) for rank ``my`` holding shard ``kv_idx``, or
    None for a skipped step (contiguous, causal, a later shard)."""
    if not causal:
        return False, False
    if striped:
        return True, kv_idx > my
    if kv_idx > my:
        return None
    return kv_idx == my, False


def _refuse(q, bias, *, layout, causal, window, logit_softcap, dropout_rate, n, grad):
    """Raise on what the ring does not take, before any launch."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown ring layout {layout!r}")
    if window is not None:
        if layout == "striped":
            raise NotImplementedError("window + striped ring layout")
        if not causal:
            raise NotImplementedError("ring window requires causal=True (the kernel positions "
                                      "path implies kv_pos <= q_pos)")
        if bias is not None or float(dropout_rate) > 0.0:
            raise NotImplementedError("ring attention: a window with a bias or dropout is not "
                                      "ported yet (flash_fwd refuses it)")
        if q.is_cuda and q.shape[-1] != 128:
            raise NotImplementedError("ring window on the card: K4, K9 and K10 take a window "
                                      "with positions at head_dim 128")
    if logit_softcap is not None and (bias is not None or float(dropout_rate) > 0.0):
        raise NotImplementedError("ring attention: a softcap with a bias or dropout is not "
                                  "ported yet (flash_fwd refuses it)")
    # K9 and K10 take head_dim 256 causal only; a ring's earlier shards
    # are non-causal steps
    some_full = not causal or (layout == "contiguous" and n > 1)
    if grad and q.is_cuda and q.shape[-1] == 256 and some_full:
        raise NotImplementedError("ring backward at head_dim 256 needs non-causal steps, which "
                                  "K9 and K10 do not take")


def _positions(x, rank: int, s_loc: int):
    """[B, s_loc] int32 global positions of shard ``rank`` (contiguous
    layout), on x's device."""
    pos = torch.arange(rank * s_loc, (rank + 1) * s_loc, dtype=torch.int32, device=x.device)
    return pos[None].expand(x.shape[0], s_loc)


def _pos_kw(opts, q, my: int, kv_idx: int, s_loc: int):
    """A windowed step's keywords: the shards' global positions and the
    window, with no causal flag (kv_pos <= q_pos is the causal mask); {}
    without a window."""
    if opts["window"] is None:
        return {}
    return dict(q_positions=_positions(q, my, s_loc), kv_positions=_positions(q, kv_idx, s_loc),
                window=opts["window"])


def _kv_step(kc, vc, bias, strict: bool):
    """The step's keys, values and bias columns; a strict step keeps the
    first S_loc - 1 keys (static causal shifted by one)."""
    if not strict:
        return kc, vc, bias
    cut = kc.shape[1] - 1
    return (kc[:, :cut].contiguous(), vc[:, :cut].contiguous(),
            None if bias is None else bias[..., :cut])


def _ring_fwd(mesh, axis, qs, ks, vs, bs, opts):
    """The forward ring over the ranks' shards.  Returns each rank's out
    [B, S_loc, H, D] in q's dtype and lse [B, H, S_loc] fp32 (dead rows at
    -1e30, the port's convention)."""
    n = len(qs)
    B, s_loc, H, D = qs[0].shape
    striped = opts["layout"] == "striped"
    outs = [torch.zeros((B, H, s_loc, D), dtype=torch.float32, device=q.device) for q in qs]
    lses = [torch.full((B, H, s_loc), float("-inf"), device=q.device) for q in qs]
    kc, vc = list(ks), list(vs)
    for t in range(n):
        # the rotation for step t + 1 is issued before step t's kernels, as
        # JAX double-buffers it (ring.py:167-175)
        kn, vn = ppermute(mesh, kc, axis), ppermute(mesh, vc, axis)
        for my in range(n):
            kv_idx = (my - t) % n
            step = _step(opts["causal"], striped, my, kv_idx)
            if step is None:
                continue
            k_t, v_t, b_t = _kv_step(kc[my], vc[my], _slice_bias_cols(bs[my], kv_idx, s_loc),
                                     step[1])
            pos = _pos_kw(opts, qs[my], my, kv_idx, s_loc)
            o, lse = flash_fwd(qs[my], k_t, v_t, causal=step[0] and not pos, scale=opts["scale"],
                               bias=b_t, logit_softcap=opts["logit_softcap"],
                               dropout_rate=opts["dropout_rate"],
                               dropout_seed=_step_seed(opts["seed"], my, kv_idx, n), **pos)
            outs[my], lses[my] = lse_merge2(outs[my], lses[my], o.float().transpose(1, 2), lse)
        kc, vc = kn, vn
    return ([o.transpose(1, 2).to(q.dtype).contiguous() for o, q in zip(outs, qs)],
            [lse.clamp(min=NEG_INF) for lse in lses])


def _ring_bwd(mesh, axis, qs, ks, vs, bs, outs, lses, douts, opts, want_dbias=False):
    """The backward ring: each step's gradients from the merged LSE; dq
    stays on its rank, dk/dv rotate with the shard and come home after n
    steps.  Returns per-rank dq, dk, dv in the inputs' dtypes, and per-rank
    dbias (fp32, the shape of the rank's bias rows) or None."""
    n = len(qs)
    s_loc = qs[0].shape[1]
    striped = opts["layout"] == "striped"
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    dkc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device) for k in ks]
    dvc = [torch.zeros(v.shape, dtype=torch.float32, device=v.device) for v in vs]
    dbs = ([torch.zeros(b.shape, dtype=torch.float32, device=b.device) for b in bs]
           if want_dbias else None)
    kc, vc = list(ks), list(vs)
    for t in range(n):
        kn, vn = ppermute(mesh, kc, axis), ppermute(mesh, vc, axis)
        for my in range(n):
            kv_idx = (my - t) % n
            step = _step(opts["causal"], striped, my, kv_idx)
            if step is None:
                continue
            k_t, v_t, b_t = _kv_step(kc[my], vc[my], _slice_bias_cols(bs[my], kv_idx, s_loc),
                                     step[1])
            pos = _pos_kw(opts, qs[my], my, kv_idx, s_loc)
            g = flash_bwd(qs[my], k_t, v_t, outs[my], lses[my], douts[my],
                          causal=step[0] and not pos, scale=opts["scale"], bias=b_t,
                          logit_softcap=opts["logit_softcap"],
                          dropout_rate=opts["dropout_rate"],
                          dropout_seed=_step_seed(opts["seed"], my, kv_idx, n),
                          want_dbias=want_dbias, **pos)
            dq, dk, dv = g[:3]
            if want_dbias:
                # this step's bias columns, into the full-K accumulator at the
                # block they were sliced from (a strict step's last column
                # saw no query: 0)
                c0 = kv_idx * s_loc
                dbs[my][..., c0:c0 + g[3].shape[-1]] += g[3].float()
            if step[1]:  # the last key saw no query: zero gradient
                pad = (0, 0, 0, 0, 0, 1)
                dk, dv = (torch.nn.functional.pad(g, pad) for g in (dk, dv))
            dqs[my] += dq.float()
            dkc[my] += dk.float()
            dvc[my] += dv.float()
        dkc, dvc = ppermute(mesh, dkc, axis), ppermute(mesh, dvc, axis)
        kc, vc = kn, vn
    return ([g.to(x.dtype) for g, x in zip(dqs, qs)], [g.to(x.dtype) for g, x in zip(dkc, ks)],
            [g.to(x.dtype) for g, x in zip(dvc, vs)], dbs)


class _Ring(torch.autograd.Function):
    """The whole ring, forward and backward, on global tensors: q, k, v
    split over the axis, the bias over its query axis (its gradient,
    when it requires one, gathered back the same way)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mesh, axis, opts):
        spec = (None, axis, None, None)
        qs, ks, vs = (shard(mesh, x, spec) for x in (q, k, v))
        bs = ([None] * len(qs) if bias is None
              else shard(mesh, bias, _bias_spec(axis)))
        outs, lses = _ring_fwd(mesh, axis, qs, ks, vs, bs, opts)
        out = unshard(mesh, outs, spec, q.device)
        ctx.save_for_backward(q, k, v, out, unshard(mesh, lses, (None, None, axis), q.device),
                              bias)
        ctx.mesh, ctx.axis, ctx.opts = mesh, axis, opts
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, bias = ctx.saved_tensors
        mesh, axis = ctx.mesh, ctx.axis
        spec = (None, axis, None, None)
        qs, ks, vs, outs, douts = (shard(mesh, x, spec) for x in (q, k, v, out, dout))
        lses = shard(mesh, lse, (None, None, axis))
        bs = ([None] * len(qs) if bias is None else shard(mesh, bias, _bias_spec(axis)))
        want_dbias = bias is not None and ctx.needs_input_grad[3]
        dqs, dks, dvs, dbs = _ring_bwd(mesh, axis, qs, ks, vs, bs, outs, lses, douts, ctx.opts,
                                       want_dbias)
        dbias = (unshard(mesh, dbs, _bias_spec(axis), bias.device).to(bias.dtype)
                 if want_dbias else None)
        return (unshard(mesh, dqs, spec, q.device), unshard(mesh, dks, spec, k.device),
                unshard(mesh, dvs, spec, v.device), dbias, None, None, None)


def _bias_spec(axis):
    """The bias's split: its query axis over the ring."""
    return (None, None, axis, None)


def ring_attention(q, k, v, *, mesh, axis_name: str = SEQUENCE_AXIS, causal: bool = False,
                   scale: float | None = None, layout: str = "contiguous", bias=None,
                   window=None, logit_softcap: float | None = None, dropout_rate: float = 0.0,
                   dropout_seed=0):
    """Ring attention over ``mesh``'s ``axis_name`` ranks.

    q: [B, S, H, D]; k, v: [B, S, Hk, D], global, split over the ranks
    along S (striped layouts take ``stripe_sequence`` order and give it
    back).  bias: [B, H, S, S] additive, split on its query axis, its key
    columns in layout order (a striped ring: both axes striped).  Returns
    out [B, S, H, D] in q's dtype, differentiable w.r.t. q, k, v and the
    bias.  window (left, right; -1 open): the contiguous layout with
    ``causal`` only, on the global positions."""
    n = len(mesh.axis_devices(axis_name))
    grad = torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v))
    window = _window(window)
    _refuse(q, bias, layout=layout, causal=causal, window=window, logit_softcap=logit_softcap,
            dropout_rate=dropout_rate, n=n, grad=grad)
    opts = dict(causal=causal, scale=scale, layout=layout, logit_softcap=logit_softcap,
                dropout_rate=float(dropout_rate), seed=seed32(dropout_seed), window=window)
    return _Ring.apply(q, k, v, bias, mesh, axis_name, opts)


def make_ring_attention(mesh, *, axis_name: str = SEQUENCE_AXIS, causal: bool = False,
                        scale: float | None = None, layout: str = "contiguous",
                        has_bias: bool = False, window=None,
                        logit_softcap: float | None = None, dropout_rate: float = 0.0):
    """``ring_attention`` bound to ``mesh`` and its options, as JAX's
    shard_map wrapper: fn(q, k, v), or fn(q, k, v, bias) with
    ``has_bias``; the dropout seed is 0."""
    kw = dict(mesh=mesh, axis_name=axis_name, causal=causal, scale=scale, layout=layout,
              window=window, logit_softcap=logit_softcap, dropout_rate=dropout_rate)
    if has_bias:
        return lambda q, k, v, bias: ring_attention(q, k, v, bias=bias, **kw)
    return lambda q, k, v: ring_attention(q, k, v, **kw)

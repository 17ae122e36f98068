"""Sequence-sharded decode: the KV cache split over the mesh's sequence
axis, one decode a rank shard, the partials merged exactly across shards
(BASELINE config 3: 128k context with the cache sharded).

Port of flash_attn_tpu/parallel/sharded_decode.py in the mesh's
single-process form.  Each rank runs K1 on its run of the cache's
positions (``ops/decode.flash_decode_partials``); where the axis's ranks
share the cache's device the run is a view of the one buffer, which K1
reads in place.  The ranks' fp32 split partials are gathered and merged
by JAX's rule (the max LSE, each partial weighted by exp(lse - max), the
weighted sum divided by the weights' sum, in fp32): on the card in one
launch of K1m over every shard's splits, on the CPU as JAX writes it.  A
shard that holds none of a sequence's history (length 0) gives K1's dead
partials (out 0, lse -1e30), which weigh 0, as JAX's -inf does.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.ops.decode import flash_decode_partials
from flash_attn_tpu_torch.ops.lse import DEAD_LSE, lse_merge_cuda
from flash_attn_tpu_torch.parallel.mesh import (
    SEQUENCE_AXIS,
    all_gather,
    axis_device,
    same_device,
    shard_views,
)


def sharded_decode(q, k_shard, v_shard, *, mesh, axis_name: str, shard_kv_length,
                   k_scale=None, v_scale=None, scale: float | None = None,
                   kv_layout: str = "bshd"):
    """The shard-local body, every rank's argument a list in rank order.

    q: [B, H, D], the same on every rank; k_shard, v_shard: each rank's
    run of the cache, [B, S_loc, Hk, D] (kv_layout "bshd") or [B, Hk,
    S_loc, D] ("bhsd", the engine's layout); k_scale, v_scale: each
    rank's scales for int8/fp8 shards (broadcastable to [B, S_loc, Hk, 1],
    or [B, Hk, S_loc]); shard_kv_length: each rank's [B] int32 valid
    entries (``shard_lengths``).  Returns out [B, H, D] in q's dtype on
    rank 0's device (every rank's result is the same)."""
    n = len(k_shard)
    no = [None] * n
    outs, lses = [], []
    for r, (k, v, ks, vs, lens) in enumerate(zip(
            k_shard, v_shard, no if k_scale is None else k_scale,
            no if v_scale is None else v_scale, shard_kv_length)):
        o, lse = flash_decode_partials(q.to(k.device), k, v, kv_length=lens, k_scale=ks,
                                       v_scale=vs, scale=scale, kv_layout=kv_layout)
        outs.append(o)
        lses.append(lse)
    outs = all_gather(mesh, outs, axis_name, tiled=True)[0]
    lses = all_gather(mesh, lses, axis_name, tiled=True)[0]
    return merge_shards(outs, lses, q.dtype).to(q.device)


def merge_shards(outs, lses, dtype):
    """The merge across shards of partials over disjoint key sets, outs
    [n, B, H, D] fp32 and lses [n, B, H], into [B, H, D] in ``dtype``: on
    the card one K1m launch (the LSE rule, the same function), on the CPU
    JAX's formula (sharded_decode.py:66-75)."""
    if outs.is_cuda:
        return lse_merge_cuda(outs.contiguous(), lses.contiguous(), dtype)[0]
    return merge_shards_plain(outs, lses, dtype)


def merge_shards_plain(outs, lses, dtype):
    """The plain version of the merge across shards, JAX's formula on any
    device: the max LSE, the weights exp(lse - max) (0 for a dead
    partial), the weighted sum over the weights' sum, in fp32."""
    live = lses > DEAD_LSE
    m = torch.where(live, lses, torch.full_like(lses, float("-inf"))).amax(dim=0)
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.where(live, torch.exp(lses - safe_m), torch.zeros_like(lses))
    num = (outs.float() * w[..., None]).sum(dim=0)
    den = w.sum(dim=0)[..., None]
    out = torch.where(den > 0, num / torch.clamp(den, min=1e-37), torch.zeros_like(num))
    return out.to(dtype)


def shard_lengths(length: torch.Tensor, n_shards: int, shard_size: int) -> torch.Tensor:
    """Global lengths [B] -> each shard's valid counts [n_shards, B] for a
    capacity axis split into equal contiguous shards (on the device, no
    host read)."""
    i = torch.arange(n_shards, dtype=length.dtype, device=length.device)[:, None]
    return torch.clamp(length[None] - i * shard_size, 0, shard_size)


def make_sharded_decode(mesh, *, axis_name: str = SEQUENCE_AXIS, scale: float | None = None,
                        quantized: bool = False, kv_layout: str = "bshd"):
    """``sharded_decode`` on global tensors: fn(q, k, v, lens) or, with
    ``quantized``, fn(q, k, v, k_scale, v_scale, lens); k, v [B, S, Hk, D]
    ("bshd") or [B, Hk, S, D] ("bhsd") split on S over ``axis_name``
    (views where the ranks share the cache's device), scales split alike
    ([B, S, Hk, 1] or [B, Hk, S]), lens [n_shards, B] (``shard_lengths``).
    Returns out [B, H, D]."""
    if kv_layout not in ("bshd", "bhsd"):
        raise ValueError(f"unknown kv_layout {kv_layout!r}")

    def split(x):
        spec = [None] * x.ndim
        spec[2 if kv_layout == "bhsd" else 1] = axis_name
        return shard_views(mesh, x, tuple(spec))

    def fn(q, k, v, *rest):
        if len(rest) != (3 if quantized else 1):
            raise ValueError("the sharded decode takes (q, k, v, k_scale, v_scale, lens) when "
                             "quantized, else (q, k, v, lens)")
        ks, vs = (split(rest[0]), split(rest[1])) if quantized else (None, None)
        lens = rest[-1]
        n = lens.shape[0]
        if n != mesh.shape[axis_name]:
            raise ValueError(f"lens has {n} shards, the axis {axis_name!r} "
                             f"{mesh.shape[axis_name]} ranks")
        return sharded_decode(q, split(k), split(v), mesh=mesh, axis_name=axis_name,
                              shard_kv_length=[lens[r] for r in range(n)], k_scale=ks,
                              v_scale=vs, scale=scale, kv_layout=kv_layout)

    return fn


def check_kv_mesh(mesh, axis_name: str, capacity: int, device) -> int:
    """The rank count of the mesh axis a cache's capacity is sharded over,
    after the checks JAX's engine makes (the capacity divides by it) and
    the single-process form's own: the ranks must sit on the cache's
    device, each rank's shard a view of the one buffer (a mesh across
    cards needs collectives that are not ported)."""
    n = len(mesh.axis_devices(axis_name))
    if capacity % n:
        raise ValueError(f"capacity {capacity} not divisible by mesh axis {axis_name}={n}")
    dev = axis_device(mesh, axis_name)
    if dev is None or not same_device(dev, device):
        raise NotImplementedError(
            f"the sequence-sharded cache needs every rank of {axis_name!r} on the cache's "
            f"device {device}: a mesh across devices is not ported")
    return n

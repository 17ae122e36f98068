"""Carry JAX-side state into the port through numpy, so both sides run on
identical values.

This module imports no JAX: it takes anything ``numpy.asarray`` accepts
(a JAX array converts itself), including the ``ml_dtypes`` bfloat16 and
float8_e4m3fn arrays that JAX produces.

- ``params_from_jax``: a params pytree (dicts, lists, float arrays,
  ``(int8, scales)`` tuples, the legacy ``("w8a8", int8, scales)`` tuple,
  and the weight classes ``Int4Weight``, ``W4A8Weight``, ``W8A8Weight``,
  ``BiasedWeight``, recognised by class name) -> the same structure of
  torch tensors and the port's classes.  An ``Int4Weight`` in the TPU's
  "planes" layout is repacked as halves, the port's one layout.
- ``kv_cache_from_jax``: a JAX ``KVCache`` -> the port's ``KVCache``.  The
  JAX cache stores scales lane-dense as [B, Hk, 1, S] and, for fp8 caches
  whose capacity is a multiple of 2048, permuted evens-then-odds within
  each 2048 chunk (flash_attn_tpu/engine/kv_cache.py:93-100); the port
  stores [B, Hk, S] in natural order, so the permutation is undone here.
- ``paged_pool_from_jax``: a JAX ``PagedKVPool`` -> the port's pool, its
  fp8 scales put back in natural order the same way (chunk = page).
- ``lora_from_jax``: a JAX LoRA tree or stacked bank
  (flash_attn_tpu/models/lora.py) -> the port's, leaf for leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from flash_attn_tpu_torch._device import resolve_device
from flash_attn_tpu_torch.engine.kv_cache import KVCache
from flash_attn_tpu_torch.engine.paged import PagedKVPool
from flash_attn_tpu_torch.ops.matmul import BiasedWeight, W4A8Weight, W8A8Weight
from flash_attn_tpu_torch.ops.quant import Int4Weight, pack_int4, unpack_int4


def to_torch(x, device=None) -> torch.Tensor:
    """One array -> torch tensor, keeping bfloat16 and float8_e4m3fn."""
    a = np.asarray(x)
    name = a.dtype.name
    if name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    elif name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8).copy()).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(resolve_device(device))


def _int4_from_jax(w, device):
    """A JAX Int4Weight / W4A8Weight -> (packed halves, scales), on the
    CPU first so a planes relayout never needs the card."""
    packed = to_torch(w.packed, "cpu")
    if getattr(w, "layout", "halves") == "planes":
        packed = pack_int4(unpack_int4(packed, w.group_size, "planes"), w.group_size)
    return packed.to(device), to_torch(w.scales, device)


def params_from_jax(tree, device=None):
    """Recursively convert a JAX params pytree onto ``device`` (default:
    the card)."""
    device = resolve_device(device)
    kind = type(tree).__name__
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_jax(v, device) for v in tree]
    if kind == "Int4Weight":
        return Int4Weight(*_int4_from_jax(tree, device), tree.group_size,
                          tuple(tree.shape))
    if kind == "W4A8Weight":
        return W4A8Weight(*_int4_from_jax(tree, device), tree.group_size,
                          tuple(tree.shape))
    if kind == "W8A8Weight":
        return W8A8Weight(to_torch(tree.vals, device), to_torch(tree.scales, device))
    if kind == "BiasedWeight":
        return BiasedWeight(params_from_jax(tree.w, device), to_torch(tree.bias, device))
    if isinstance(tree, tuple):
        if len(tree) == 3 and tree[0] == "w8a8":
            return ("w8a8", to_torch(tree[1], device), to_torch(tree[2], device))
        if len(tree) != 2:
            raise ValueError(f"unknown weight tuple of length {len(tree)}")
        return tuple(to_torch(t, device) for t in tree)
    if tree is None or isinstance(tree, (int, float, str)):
        return tree
    return to_torch(tree, device)


def depermute_scale_lanes(s: np.ndarray, chunk: int) -> np.ndarray:
    """Undo the evens-then-odds lane order within each ``chunk`` of the
    last axis (inverse of flash_attn_tpu/ops/decode.py
    _permute_scale_lanes)."""
    lead = s.shape[:-1]
    S = s.shape[-1]
    r = s.reshape(*lead, S // chunk, 2, chunk // 2)
    return np.swapaxes(r, -1, -2).reshape(*lead, S)


def _natural_scales(buf, chunk, device) -> torch.Tensor:
    """JAX's lane-dense [X, Hk, 1, S] scales -> [X, Hk, S] fp32, with the
    evens-then-odds order within each ``chunk`` undone (none if None)."""
    s = np.asarray(buf, np.float32)[:, :, 0, :]
    if chunk:
        s = depermute_scale_lanes(s, chunk)
    return torch.from_numpy(np.array(s, np.float32)).to(device)


def kv_cache_from_jax(jcache, device=None) -> KVCache:
    """A JAX ``KVCache`` (duck-typed: k, v, k_scale, v_scale, length, mode,
    scale_perm_chunk) -> the port's cache on ``device`` (default: the
    card)."""
    device = resolve_device(device)
    k = [to_torch(x, device) for x in jcache.k]
    v = [to_torch(x, device) for x in jcache.v]
    ks = vs = None
    if jcache.mode != "none":
        chunk = jcache.scale_perm_chunk
        ks = [_natural_scales(x, chunk, device) for x in jcache.k_scale]
        vs = [_natural_scales(x, chunk, device) for x in jcache.v_scale]
    length = torch.from_numpy(np.asarray(jcache.length, np.int32).copy()).to(device)
    return KVCache(k, v, ks, vs, length, jcache.mode)


def paged_pool_from_jax(jpool, device=None) -> PagedKVPool:
    """A JAX ``PagedKVPool`` (duck-typed: k_pages, v_pages, k_scale,
    v_scale, block_table, length, mode) -> the port's pool on ``device``
    (default: the card).  The JAX pool stores scales lane-dense as
    [P, Hk, 1, page] and, for fp8 pools whose page is a multiple of 4,
    evens-then-odds within each page (flash_attn_tpu/engine/paged.py:
    57-64); the port stores [P, Hk, page] in natural order."""
    device = resolve_device(device)
    k = [to_torch(x, device) for x in jpool.k_pages]
    v = [to_torch(x, device) for x in jpool.v_pages]
    ks = vs = None
    if jpool.mode != "none":
        page = k[0].shape[2]
        chunk = page if jpool.mode == "fp8" and page % 4 == 0 else None
        ks = [_natural_scales(x, chunk, device) for x in jpool.k_scale]
        vs = [_natural_scales(x, chunk, device) for x in jpool.v_scale]
    table = torch.from_numpy(np.asarray(jpool.block_table, np.int32).copy()).to(device)
    length = torch.from_numpy(np.asarray(jpool.length, np.int32).copy()).to(device)
    return PagedKVPool(k, v, ks, vs, table, length, jpool.mode)


def lora_from_jax(tree, device=None) -> dict:
    """A JAX LoRA tree or stacked bank ({"blocks": [{name: (A, B)}],
    "scaling"}) -> the same structure of torch tensors on ``device``
    (default: the card)."""
    device = resolve_device(device)
    return {"blocks": [{name: tuple(to_torch(t, device) for t in ab) for name, ab in blk.items()}
                       for blk in tree["blocks"]],
            "scaling": float(tree["scaling"])}

"""Fused quantize + append of one token per sequence into a BHSD KV cache
(kernel K2, ``csrc/kv_append.cu``).

Port of flash_attn_tpu/ops/kv_append.py:kv_append_token.  The TPU
version returns aliased buffers; this one updates the cache in place.
Scales are stored in natural position order as [B, Hk, S] fp32 (the TPU's
lane-dense [B, Hk, 1, S] layout and its fp8 lane permutation are Mosaic
artifacts and are not carried over).

A sequence whose ``length[b]`` is at or beyond the capacity S writes
nothing: the engine advances idle slots every step, so their length
keeps growing past the cache.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch import _build
from flash_attn_tpu_torch.ops.quant import quantize_kv

_MODES = {"none": 0, "int8": 1, "fp8": 2}


def kv_append_token(k_cache, v_cache, k_scale, v_scale, new_k, new_v,
                    length, *, mode: str):
    """Insert one token per sequence, in place.

    k_cache/v_cache: [B, Hk, S, D] (int8 / float8_e4m3fn / model dtype);
    k_scale/v_scale: [B, Hk, S] fp32 (None for mode='none');
    new_k/new_v: [B, Hk, D] in the model dtype (already rotated);
    length: [B] int32 write position per sequence.
    Returns the same four buffers, updated.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown kv cache mode {mode!r}")
    B, Hk, S, D = k_cache.shape
    if new_k.shape != (B, Hk, D) or new_v.shape != (B, Hk, D):
        raise ValueError(f"new kv must be [{B}, {Hk}, {D}], got {tuple(new_k.shape)}")
    if (mode == "none") != (k_scale is None):
        raise ValueError("scales must be given exactly for quantized modes")
    if k_cache.is_cuda:
        kv_append_cuda(k_cache, v_cache, k_scale, v_scale, new_k, new_v,
                       length, mode)
    else:
        kv_append_plain(k_cache, v_cache, k_scale, v_scale, new_k, new_v,
                        length, mode)
    return k_cache, v_cache, k_scale, v_scale


def kv_append_plain(k_cache, v_cache, k_scale, v_scale, new_k, new_v,
                    length, mode):
    """Plain PyTorch version of K2: ``quantize_kv``'s arithmetic (x / scale,
    int8 half-to-even, fp8 by a native cast) written at ``length[b]``."""
    S = k_cache.shape[2]
    length = length.long()
    live = torch.nonzero((length >= 0) & (length < S)).flatten()
    if live.numel() == 0:
        return
    heads = torch.arange(k_cache.shape[1], device=k_cache.device)
    idx = (live[:, None], heads[None, :], length[live][:, None])
    kq, ks, vq, vs = quantize_kv(new_k[live].float(), new_v[live].float(), mode)
    for cache, scale_buf, vals, scale in ((k_cache, k_scale, kq, ks),
                                          (v_cache, v_scale, vq, vs)):
        if cache.dtype == torch.float8_e4m3fn:
            cache.view(torch.uint8)[idx] = vals.view(torch.uint8)
        else:
            cache[idx] = vals.to(cache.dtype)
        if scale_buf is not None:
            scale_buf[idx] = scale[..., 0]


def kv_append_cuda(k_cache, v_cache, k_scale, v_scale, new_k, new_v,
                   length, mode):
    """Launch K2.  Replaces flash_attn_tpu/ops/kv_append.py:_append_kernel;
    bound by bytes (see the source note in csrc/kv_append.cu)."""
    B, Hk, S, D = k_cache.shape
    want = {"none": torch.bfloat16, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}[mode]
    if k_cache.dtype != want or v_cache.dtype != want:
        raise ValueError(f"{mode} cache must be {want}, got {k_cache.dtype}")
    if new_k.dtype != torch.bfloat16 or new_v.dtype != torch.bfloat16:
        raise ValueError("the CUDA append takes bf16 new K/V")
    if length.dtype != torch.int32:
        raise ValueError("length must be int32")
    tensors = [k_cache, v_cache, new_k, new_v, length]
    if mode != "none":
        tensors += [k_scale, v_scale]
        if k_scale.dtype != torch.float32 or k_scale.shape != (B, Hk, S):
            raise ValueError("scales must be [B, Hk, S] fp32")
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("K2 takes contiguous CUDA tensors")
    if D % 4 or any(t.data_ptr() % 8 for t in (k_cache, v_cache, new_k, new_v)):
        raise ValueError(f"K2 takes D % 4 == 0 (got {D}) and 8-byte aligned caches and "
                         "new K/V")
    p = _build.ptr
    rc = _build.lib().fatt_kv_append(
        p(k_cache), p(v_cache), p(k_scale), p(v_scale), p(new_k), p(new_v),
        p(length), B, Hk, S, D, _MODES[mode], _build.stream())
    _build.check(rc, "fatt_kv_append")
    kv_append_cuda.launches += 1


kv_append_cuda.launches = 0

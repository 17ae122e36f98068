"""Quantization primitives: INT8 / FP8 (E4M3) with absmax scales.

Port of flash_attn_tpu/ops/quant.py (int8 and fp8; int4 is still to port).

Conventions (same as the JAX package):
- scales are fp32 and multiply on dequant: ``x ~= values * scale``;
- INT8 is symmetric absmax over the reduced axes, range +-127, rounded
  half to even (``torch.round``, as ``jnp.round``);
- FP8 is ``float8_e4m3fn`` scaled so the absmax maps to 448.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # float8_e4m3fn max normal


def _absmax_scale(x: torch.Tensor, dims, qmax: float) -> torch.Tensor:
    amax = x.float().abs().amax(dim=dims, keepdim=True)
    # a tensor divisor keeps IEEE division (PyTorch multiplies by the
    # reciprocal of a Python scalar divisor on the card)
    return torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                       torch.ones_like(amax))


def quantize_int8(x: torch.Tensor, dims=(-1,)):
    """Symmetric INT8: returns (values int8, scale fp32 with the reduced
    dims kept as 1)."""
    scale = _absmax_scale(x, dims, 127.0)
    vals = torch.clamp(torch.round(x.float() / scale), -127, 127)
    return vals.to(torch.int8), scale


def quantize_fp8(x: torch.Tensor, dims=(-1,)):
    """FP8 E4M3 with absmax scaling to the format's full range."""
    scale = _absmax_scale(x, dims, FP8_MAX)
    return (x.float() / scale).to(torch.float8_e4m3fn), scale


def dequantize(values: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    return (values.float() * scale.float()).to(dtype)


def quantize_kv(k: torch.Tensor, v: torch.Tensor, mode: str):
    """Quantize new KV entries. k/v: [..., Hk, D]; scales per (token, head),
    shaped [..., Hk, 1].  mode: 'int8' | 'fp8' | 'none'.
    Returns (kq, k_scale, vq, v_scale)."""
    if mode == "none":
        return k, None, v, None
    if mode == "int8":
        kq, ks = quantize_int8(k)
        vq, vs = quantize_int8(v)
        return kq, ks, vq, vs
    if mode == "fp8":
        kq, ks = quantize_fp8(k)
        vq, vs = quantize_fp8(v)
        return kq, ks, vq, vs
    raise ValueError(f"unknown kv quant mode: {mode!r}")

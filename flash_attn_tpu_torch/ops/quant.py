"""Quantization primitives: INT8 / FP8 (E4M3) with absmax scales, and
packed INT4 with per-(group, column) scales.

Port of flash_attn_tpu/ops/quant.py.

Conventions (same as the JAX package):
- scales are fp32 and multiply on dequant: ``x ~= values * scale``;
- INT8 is symmetric absmax over the reduced axes, range +-127, rounded
  half to even (``torch.round``, as ``jnp.round``);
- FP8 is ``float8_e4m3fn`` scaled so the absmax maps to 448;
- INT4 is symmetric, range +-7, stored as the nibble ``q + 8`` two to a
  byte in the group-local **halves** layout: within each group of ``g``
  k-rows, packed row j holds value row j in its low nibble and value row
  j + g/2 in its high nibble.  The JAX package's "planes" layout exists
  only for the TPU's bitcast byte order; ``unpack_int4`` reads it so the
  bridge can repack it as halves, and nothing here produces it.
"""

from __future__ import annotations

from dataclasses import dataclass

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


# ---------------------------------------------------------------------------
# INT4 (packed, halves layout) -- weight-only
# ---------------------------------------------------------------------------


@dataclass
class Int4Weight:
    """Packed int4 weight for a [K, N] matmul: ``packed`` [K//2, N] uint8
    in the halves layout, ``scales`` [K//group_size, N] fp32."""

    packed: torch.Tensor
    scales: torch.Tensor
    group_size: int
    shape: tuple  # original (K, N)

    @property
    def layout(self) -> str:
        return "halves"


_CLIPS = (1.0, 0.95, 0.9, 0.85, 0.8)


def pack_int4(q: torch.Tensor, group_size: int) -> torch.Tensor:
    """int values [K, N] in [-8, 7] -> [K//2, N] uint8, halves layout."""
    K, N = q.shape
    g = group_size
    qu = (q.to(torch.int16) + 8).to(torch.uint8).reshape(K // g, g, N)
    lo, hi = qu[:, : g // 2], qu[:, g // 2:]
    return (lo | (hi << 4)).reshape(K // 2, N).contiguous()


def quantize_int4(w: torch.Tensor, group_size: int = 128) -> Int4Weight:
    """Quantize [K, N] weights to packed int4 (halves) with per-(group, N)
    scales.  The clip search tries the JAX package's clip ratios and keeps,
    per (group, column), the scale with the least round-trip squared error
    (strict ``<``, so a tie keeps the earlier ratio).  The arithmetic is
    the JAX package's, so both give the same bytes and scales: the
    candidate scale is ``amax * fp32(c / 7)``, rounding is half to even."""
    K, N = w.shape
    g = group_size
    if g % 2:
        raise ValueError("group_size must be even")
    if K % g:
        raise ValueError(f"K ({K}) must be a multiple of group_size ({g})")
    wf = w.float().reshape(K // g, g, N)
    amax = wf.abs().amax(dim=1, keepdim=True)  # [K//g, 1, N]
    one = torch.ones_like(amax)
    best_err = scales = None
    for c in _CLIPS:
        ratio = torch.tensor(c / 7.0, dtype=torch.float32, device=w.device)
        sc = torch.where(amax > 0, amax * ratio, one)
        qc = torch.clamp(torch.round(wf / sc), -7, 7)
        err = torch.square(qc * sc - wf).sum(dim=1, keepdim=True)
        if best_err is None:
            best_err, scales = err, sc
        else:
            take = err < best_err
            best_err = torch.where(take, err, best_err)
            scales = torch.where(take, sc, scales)
        del qc, err
    q = torch.clamp(torch.round(wf / scales), -7, 7).to(torch.int8)
    del wf
    packed = pack_int4(q.reshape(K, N), g)
    return Int4Weight(packed, scales[:, 0, :].contiguous(), g, (K, N))


def unpack_int4(packed: torch.Tensor, group_size: int,
                layout: str = "halves") -> torch.Tensor:
    """Inverse of the group-local packing: [K//2, N] uint8 -> [K, N] int8
    in [-8, 7] in value-row order.  ``layout="planes"`` reads the JAX
    package's planes layout (value order per group: even packed rows' low
    nibbles, their high nibbles, odd rows' low, odd rows' high)."""
    K2, N = packed.shape
    g = group_size
    p = packed.reshape(K2 * 2 // g, g // 2, N)
    lo = (p & 0x0F).to(torch.int8) - 8
    hi = (p >> 4).to(torch.int8) - 8
    if layout == "halves":
        vals = torch.cat([lo, hi], dim=1)
    elif layout == "planes":
        vals = torch.cat([lo[:, 0::2], hi[:, 0::2], lo[:, 1::2], hi[:, 1::2]], dim=1)
    else:
        raise ValueError(f"unknown int4 layout {layout!r}")
    return vals.reshape(K2 * 2, N)


def dequantize_int4(w: Int4Weight, dtype=torch.float32) -> torch.Tensor:
    """[K, N] in ``dtype``: the fp32 product of value and scale, then one
    cast, as the JAX package computes it."""
    vals = unpack_int4(w.packed, w.group_size).float()
    scales = torch.repeat_interleave(w.scales.float(), w.group_size, dim=0)
    return (vals * scales).to(dtype)

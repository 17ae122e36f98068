"""Weight-only INT8 matmul (kernel K3, ``csrc/matmul_int8.cu``) and the
``quantized_matmul`` dispatch.

Port of flash_attn_tpu/ops/matmul.py:matmul_int8 (per-column scales) and
quantized_matmul for the ``(int8 [K, N], scales [N])`` tuple and for a
float weight, which goes to ``torch.matmul`` as the JAX package leaves it
to ``jnp.dot``.  Grouped int8 scales, int4, W8A8 and W4A8 are still to
port.

Scales are folded out of the product, as on the TPU: int8 weights widen
exactly to the activation dtype, the product accumulates in fp32, and the
per-column scale multiplies the accumulator once.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch import _build

# blocks that fill the H100's 132 SMs twice over
_TARGET_BLOCKS = 264
# K3's small-M path: rows per tile and columns per block
_SMALL_M = 16
_SMALL_BN = 64


def matmul_int8(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor, *,
                out_dtype=None) -> torch.Tensor:
    """x [M, K] (bf16 / fp32) @ int8 w [K, N] with per-column scales [N]
    fp32.  Returns [M, N] in ``out_dtype`` (default x.dtype)."""
    M, K = x.shape
    Kw, N = w.shape
    if K != Kw:
        raise ValueError(f"shape mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    if scales.shape != (N,):
        raise ValueError("only per-column scales [N] are ported")
    out_dtype = out_dtype or x.dtype
    if x.is_cuda:
        return matmul_int8_cuda(x, w, scales, out_dtype)
    return matmul_int8_plain(x, w, scales, out_dtype)


def matmul_int8_plain(x, w, scales, out_dtype):
    """Plain PyTorch version of K3: exact int8 -> float widening, fp32
    accumulation, scale at the end."""
    acc = x.float() @ w.float()
    return (acc * scales.float()).to(out_dtype)


def _k_splits(M: int, K: int, N: int) -> int:
    if M > _SMALL_M:
        return 1
    col_blocks = -(-N // _SMALL_BN)
    return max(1, min(-(-_TARGET_BLOCKS // col_blocks), K // 256))


def matmul_int8_cuda(x, w, scales, out_dtype):
    """Launch K3.  Replaces flash_attn_tpu/ops/matmul.py:_int8_kernel;
    bound by bytes at decode and by operations at prefill (see the source
    note in csrc/matmul_int8.cu)."""
    M, K = x.shape
    N = w.shape[1]
    if x.dtype != torch.bfloat16 or out_dtype != torch.bfloat16:
        raise ValueError("K3 takes and returns bf16")
    if w.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError("K3 takes int8 weights with fp32 scales")
    if K % 8 or N % 16:
        raise ValueError(f"K3 needs K % 8 == 0 and N % 16 == 0, got {K}, {N}")
    for t in (x, w, scales):
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("K3 takes contiguous, 16-byte aligned CUDA tensors")
    splits = _k_splits(M, K, N)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    part = None
    if splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
    p = _build.ptr
    rc = _build.lib().fatt_matmul_int8(
        p(x), p(w), p(scales), p(out), p(part), M, K, N, splits,
        _build.stream())
    _build.check(rc, "fatt_matmul_int8")
    matmul_int8_cuda.launches += 1
    return out


matmul_int8_cuda.launches = 0


def quantized_matmul(x: torch.Tensor, w, *, out_dtype=None) -> torch.Tensor:
    """Dispatch on weight kind: ``(int8, scales)`` tuple -> matmul_int8;
    a float tensor -> torch.matmul in the promoted dtype, cast to
    ``out_dtype`` or x.dtype as jnp.dot's result is."""
    if isinstance(w, tuple):
        if len(w) != 2:
            raise NotImplementedError("only (int8, scales) weights are ported")
        vals, scales = w
        if scales.ndim != 1:
            raise NotImplementedError("grouped int8 scales are not ported yet")
        return matmul_int8(x, vals, scales, out_dtype=out_dtype)
    if not isinstance(w, torch.Tensor):
        raise NotImplementedError(f"weight kind {type(w).__name__} is not ported yet")
    dtype = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dtype), w.to(dtype)).to(out_dtype or x.dtype)

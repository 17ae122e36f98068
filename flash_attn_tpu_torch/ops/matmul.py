"""Quantized matmuls and the ``quantized_matmul`` dispatch.

Port of flash_attn_tpu/ops/matmul.py, on these hand-written kernels:

- K3 ``csrc/matmul_q.cu``: bf16 or fp32 x @ int8 W, per-column scales;
- K3 grouped: the same kernel with per-(group, N) scales;
- K6: the same kernel on packed int4 W (halves layout);
- K5: per-token int8 x @ packed int4 W (W4A8);
- K7: per-token int8 x @ int8 W (W8A8).

Scales are folded out of the product, as on the TPU: integer weights
widen exactly, each group's partial sum (fp32 for bf16 x, exact int32
for int8 x) is multiplied by its scale, and per-token activation scales
multiply the finished sum.  ``quantize_activations`` and the M >= 512
int4 route (dequantize, then ``torch.matmul``) are plain PyTorch, as the
JAX package leaves both to XLA outside its kernels.

Weight kinds (as the JAX package's pytree classes): a float tensor, an
``(int8, scales)`` tuple (scales [N] or [K//g, N]), ``Int4Weight``,
``W4A8Weight``, ``W8A8Weight``, the legacy ``("w8a8", int8, scales)``
tuple, and ``BiasedWeight`` around any of them; ``ShardedWeight`` holds
one of them split over a tensor-parallel mesh axis (parallel/tp.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from flash_attn_tpu_torch import _build
from flash_attn_tpu_torch.ops.quant import (
    Int4Weight,
    dequantize_int4,
    quantize_int8,
    unpack_int4,
)

# the largest M that takes the decode (bytes-bound) instances
_SMALL_M = 16
# matmul_q.cu: k-rows per tile (every split holds whole tiles, so whole
# groups), columns per block, and the group sizes the kernels take
_Q_BK = 128
_Q_BN = 128
_Q_GROUPS = (32, 64, 128)
# blocks a matmul_q.cu launch should reach before K is split: at decode four
# for each of the H100's 132 SMs (two resident an SM; shorter blocks shrink
# the last wave's tail: chip_tools/gemm_probe.py --decode-targets); at a
# prompt bucket (one block an SM) half the card, so the splits stay within
# one wave
_Q_DECODE_BLOCKS = 528
_Q_PROMPT_BLOCKS = 66
# at and above this M the int4 matmuls dequantize and take a float dot
# (flash_attn_tpu/ops/matmul.py:_PREFILL_M)
_PREFILL_M = 512


# ---------------------------------------------------------------------------
# weight kinds
# ---------------------------------------------------------------------------


@dataclass
class W4A8Weight:
    """Packed int4 weight (halves layout, [K//2, N] uint8, scales
    [K//g, N] fp32) for the int8 x int8 path with per-token activation
    quantization (``matmul_w4a8``)."""

    packed: torch.Tensor
    scales: torch.Tensor
    group_size: int
    shape: tuple  # original (K, N)

    @property
    def layout(self) -> str:
        return "halves"


@dataclass
class W8A8Weight:
    """int8 weight [K, N] with per-column scales [N] for the int8 x int8
    path with per-token activation quantization (``matmul_w8a8``)."""

    vals: torch.Tensor
    scales: torch.Tensor


@dataclass
class BiasedWeight:
    """A weight of any kind plus an output bias [N] (Qwen-2's qkv bias)."""

    w: object
    bias: torch.Tensor


def _is_legacy_w8a8(w) -> bool:
    return isinstance(w, tuple) and len(w) == 3 and w[0] == "w8a8"


def weight_kn(w) -> tuple:
    """(K, N) of a weight of any kind."""
    if isinstance(w, BiasedWeight):
        return weight_kn(w.w)
    if isinstance(w, (Int4Weight, W4A8Weight)):
        return tuple(w.shape)
    if isinstance(w, W8A8Weight):
        return tuple(w.vals.shape)
    if isinstance(w, tuple):
        return tuple(w[1 if _is_legacy_w8a8(w) else 0].shape)
    return tuple(w.shape)


def weight_device(w) -> torch.device:
    """The device a weight of any kind lies on."""
    if isinstance(w, BiasedWeight):
        return weight_device(w.w)
    if isinstance(w, (Int4Weight, W4A8Weight)):
        return w.packed.device
    if isinstance(w, W8A8Weight):
        return w.vals.device
    if isinstance(w, tuple):
        return w[1 if _is_legacy_w8a8(w) else 0].device
    return w.device


@dataclass
class ShardedWeight:
    """One leaf of a tensor-parallel param tree (parallel/tp.py):
    ``parts[r]`` is rank r's slice, on its device, of a weight of any kind
    above, of an embedding table or of a bias vector.

    kind "col": split on the output axis (the last); the parts' outputs
      join in rank order.
    kind "row": split on the input axis K (the first); the parts' fp32
      outputs sum in rank order.  Activation-quantized kinds (W8A8, and
      W4A8 below the prefill route) quantize each token once over its
      whole row, then split the int8 row, so the product is the unsharded
      one's.
    kind "vocab": an embedding [V, H] split on the vocabulary.  A lookup
      (``w[tokens]``) takes each token's row from the rank that holds it;
      as a tied head it is column-parallel over the transposed table."""

    kind: str
    parts: list
    mesh: object = None

    def full(self) -> torch.Tensor:
        """The parts of a float leaf joined on rank 0's device."""
        dev = self.parts[0].device
        dim = self.parts[0].ndim - 1 if self.kind == "col" else 0
        return torch.cat([p.to(dev) for p in self.parts], dim=dim)

    def __getitem__(self, idx: torch.Tensor) -> torch.Tensor:
        """Embedding rows for token ids ``idx`` (kind "vocab"): each rank
        gathers the ids in its range and zeros elsewhere; the sum over
        ranks adds one nonzero row a token, so it is exact."""
        if self.kind != "vocab":
            raise TypeError(f"a {self.kind!r} sharded weight takes no lookup")
        out, lo = None, 0
        for p in self.parts:
            n = p.shape[0]
            i = idx.to(p.device) - lo
            hit = ((i >= 0) & (i < n))[..., None]
            rows = torch.where(hit, p[i.clamp(0, n - 1)], torch.zeros((), dtype=p.dtype,
                                                                         device=p.device))
            out = rows.to(idx.device) if out is None else out + rows.to(out.device)
            lo += n
        return out


def _sharded_matmul(x, w: ShardedWeight, out_dtype):
    """x [M, K] @ a ShardedWeight, on x's device, in ``out_dtype`` (default
    x.dtype)."""
    out_dtype = out_dtype or x.dtype
    if w.kind in ("col", "vocab"):
        ys = [quantized_matmul(x.to(weight_device(p)), p.T if w.kind == "vocab" else p,
                               out_dtype=out_dtype).to(x.device) for p in w.parts]
        return torch.cat(ys, dim=-1)
    if w.kind != "row":
        raise ValueError(f"unknown sharded weight kind {w.kind!r}")
    p0 = w.parts[0]
    act_q = (isinstance(p0, W8A8Weight) or _is_legacy_w8a8(p0)
             or isinstance(p0, W4A8Weight) and x.shape[0] < _PREFILL_M)
    xin, sx = quantize_activations(x) if act_q else (x, None)
    total, k0 = None, 0
    for p in w.parts:
        k = weight_kn(p)[0]
        dev = weight_device(p)
        xs = xin[:, k0:k0 + k].contiguous().to(dev)
        y = _int8_act_dot(xs, sx.to(dev), p) if act_q else quantized_matmul(
            xs, p, out_dtype=torch.float32)
        total = y.to(x.device) if total is None else total + y.to(x.device)
        k0 += k
    return total.to(out_dtype)


def _int8_act_dot(xq, sx, w):
    """fp32 xq (int8 [M, K], per-token scales sx) @ an activation-quantized
    weight, through K7 or K5 on the card, their plain versions here."""
    cuda = xq.is_cuda
    if isinstance(w, W4A8Weight):
        fn = matmul_w4a8_cuda if cuda else matmul_w4a8_plain
        return fn(xq, sx, w.packed, w.scales, w.group_size, torch.float32)
    vals, scales = (w[1], w[2]) if _is_legacy_w8a8(w) else (w.vals, w.scales)
    return (matmul_w8a8_cuda if cuda else matmul_w8a8_plain)(xq, sx, vals, scales,
                                                             torch.float32)


# ---------------------------------------------------------------------------
# shared checks and launch geometry
# ---------------------------------------------------------------------------


def _check_cuda(name, *tensors):
    for t in tensors:
        if not t.is_cuda or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} takes contiguous, 16-byte aligned CUDA tensors")


def _q_rows(M: int, x_f32: bool = False) -> int:
    """x rows a block of matmul_q.cu takes (its launch_m): 16 at decode,
    64 up to M = 64 and for fp32 x, else 128."""
    if M <= _SMALL_M:
        return 16
    return 64 if M <= 64 or x_f32 else 128


def _q_plan(M: int, K: int, N: int, x_f32: bool = False):
    """(splits, k_per_split) for matmul_q.cu.  K is split when the output
    tiles alone do not reach the block target (``_Q_DECODE_BLOCKS`` at
    decode, ``_Q_PROMPT_BLOCKS`` at a prompt bucket); a split holds whole
    128-row tiles, at least two."""
    tiles = -(-M // _q_rows(M, x_f32)) * -(-N // _Q_BN)
    want = -(-(_Q_DECODE_BLOCKS if M <= _SMALL_M else _Q_PROMPT_BLOCKS) // tiles)
    if want <= 1:
        return 1, K
    kps = max(2 * _Q_BK, K // want // _Q_BK * _Q_BK)
    return -(-K // kps), kps


def _check_q_shape(name, M, K, N, group_size=None):
    if K % _Q_BK or N % 4:
        raise ValueError(f"{name} needs K % {_Q_BK} == 0 and N % 4 == 0, got {K}, {N}")
    if group_size is not None and group_size not in _Q_GROUPS:
        raise ValueError(f"{name} takes group sizes {_Q_GROUPS}, got {group_size}")
    if M < 1:
        raise ValueError(f"{name} needs M >= 1")


def _scratch(splits, M, N, dtype, device):
    if splits == 1:
        return None
    return torch.empty((splits, M, N), dtype=dtype, device=device)


def _grouped(x2, G, g):
    """[M, K] -> [G, M, g]."""
    return x2.reshape(x2.shape[0], G, g).transpose(0, 1)


# ---------------------------------------------------------------------------
# K3: bf16 or fp32 x @ int8 W (per-column or grouped scales)
# ---------------------------------------------------------------------------


def matmul_int8(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor, *,
                out_dtype=None) -> torch.Tensor:
    """x [M, K] (bf16 / fp32) @ int8 w [K, N] with per-column scales [N] or
    per-(group, N) scales [K//g, N], fp32.  Returns [M, N] in
    ``out_dtype`` (default x.dtype)."""
    M, K = x.shape
    Kw, N = w.shape
    if K != Kw:
        raise ValueError(f"shape mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    out_dtype = out_dtype or x.dtype
    if scales.ndim == 2:
        if scales.shape[1] != N or K % scales.shape[0]:
            raise ValueError(f"grouped scales {tuple(scales.shape)} do not fit K={K}, N={N}")
        g = K // scales.shape[0]
        if x.is_cuda:
            return matmul_int8_grouped_cuda(x, w, scales, g, out_dtype)
        return matmul_int8_grouped_plain(x, w, scales, g, out_dtype)
    if scales.shape != (N,):
        raise ValueError(f"scales must be [N] or [K//g, N], got {tuple(scales.shape)}")
    if x.is_cuda:
        return matmul_int8_cuda(x, w, scales, out_dtype)
    return matmul_int8_plain(x, w, scales, out_dtype)


def matmul_int8_plain(x, w, scales, out_dtype):
    """Plain PyTorch version of K3: exact int8 -> float widening, fp32
    accumulation, scale at the end."""
    acc = x.float() @ w.float()
    return (acc * scales.float()).to(out_dtype)


def matmul_int8_grouped_plain(x, w, scales, group_size, out_dtype):
    """Plain version of K3 grouped: each group's fp32 partial times its
    scale row, summed over groups (flash_attn_tpu/ops/matmul.py:141-157)."""
    K, N = w.shape
    G = K // group_size
    partial = torch.bmm(_grouped(x.float(), G, group_size),
                        w.float().reshape(G, group_size, N))  # [G, M, N]
    return (partial * scales.float()[:, None, :]).sum(0).to(out_dtype)


def _float_q(name, x, w, scales, group_size, int4, out_dtype):
    """Check and launch csrc/matmul_q.cu's float-activation kernel: K3
    (int8 W, per-column scales, group_size 0), K3 grouped (int8 W) or K6
    (packed int4 W).  x bf16 or fp32, out bf16 or fp32."""
    M, K = x.shape
    N = w.shape[1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} takes bf16 or fp32 activations")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} returns bf16 or fp32")
    if w.dtype != (torch.uint8 if int4 else torch.int8) or scales.dtype != torch.float32:
        raise ValueError(f"{name} takes {'uint8 packed' if int4 else 'int8'} weights "
                         "with fp32 scales")
    if w.shape[0] * (2 if int4 else 1) != K:
        raise ValueError(f"{name}: weights {tuple(w.shape)} do not fit x {tuple(x.shape)}")
    if scales.shape != ((K // group_size, N) if group_size else (N,)):
        raise ValueError(f"{name}: scales {tuple(scales.shape)} do not fit K={K}, N={N}")
    _check_q_shape(name, M, K, N, group_size or None)
    _check_cuda(name, x, w, scales)
    x_f32 = x.dtype == torch.float32
    splits, kps = _q_plan(M, K, N, x_f32)
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    part = _scratch(splits, M, N, torch.float32, x.device)
    p = _build.ptr
    rc = _build.lib().fatt_matmul_float_q(
        p(x), p(w), p(scales), p(out), p(part), M, K, N, group_size, int(int4),
        int(x_f32), int(out_dtype == torch.bfloat16), kps, _build.stream())
    _build.check(rc, "fatt_matmul_float_q")
    return out


def matmul_int8_cuda(x, w, scales, out_dtype):
    """Launch K3 (csrc/matmul_q.cu, per-column scales).  Replaces
    flash_attn_tpu/ops/matmul.py:_int8_kernel; bound by bytes at decode
    and by operations at prefill."""
    out = _float_q("K3", x, w, scales, 0, False, out_dtype)
    matmul_int8_cuda.launches += 1
    return out


matmul_int8_cuda.launches = 0


def matmul_int8_grouped_cuda(x, w, scales, group_size, out_dtype):
    """Launch K3 grouped (csrc/matmul_q.cu).  Replaces the grouped ``kern``
    of flash_attn_tpu/ops/matmul.py:matmul_int8."""
    out = _float_q("K3 grouped", x, w, scales, group_size, False, out_dtype)
    matmul_int8_grouped_cuda.launches += 1
    return out


matmul_int8_grouped_cuda.launches = 0


# ---------------------------------------------------------------------------
# int4 weight-only (K6) and the M >= 512 route
# ---------------------------------------------------------------------------


def _dequant_dot(x, w, out_dtype):
    """Prefill route of the int4 matmuls (flash_attn_tpu/ops/matmul.py:
    _dequant_dot): dequantize to x's dtype, then a float dot with fp32
    accumulation, cast to ``out_dtype``."""
    wf = dequantize_int4(w, dtype=x.dtype)
    if x.dtype == torch.bfloat16 and out_dtype == torch.bfloat16:
        return torch.matmul(x, wf)  # fp32 accumulation, one rounding
    return torch.matmul(x.float(), wf.float()).to(out_dtype)


def matmul_int4(x: torch.Tensor, w, *, out_dtype=None) -> torch.Tensor:
    """x [M, K] @ packed int4 w (halves, [K, N]) with per-(group, N) scales.
    M >= 512 dequantizes and takes a float dot, as the JAX package does."""
    M, K = x.shape
    Kw, N = w.shape
    if K != Kw:
        raise ValueError(f"shape mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    if w.layout != "halves":
        raise ValueError("the port's int4 weights use the halves layout")
    out_dtype = out_dtype or x.dtype
    if M >= _PREFILL_M:
        return _dequant_dot(x, w, out_dtype)
    if x.is_cuda:
        return matmul_int4_cuda(x, w.packed, w.scales, w.group_size, out_dtype)
    return matmul_int4_plain(x, w.packed, w.scales, w.group_size, out_dtype)


def matmul_int4_plain(x, packed, scales, group_size, out_dtype):
    """Plain version of K6, the TPU kernel's arithmetic: nibbles n in 0..15
    widen exactly, each group's fp32 partial is sum(x n) - 8 sum(x), times
    its scale row, summed over groups in fp32."""
    K = packed.shape[0] * 2
    N = packed.shape[1]
    G = K // group_size
    nib = (unpack_int4(packed, group_size) + 8).float().reshape(G, group_size, N)
    xg = _grouped(x.float(), G, group_size)  # [G, M, g]
    partial = torch.bmm(xg, nib) - 8.0 * xg.sum(-1, keepdim=True)
    return (partial * scales.float()[:, None, :]).sum(0).to(out_dtype)


def matmul_int4_cuda(x, packed, scales, group_size, out_dtype):
    """Launch K6 (csrc/matmul_q.cu, int4 W).  Replaces
    flash_attn_tpu/ops/matmul.py:_int4_kernel and _int4_plane_kernel (the
    bridge turns planes into halves)."""
    out = _float_q("K6", x, packed, scales, group_size, True, out_dtype)
    matmul_int4_cuda.launches += 1
    return out


matmul_int4_cuda.launches = 0


# ---------------------------------------------------------------------------
# per-token int8 activations: W8A8 (K7) and W4A8 (K5)
# ---------------------------------------------------------------------------


def quantize_activations(x: torch.Tensor):
    """Per-row symmetric int8: x [M, K] -> (xq int8 [M, K], scale fp32
    [M, 1]), with IEEE ``amax / 127`` (flash_attn_tpu/ops/matmul.py:514)."""
    return quantize_int8(x, dims=(-1,))


def matmul_w8a8(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor, *,
                out_dtype=None) -> torch.Tensor:
    """x [M, K] float -> per-token int8, @ int8 w [K, N] with per-column
    scales [N]; exact int32 sum, then ``float(acc) * sx * sw``."""
    M, K = x.shape
    Kw, N = w.shape
    if K != Kw:
        raise ValueError(f"shape mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    if scales.ndim != 1:
        raise ValueError("w8a8 requires per-column weight scales [N]")
    out_dtype = out_dtype or x.dtype
    xq, sx = quantize_activations(x)
    if x.is_cuda:
        return matmul_w8a8_cuda(xq, sx, w, scales, out_dtype)
    return matmul_w8a8_plain(xq, sx, w, scales, out_dtype)


def matmul_w8a8_plain(xq, sx, w, sw, out_dtype):
    """Plain version of K7: the int32 dot computed exactly in float64
    (int8 products summed over K stay far below 2^53), then
    ``float(acc) * sx * sw`` in that order, as the kernel does."""
    acc = (xq.double() @ w.double()).float()
    return (acc * sx.float() * sw.float()).to(out_dtype)


def matmul_w8a8_cuda(xq, sx, w, sw, out_dtype):
    """Launch K7 (csrc/matmul_q.cu, int8 x int8).  Replaces
    flash_attn_tpu/ops/matmul.py:_w8a8_kernel."""
    M, K = xq.shape
    N = w.shape[1]
    if xq.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError("K7 takes int8 activations and weights")
    if sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise ValueError("K7 takes fp32 scales")
    if sx.numel() != M or sw.shape != (N,):
        raise ValueError("K7: scales sx [M, 1] and sw [N] do not fit")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("K7 returns fp32 or bf16")
    _check_q_shape("K7", M, K, N)
    _check_cuda("K7", xq, sx, w, sw)
    splits, kps = _q_plan(M, K, N)
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    part = _scratch(splits, M, N, torch.int32, xq.device)
    p = _build.ptr
    rc = _build.lib().fatt_matmul_s8_q(
        p(xq), p(sx), p(w), p(sw), p(out), p(part), M, K, N, 0, 0,
        int(out_dtype == torch.bfloat16), kps, _build.stream())
    _build.check(rc, "fatt_matmul_s8_q")
    matmul_w8a8_cuda.launches += 1
    return out


matmul_w8a8_cuda.launches = 0


def matmul_w4a8(x: torch.Tensor, w, *, out_dtype=None) -> torch.Tensor:
    """x [M, K] float -> per-token int8, @ packed int4 w (halves) with
    per-(group, N) scales.  M >= 512 skips the activation quantization:
    dequantize and a float dot, as the JAX package does."""
    M, K = x.shape
    Kw, N = w.shape
    if K != Kw:
        raise ValueError(f"shape mismatch {tuple(x.shape)} @ {tuple(w.shape)}")
    out_dtype = out_dtype or x.dtype
    if M >= _PREFILL_M:
        return _dequant_dot(x, w, out_dtype)
    xq, sx = quantize_activations(x)
    if x.is_cuda:
        return matmul_w4a8_cuda(xq, sx, w.packed, w.scales, w.group_size, out_dtype)
    return matmul_w4a8_plain(xq, sx, w.packed, w.scales, w.group_size, out_dtype)


def matmul_w4a8_plain(xq, sx, packed, scales, group_size, out_dtype):
    """Plain version of K5: each group's int8 dot with the weights n - 8 is
    exact (float64), times its scale row in fp32, summed over groups, then
    times the per-token scale.  The JAX kernel keeps n and subtracts
    8 * (xsum @ s): the same sum, rounded in another order."""
    K = packed.shape[0] * 2
    N = packed.shape[1]
    G = K // group_size
    vals = unpack_int4(packed, group_size).double().reshape(G, group_size, N)
    d = torch.bmm(_grouped(xq.double(), G, group_size), vals).float()  # [G, M, N]
    acc = (d * scales.float()[:, None, :]).sum(0)
    return (acc * sx.float()).to(out_dtype)


def matmul_w4a8_cuda(xq, sx, packed, scales, group_size, out_dtype):
    """Launch K5 (csrc/matmul_q.cu, int8 x int4).  Replaces
    flash_attn_tpu/ops/matmul.py:_w4a8_kernel."""
    M, K = xq.shape
    N = packed.shape[1]
    if xq.dtype != torch.int8 or packed.dtype != torch.uint8:
        raise ValueError("K5 takes int8 activations and uint8 packed weights")
    if sx.dtype != torch.float32 or scales.dtype != torch.float32:
        raise ValueError("K5 takes fp32 scales")
    if packed.shape[0] * 2 != K or scales.shape != (K // group_size, N) or sx.numel() != M:
        raise ValueError("K5: packed [K//2, N], scales [K//g, N] and sx [M, 1] do not fit")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("K5 returns fp32 or bf16")
    _check_q_shape("K5", M, K, N, group_size)
    _check_cuda("K5", xq, sx, packed, scales)
    splits, kps = _q_plan(M, K, N)
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    part = _scratch(splits, M, N, torch.float32, xq.device)
    p = _build.ptr
    rc = _build.lib().fatt_matmul_s8_q(
        p(xq), p(sx), p(packed), p(scales), p(out), p(part), M, K, N,
        group_size, 1, int(out_dtype == torch.bfloat16), kps, _build.stream())
    _build.check(rc, "fatt_matmul_s8_q")
    matmul_w4a8_cuda.launches += 1
    return out


matmul_w4a8_cuda.launches = 0


# ---------------------------------------------------------------------------
# fusion and dispatch
# ---------------------------------------------------------------------------


def concat_weights(ws):
    """Concatenate weights of one kind along N, so same-input projections
    fuse into one matmul (qkv, gate+up).  Exact: every scale scheme is
    per column, so quantize-then-concat equals concat-then-quantize."""
    kinds = {type(w) for w in ws}
    if len(kinds) != 1:
        raise ValueError(f"cannot concat mixed weight kinds: {kinds}")
    w0 = ws[0]
    if isinstance(w0, BiasedWeight):
        return BiasedWeight(concat_weights([w.w for w in ws]),
                            torch.cat([w.bias for w in ws]))
    if isinstance(w0, (Int4Weight, W4A8Weight)):
        if len({w.group_size for w in ws}) != 1 or len({w.shape[0] for w in ws}) != 1:
            raise ValueError("int4 concat needs equal K and group_size")
        return type(w0)(torch.cat([w.packed for w in ws], dim=1),
                        torch.cat([w.scales for w in ws], dim=1),
                        w0.group_size, (w0.shape[0], sum(w.shape[1] for w in ws)))
    if isinstance(w0, W8A8Weight):
        return W8A8Weight(torch.cat([w.vals for w in ws], dim=1),
                          torch.cat([w.scales for w in ws]))
    if _is_legacy_w8a8(w0):
        return ("w8a8", torch.cat([w[1] for w in ws], dim=1),
                torch.cat([w[2] for w in ws]))
    if isinstance(w0, tuple):
        # scales: [N] per column or [K//g, N] grouped; N is the last axis
        return (torch.cat([w[0] for w in ws], dim=1),
                torch.cat([w[1] for w in ws], dim=w0[1].ndim - 1))
    return torch.cat(ws, dim=1)


def quantized_matmul(x: torch.Tensor, w, *, out_dtype=None) -> torch.Tensor:
    """Dispatch on weight kind (flash_attn_tpu/ops/matmul.py:
    quantized_matmul).  A float weight goes to torch.matmul in the promoted
    dtype, cast to ``out_dtype`` or x.dtype as jnp.dot's result is."""
    if isinstance(w, BiasedWeight):
        y = quantized_matmul(x, w.w, out_dtype=out_dtype)
        return (y.float() + w.bias.float()).to(y.dtype)
    if isinstance(w, ShardedWeight):
        return _sharded_matmul(x, w, out_dtype)
    if isinstance(w, Int4Weight):
        return matmul_int4(x, w, out_dtype=out_dtype)
    if isinstance(w, W4A8Weight):
        return matmul_w4a8(x, w, out_dtype=out_dtype)
    if isinstance(w, W8A8Weight):
        return matmul_w8a8(x, w.vals, w.scales, out_dtype=out_dtype)
    if _is_legacy_w8a8(w):
        return matmul_w8a8(x, w[1], w[2], out_dtype=out_dtype)
    if isinstance(w, tuple):
        vals, scales = w
        return matmul_int8(x, vals, scales, out_dtype=out_dtype)
    dtype = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dtype), w.to(dtype)).to(out_dtype or x.dtype)

"""ctypes binding to the port's native host library: the C ABI attention
entry points (``runtime/native/fatt_abi.cc``) and the page allocator
(``runtime/native/page_allocator.cc``) that the paged engine's admission
uses.

Port of flash_attn_tpu/runtime/abi.py.  The library is host code: at
first use it is built with the host C++ compiler (``c++``, or ``$CXX``)
into ``flash_attn_tpu_torch/_build/host-<hash of the sources>/``, the same
on the CPU as beside the card.  A missing compiler or a failed build
raises: there is no Python stand-in.

The C ABI: a host program fills a ``fatt_attn_call`` (laid out field for
field as the JAX package's ``fatpu_attn_call``) with host buffers and
calls ``fatt_attn_fwd``, ``fatt_attn_varlen_fwd``, ``fatt_attn_bwd`` or
``fatt_attn_varlen_bwd``; each validates the struct and dispatches to the
executor that ``register_torch_executor`` installed, which runs K4 (and
K9 + K10 for the backward) on the card and writes the results into the
caller's buffers.  ``false`` comes back with ``fatt_last_error()`` set.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from ctypes import (
    POINTER,
    c_bool,
    c_char_p,
    c_float,
    c_int32,
    c_int64,
    c_size_t,
    c_uint64,
    c_void_p,
)
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parents[1]
_NATIVE = Path(__file__).resolve().parent / "native"
_SRCS = [_NATIVE / "fatt_abi.cc", _NATIVE / "page_allocator.cc"]
_HDRS = [_NATIVE / "fatt_abi.h"]
_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]


class FattAttnCall(ctypes.Structure):
    """``fatt_attn_call`` (native/fatt_abi.h), field for field the JAX
    package's ``FatpuAttnCall``."""

    _fields_ = [
        ("struct_size", c_size_t),
        ("q", c_void_p),
        ("k", c_void_p),
        ("v", c_void_p),
        ("out", c_void_p),
        ("lse", POINTER(c_float)),
        ("attn_mask", c_void_p),
        ("mask_dims", POINTER(c_int64)),
        ("mask_ndim", c_int32),
        ("cu_seqlens_q", POINTER(c_int32)),
        ("cu_seqlens_k", POINTER(c_int32)),
        ("batch", c_int32),
        ("seqlen_q", c_int32),
        ("seqlen_k", c_int32),
        ("total_q", c_int32),
        ("total_k", c_int32),
        ("num_heads", c_int32),
        ("num_heads_k", c_int32),
        ("head_dim", c_int32),
        ("dtype", c_int32),
        ("softmax_scale", c_float),
        ("dropout_rate", c_float),
        ("dropout_seed", c_uint64),
        ("is_causal", c_bool),
        ("dout", c_void_p),
        ("dq", c_void_p),
        ("dk", c_void_p),
        ("dv", c_void_p),
        ("lse_in", POINTER(c_float)),
    ]


EXECUTOR_FN = ctypes.CFUNCTYPE(c_bool, POINTER(FattAttnCall))
ENTRY_POINTS = ("fatt_attn_fwd", "fatt_attn_varlen_fwd", "fatt_attn_bwd",
                "fatt_attn_varlen_bwd")

# dtype enum -> (the buffer's numpy type, the torch type it holds); bf16
# buffers are read as int16 and viewed as bf16 (no ml_dtypes needed)
_DTYPES = {0: (np.float32, torch.float32), 1: (np.int16, torch.bfloat16),
           2: (np.float16, torch.float16)}

_keepalive = []  # registered CFUNCTYPE objects must outlive the library


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (c++): the host library cannot be built")
    return cxx


@functools.cache
def load() -> ctypes.CDLL:
    """The loaded host library, built first if its sources changed."""
    h = hashlib.sha256()
    for src in _SRCS + _HDRS:
        h.update(src.name.encode() + src.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    out_dir = _PKG / "_build" / f"host-{h.hexdigest()[:16]}"
    path = out_dir / "libfatt_host.so"
    if not path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libfatt_host.so.tmp{os.getpid()}"
        res = subprocess.run([_compiler(), *_FLAGS, "-I", str(_NATIVE), "-o", str(tmp),
                              *map(str, _SRCS)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError("host library build failed:\n" + res.stdout + res.stderr)
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    i32p = POINTER(c_int32)
    call_p = POINTER(FattAttnCall)
    for name, res_t, args in (
            ("fatt_pool_create", c_void_p, [c_int32]),
            ("fatt_pool_destroy", None, [c_void_p]),
            ("fatt_pool_free_count", c_int32, [c_void_p]),
            ("fatt_pool_acquire", c_int32, [c_void_p, c_int32, c_int32, i32p]),
            ("fatt_pool_release_slot", c_int32, [c_void_p, c_int32]),
            ("fatt_pool_owner", c_int32, [c_void_p, c_int32]),
            ("fatt_pool_transfer", c_int32, [c_void_p, i32p, c_int32, c_int32]),
            ("fatt_pool_release_pages", c_int32, [c_void_p, i32p, c_int32]),
            ("fatt_last_error", c_char_p, []),
            ("fatt_set_error", None, [c_char_p]),
            ("fatt_version", c_char_p, []),
            ("fatt_register_executor", EXECUTOR_FN, [c_int32, EXECUTOR_FN]),
            *((name, c_bool, [call_p]) for name in ENTRY_POINTS)):
        fn = getattr(lib, name)
        fn.restype = res_t
        fn.argtypes = args
    return lib


def _host_view(ptr: int, shape, np_dtype) -> np.ndarray:
    """The caller's host buffer at ``ptr`` as a numpy array (no copy)."""
    n = int(np.prod(shape))
    buf = (ctypes.c_char * (n * np.dtype(np_dtype).itemsize)).from_address(ptr)
    return np.frombuffer(buf, dtype=np_dtype).reshape(shape)


def _read(ptr: int, shape, code: int, device) -> torch.Tensor:
    """A host buffer of dtype ``code`` as a tensor on ``device`` (a copy)."""
    np_dtype, dtype = _DTYPES[code]
    t = torch.from_numpy(_host_view(ptr, shape, np_dtype)).view(dtype)
    return t.to(device, copy=True)


def _write(ptr: int, t: torch.Tensor, code: int) -> None:
    """``t`` into the caller's host buffer of dtype ``code``."""
    np_dtype, dtype = _DTYPES[code]
    host = t.detach().to("cpu", dtype).contiguous()
    _host_view(ptr, tuple(host.shape), np_dtype)[...] = host.view(
        torch.int16 if code == 1 else dtype).numpy()


def _torch_executor(call_ptr, *, varlen: bool, backward: bool, device) -> bool:
    """The registered executor: unpack the C struct, run the port's
    attention on ``device``, write the results into the caller's
    buffers.  Mirrors flash_attn_tpu/runtime/abi.py:_jax_executor."""
    from flash_attn_tpu_torch.ops.attention import flash_attention_varlen, varlen_segments
    from flash_attn_tpu_torch.ops.flash_bwd import flash_bwd
    from flash_attn_tpu_torch.ops.flash_fwd import flash_fwd

    lib = load()
    try:
        c = call_ptr.contents
        code = int(c.dtype)
        if code not in _DTYPES:
            lib.fatt_set_error(b"unsupported dtype for host-buffer path")
            return False
        if code == 0 and device.type == "cuda":
            # no kernel takes fp32; the plain versions do not stand in for one
            lib.fatt_set_error(b"fp32 is not served on the card: K4, K9 and K10 take bf16 "
                               b"(fp16 computes as bf16); pass bf16 or fp16")
            return False
        d = c.head_dim
        scale = c.softmax_scale if c.softmax_scale != 0.0 else None
        if varlen:
            qs = (c.total_q, c.num_heads, d)
            ks = (c.total_k, c.num_heads_k, d)
        else:
            qs = (c.batch, c.seqlen_q, c.num_heads, d)
            ks = (c.batch, c.seqlen_k, c.num_heads_k, d)
        q, k, v = (_read(p, s, code, device) for p, s in ((c.q, qs), (c.k, ks), (c.v, ks)))
        mask = None
        if c.attn_mask:
            dims = tuple(c.mask_dims[i] for i in range(c.mask_ndim))
            mask = _read(c.attn_mask, dims, 0, device)
        drop = dict(dropout_rate=c.dropout_rate, dropout_seed=int(c.dropout_seed))
        if varlen:
            cu_q = torch.from_numpy(np.ctypeslib.as_array(c.cu_seqlens_q, (c.batch + 1,)))
            cu_k = torch.from_numpy(np.ctypeslib.as_array(c.cu_seqlens_k, (c.batch + 1,)))
            cu_q, cu_k = cu_q.to(device, copy=True), cu_k.to(device, copy=True)

        with torch.no_grad():
            if not backward:
                if varlen:
                    # mask over the packed token axes: [total_q, total_k]
                    # or [H, total_q, total_k]
                    out, lse = flash_attention_varlen(
                        q, k, v, cu_q, cu_k, causal=c.is_causal, mask=mask, scale=scale,
                        return_lse=True, **drop)
                    lse_shape = (c.num_heads, c.total_q)
                else:
                    out, lse = flash_fwd(q, k, v, bias=mask, causal=c.is_causal, scale=scale,
                                         **drop)
                    lse_shape = (c.batch, c.num_heads, c.seqlen_q)
                _write(c.out, out, code)
                if c.lse:
                    np.ctypeslib.as_array(c.lse, lse_shape)[...] = lse.float().cpu().numpy()
                return True

            dout = _read(c.dout, qs, code, device)
            out = _read(c.out, qs, code, device)
            if varlen:
                # cu_seqlens -> segment ids and per-sequence causal
                # positions, then the dense backward on a singleton batch
                qseg, kseg, qpos, kpos, causal = varlen_segments(
                    cu_q, cu_k, int(c.total_q), int(c.total_k), bool(c.is_causal))
                lse_in = torch.from_numpy(
                    np.ctypeslib.as_array(c.lse_in, (c.num_heads, c.total_q))).to(
                        device, copy=True)[None]
                if mask is not None:
                    mask = mask[None, None] if mask.ndim == 2 else mask[None]
                dq, dk, dv = flash_bwd(
                    q[None], k[None], v[None], out[None], lse_in, dout[None], bias=mask,
                    q_segment_ids=qseg, kv_segment_ids=kseg, q_positions=qpos,
                    kv_positions=kpos, causal=causal, scale=scale, **drop)
                dq, dk, dv = dq[0], dk[0], dv[0]
            else:
                lse_in = torch.from_numpy(np.ctypeslib.as_array(
                    c.lse_in, (c.batch, c.num_heads, c.seqlen_q))).to(device, copy=True)
                dq, dk, dv = flash_bwd(q, k, v, out, lse_in, dout, bias=mask,
                                       causal=c.is_causal, scale=scale, **drop)
            for ptr, g in ((c.dq, dq), (c.dk, dk), (c.dv, dv)):
                _write(ptr, g, code)
            return True
    except Exception as e:  # noqa: BLE001 - C boundary: no exceptions across
        lib.fatt_set_error(repr(e).encode()[:512])
        return False


def register_torch_executor(device=None) -> ctypes.CDLL:
    """Install the port behind all four C entry points: on the card unless
    ``device="cpu"`` is passed (the plain PyTorch versions of the kernels,
    fp32 included).  Returns the loaded library."""
    from flash_attn_tpu_torch._device import resolve_device

    dev = resolve_device(device)
    lib = load()
    for kind, (varlen, backward) in enumerate(
            [(False, False), (True, False), (False, True), (True, True)]):
        fn = EXECUTOR_FN(lambda ptr, v=varlen, b=backward: _torch_executor(
            ptr, varlen=v, backward=b, device=dev))
        _keepalive.append(fn)
        lib.fatt_register_executor(kind, fn)
    return lib


class PagePool:
    """Python wrapper over the native page allocator."""

    def __init__(self, num_pages: int):
        self._lib = load()
        self._pool = self._lib.fatt_pool_create(num_pages)
        if not self._pool:
            raise ValueError(f"could not create pool with {num_pages} pages")

    def acquire(self, slot: int, n: int) -> list[int] | None:
        """``n`` pages for ``slot``, or None (and nothing taken) if the
        pool has fewer free."""
        out = (c_int32 * n)()
        got = self._lib.fatt_pool_acquire(self._pool, slot, n, out)
        if got < 0:
            return None
        return list(out[:got])

    def release_slot(self, slot: int) -> int:
        return self._lib.fatt_pool_release_slot(self._pool, slot)

    @property
    def free_count(self) -> int:
        return self._lib.fatt_pool_free_count(self._pool)

    def owner(self, page: int) -> int:
        return self._lib.fatt_pool_owner(self._pool, page)

    def transfer(self, pages, new_slot: int) -> int:
        """Move ownership of specific pages to ``new_slot`` (prefix-cache
        donation); returns the number transferred."""
        arr = (c_int32 * len(pages))(*pages)
        return self._lib.fatt_pool_transfer(self._pool, arr, len(pages), new_slot)

    def release_pages(self, pages) -> int:
        """Free specific pages (prefix-cache eviction); idempotent."""
        arr = (c_int32 * len(pages))(*pages)
        return self._lib.fatt_pool_release_pages(self._pool, arr, len(pages))

    def __del__(self):
        if getattr(self, "_pool", None):
            self._lib.fatt_pool_destroy(self._pool)
            self._pool = None

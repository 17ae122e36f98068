"""The port's C ABI (``flash_attn_tpu_torch/runtime/abi.py`` over
``runtime/native/fatt_abi.cc``) against the JAX package's (``libfatpu.so``,
``flash_attn_tpu/runtime/abi.py``) on the CPU.

Both libraries are built, and one filled struct per case (the two layouts
are the same, field for field) goes through JAX's executor and through the
port's (``register_torch_executor(device="cpu")``: the plain versions of
K4, K9 and K10).  The outputs agree within JAX's own ABI tolerances
(tests/test_runtime.py: fp32 2e-4 forward, 5e-4 backward); bf16 and fp16
buffers within their rounding.  Inputs come from numpy seeds.
"""

import ctypes
import threading
import time

import numpy as np
import pytest
import torch

from flash_attn_tpu.runtime import abi as jabi
from flash_attn_tpu_torch.runtime import abi
from _torch_threads import one_torch_thread  # noqa: F401

FWD_TOL, BWD_TOL = 2e-4, 5e-4
# bf16 / fp16 outputs: the two sides round their fp32 results to the
# buffer's type (bf16: 2^-8 relative) after sums in another order
HALF_TOL = {1: 2e-2, 2: 2e-3}
F32P = ctypes.POINTER(ctypes.c_float)
I32P = ctypes.POINTER(ctypes.c_int32)


@pytest.fixture(scope="module")
def libs():
    """(JAX's library with its executor, the port's with its CPU
    executor).  make builds JAX's in place at first use, and another test
    process may be writing it at the same moment, so a failed load is
    retried."""
    for _ in range(10):
        try:
            jabi.load()
            break
        except OSError:
            time.sleep(3)
    return jabi.register_jax_executor(), abi.register_torch_executor(device="cpu")


def _buffers(shape, code, rng):
    """A random host buffer of dtype ``code`` (bf16 as its int16 bits)."""
    x = rng.standard_normal(shape).astype(np.float32)
    if code == 0:
        return x
    if code == 2:
        return x.astype(np.float16)
    return (torch.from_numpy(x).bfloat16().view(torch.int16).numpy())


def _as_float(x, code):
    return torch.from_numpy(x).view(torch.bfloat16).float().numpy() if code == 1 else \
        x.astype(np.float32)


class Case:
    """One call's host buffers and the struct that points at them; run()
    fills a fresh copy of the outputs through one library."""

    def __init__(self, *, varlen, lens=None, B=1, Sq=0, Sk=0, H=4, Hk=2, D=32, code=0,
                 mask_shape=None, causal=True, rate=0.0, seed=0, scale=0.0, seed_rng=0):
        rng = np.random.default_rng(seed_rng)
        self.varlen, self.code = varlen, code
        if varlen:
            self.cu = np.zeros(len(lens) + 1, np.int32)
            self.cu[1:] = np.cumsum(lens)
            total = int(self.cu[-1])
            qs, ks = (total, H, D), (total, Hk, D)
            self.lse_shape = (H, total)
        else:
            qs, ks = (B, Sq, H, D), (B, Sk, Hk, D)
            self.lse_shape = (B, H, Sq)
        self.q, self.k, self.v = (_buffers(s, code, rng) for s in (qs, ks, ks))
        self.dout = _buffers(qs, code, rng)
        self.mask = None
        if mask_shape is not None:
            self.mask = (rng.standard_normal(mask_shape) * 2).astype(np.float32)
            self.mask.reshape(-1)[:: 7] = -np.inf  # dead entries
            self.dims = (ctypes.c_int64 * len(mask_shape))(*mask_shape)
        c = jabi.FatpuAttnCall()
        c.struct_size = ctypes.sizeof(jabi.FatpuAttnCall)
        c.q, c.k, c.v = self.q.ctypes.data, self.k.ctypes.data, self.v.ctypes.data
        c.num_heads, c.num_heads_k, c.head_dim = H, Hk, D
        c.dtype = code
        c.softmax_scale, c.dropout_rate, c.dropout_seed = scale, rate, seed
        c.is_causal = causal
        if self.mask is not None:
            c.attn_mask = self.mask.ctypes.data
            c.mask_dims = self.dims
            c.mask_ndim = len(mask_shape)
        if varlen:
            c.cu_seqlens_q = c.cu_seqlens_k = self.cu.ctypes.data_as(I32P)
            c.batch = len(lens)
            c.total_q = c.total_k = total
            c.seqlen_q = c.seqlen_k = max(lens)
        else:
            c.batch, c.seqlen_q, c.seqlen_k = B, Sq, Sk
        self.call = c

    def run(self, lib, prefix, backward=False, lse_in=None, out_in=None):
        """Outputs of one entry point of ``lib`` (functions named
        ``prefix``_attn_...): (out, lse) forward, (dq, dk, dv) backward."""
        c = self.call
        kind = ("varlen_" if self.varlen else "") + ("bwd" if backward else "fwd")
        fn = getattr(lib, f"{prefix}_attn_{kind}")
        arg = ctypes.byref(c) if prefix == "fatpu" else ctypes.cast(
            ctypes.pointer(c), ctypes.POINTER(abi.FattAttnCall))
        if not backward:
            out, lse = np.zeros_like(self.q), np.zeros(self.lse_shape, np.float32)
            c.out, c.lse = out.ctypes.data, lse.ctypes.data_as(F32P)
            ok = fn(arg)
            last = getattr(lib, f"{prefix}_last_error")()
            assert ok, last
            return out, lse
        grads = [np.zeros_like(x) for x in (self.q, self.k, self.v)]
        c.out, c.dout = out_in.ctypes.data, self.dout.ctypes.data
        c.lse_in = lse_in.ctypes.data_as(F32P)
        c.dq, c.dk, c.dv = (g.ctypes.data for g in grads)
        ok = fn(arg)
        assert ok, getattr(lib, f"{prefix}_last_error")()
        c.dout = c.dq = c.dk = c.dv = None
        return grads


def _close(got, want, code, tol, name):
    got, want = _as_float(got, code), _as_float(want, code)
    tol = tol if code == 0 else HALF_TOL[code]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=name)


def _fwd_bwd(libs, case, backward=True):
    """Forward through both libraries, then (``backward``) the backward
    of both on JAX's forward residuals (out, lse), all held together."""
    jlib, tlib = libs
    jo, jl = case.run(jlib, "fatpu")
    to, tl = case.run(tlib, "fatt")
    _close(to, jo, case.code, FWD_TOL, "out")
    live = jl > -1e29
    np.testing.assert_allclose(tl[live], jl[live], atol=1e-3, rtol=1e-3, err_msg="lse")
    assert (tl[~live] == -1e30).all()
    if not backward:
        return jo
    jg = case.run(jlib, "fatpu", True, jl, jo)
    tg = case.run(tlib, "fatt", True, jl, jo)
    for got, want, name in zip(tg, jg, ("dq", "dk", "dv")):
        _close(got, want, case.code, BWD_TOL, name)
    return jo


def test_struct_layout_is_jax():
    """One filled struct drives either library: same size, same fields at
    the same offsets."""
    assert ctypes.sizeof(abi.FattAttnCall) == ctypes.sizeof(jabi.FatpuAttnCall)
    for (name, _), (jname, _) in zip(abi.FattAttnCall._fields_, jabi.FatpuAttnCall._fields_):
        assert name == jname
        assert getattr(abi.FattAttnCall, name).offset == getattr(jabi.FatpuAttnCall, name).offset


def test_error_subsystem(libs):
    """No executor registered, struct_size too small, a null q, the
    version string, and a last error that is thread-local, as JAX's."""
    jlib, tlib = libs
    case = Case(varlen=False, B=1, Sq=8, Sk=8)
    arg = ctypes.cast(ctypes.pointer(case.call), ctypes.POINTER(abi.FattAttnCall))
    case.call.out = case.q.ctypes.data
    # no executor: unregister kind 0, call, register the port's again
    prev = tlib.fatt_register_executor(0, abi.EXECUTOR_FN())
    try:
        assert not tlib.fatt_attn_fwd(arg)
        assert b"no executor registered" in tlib.fatt_last_error()
        assert b"fatt_register_executor()" in tlib.fatt_last_error()
    finally:
        tlib.fatt_register_executor(0, prev)
    for prefix, lib, a in (("fatpu", jlib, ctypes.byref(case.call)), ("fatt", tlib, arg)):
        last = getattr(lib, f"{prefix}_last_error")
        case.call.struct_size = 8  # too small: header and library disagree
        assert not getattr(lib, f"{prefix}_attn_fwd")(a)
        assert b"struct_size too small" in last()
        case.call.struct_size = ctypes.sizeof(abi.FattAttnCall)
        q = case.call.q
        case.call.q = None
        assert not getattr(lib, f"{prefix}_attn_bwd")(a)
        assert last() == b"null q/k/v pointer"
        case.call.q = q
    assert tlib.fatt_version() == b"fatt-0.1.0"
    assert jlib.fatpu_version() == b"fatpu-0.1.0"  # the same ABI version
    tlib.fatt_set_error(b"set in the main thread")
    seen = []
    t = threading.Thread(target=lambda: seen.append(tlib.fatt_last_error()))
    t.start()
    t.join()
    assert seen == [b""] and tlib.fatt_last_error() == b"set in the main thread"
    tlib.fatt_set_error(b"")


def test_seed_out_of_int32_fails_as_jax(libs):
    """The struct's uint64 seed reaches both executors as an int32; one
    out of its range fails the call on both sides (JAX's OverflowError)."""
    jlib, tlib = libs
    case = Case(varlen=False, B=1, Sq=8, Sk=8, seed=2 ** 31)
    out = np.zeros_like(case.q)
    case.call.out = out.ctypes.data
    assert not jlib.fatpu_attn_fwd(ctypes.byref(case.call))
    assert b"OverflowError" in jlib.fatpu_last_error()
    assert not tlib.fatt_attn_fwd(ctypes.cast(ctypes.pointer(case.call),
                                              ctypes.POINTER(abi.FattAttnCall)))
    assert b"OverflowError" in tlib.fatt_last_error()


def test_fp32_refused_on_the_card(libs):
    """On the card the executor refuses fp32 (no kernel takes it) with a
    message naming it, before it touches the device; on the CPU fp32 runs
    the plain versions (the other tests)."""
    _, tlib = libs
    case = Case(varlen=False, B=1, Sq=8, Sk=8)
    arg = ctypes.cast(ctypes.pointer(case.call), ctypes.POINTER(abi.FattAttnCall))
    assert not abi._torch_executor(arg, varlen=False, backward=False,
                                   device=torch.device("cuda"))
    assert b"fp32" in tlib.fatt_last_error()


@pytest.mark.parametrize("mask_shape", [(2, 1, 40, 56), (40, 56), (1, 4, 40, 56)],
                         ids=["B1SS", "SS", "1HSS"])
def test_dense_fwd_bwd_with_mask_and_dropout(libs, mask_shape):
    """fatt_attn_fwd then fatt_attn_bwd: B=2, Sq=40 < Sk=56 (bottom-right
    causal), GQA 4/2, the mask in three broadcast shapes with dead entries,
    dropout 0.2 from seed 7, fp32."""
    case = Case(varlen=False, B=2, Sq=40, Sk=56, mask_shape=mask_shape, rate=0.2, seed=7,
                seed_rng=1)
    _fwd_bwd(libs, case)


@pytest.mark.parametrize("code", [1, 2], ids=["bf16", "fp16"])
def test_dense_fwd_bwd_half(libs, code):
    """bf16 and fp16 buffers (fp16 computes as bf16 on both sides), causal,
    no mask, dropout 0.1."""
    case = Case(varlen=False, B=1, Sq=48, Sk=48, code=code, rate=0.1, seed=3, seed_rng=2)
    _fwd_bwd(libs, case)


@pytest.mark.parametrize("mask_shape", [(64, 64), (4, 64, 64)], ids=["TT", "HTT"])
def test_varlen_fwd_with_mask(libs, mask_shape):
    """fatt_attn_varlen_fwd over three packed sequences with a mask over
    the packed axes ([total, total] and [H, total, total]), causal."""
    case = Case(varlen=True, lens=[24, 24, 16], mask_shape=mask_shape, scale=0.2, seed_rng=3)
    out = _fwd_bwd(libs, case, backward=False)
    # the mask reached the kernel: without it the outputs differ
    case.call.attn_mask = None
    plain, _ = case.run(libs[1], "fatt")
    assert not np.allclose(out, plain, atol=1e-3)


def test_varlen_bwd_with_dropout(libs):
    """fatt_attn_varlen_fwd then fatt_attn_varlen_bwd with dropout 0.25
    (seed 11) and a [total, total] mask, causal, GQA 4/2."""
    case = Case(varlen=True, lens=[24, 40], mask_shape=(64, 64), rate=0.25, seed=11,
                seed_rng=4)
    _fwd_bwd(libs, case)

"""The port's int4 quantization and quantized matmuls (flash_attn_tpu_torch
ops/quant.py, ops/matmul.py) against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both sides.  The JAX
side runs its Pallas kernels in interpret mode, as its own tests do; the
port runs the plain PyTorch versions of its CUDA kernels (CPU tensors).
Weights are quantized by the JAX package and carried over by the bridge,
so both sides multiply identical integers and scales.  Each tolerance is
stated with its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.ops import matmul as jmm
from flash_attn_tpu.ops import quant as jquant
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.ops import matmul as mm
from flash_attn_tpu_torch.ops import quant as tquant
from _torch_threads import one_torch_thread  # noqa: F401

K, N = 256, 384


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _cpu(tree):
    """The bridge onto the CPU, where these tests run the plain versions."""
    return bridge.params_from_jax(jax.device_get(tree), device="cpu")


def _weights(seed=0, k=K, n=N):
    return np.random.default_rng(seed).standard_normal((k, n)).astype(np.float32) * 0.02


def _x(M, seed=1, k=K, dtype=jnp.bfloat16):
    x = np.random.default_rng(seed).standard_normal((M, k)).astype(np.float32)
    return jnp.asarray(x).astype(dtype)


def _close_bf16(got, want):
    """bf16 outputs: both sides sum the same products in fp32 in another
    order, so they differ by at most the output's bf16 rounding (2^-8
    relative) plus fp32 noise far below it."""
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-3)


# ---------------------------------------------------------------------------
# quantize_int4 and the bridge's planes -> halves relayout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("g", [32, 128])
def test_quantize_int4_bit_exact(g):
    """The clip search's arithmetic (amax * fp32(c / 7), half-to-even
    rounding, strict < between candidates) is the JAX package's, so the
    packed bytes and the scales are equal bit for bit."""
    w = _weights(2)
    j = jquant.quantize_int4(jnp.asarray(w), group_size=g, layout="halves")
    t = tquant.quantize_int4(torch.from_numpy(w), group_size=g)
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(j.packed))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    assert t.packed.dtype == torch.uint8 and t.shape == (K, N) and t.layout == "halves"
    np.testing.assert_array_equal(
        tquant.unpack_int4(t.packed, g).numpy(), np.asarray(jquant.unpack_int4(j.packed, g)))
    np.testing.assert_array_equal(tquant.dequantize_int4(t).numpy(),
                                  np.asarray(jquant.dequantize_int4(j)))


@pytest.mark.parametrize("g", [32, 128])
def test_bridge_int4_planes_become_halves(g):
    """JAX's default layout at g % 128 == 0 is planes; the bridge repacks
    every Int4Weight as halves.  The result equals the JAX halves
    quantization of the same weights, byte for byte."""
    w = jnp.asarray(_weights(3))
    j = jquant.quantize_int4(w, group_size=g)
    assert j.layout == ("planes" if g == 128 else "halves")
    t = _cpu(j)
    want = jquant.quantize_int4(w, group_size=g, layout="halves")
    assert isinstance(t, tquant.Int4Weight) and t.layout == "halves"
    np.testing.assert_array_equal(t.packed.numpy(), np.asarray(want.packed))
    np.testing.assert_array_equal(tquant.dequantize_int4(t).numpy(),
                                  np.asarray(jquant.dequantize_int4(j)))


# ---------------------------------------------------------------------------
# the matmuls, at decode M, at a prompt bucket below 512 (M = 100: not a
# multiple of the kernels' 64- or 128-row blocks) and on the M >= 512 route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [8, 100, 520])
@pytest.mark.parametrize("g", [32, 128])
def test_matmul_int4_matches_jax(M, g):
    jw = jquant.quantize_int4(jnp.asarray(_weights(4)), group_size=g)
    jx = _x(M)
    jo = jmm.matmul_int4(jx, jw, interpret=True)
    to = mm.matmul_int4(bridge.to_torch(jx, "cpu"), _cpu(jw))
    assert to.dtype == torch.bfloat16 and to.shape == (M, N)
    _close_bf16(to, jo)


@pytest.mark.parametrize("M", [8, 100, 520])
def test_matmul_w4a8_matches_jax(M):
    """Below 512 (M = 8, 100) both quantize x per token (IEEE amax / 127 in the port; XLA
    may multiply by 1/127, a 1-ulp scale that can flip one rounding of x),
    then sum exact int8 products; at M = 520 both dequantize and take a
    float dot with no activation quantization."""
    g = 32
    q4 = jquant.quantize_int4(jnp.asarray(_weights(5)), group_size=g, layout="halves")
    jw = jmm.W4A8Weight(q4.packed, q4.scales, g, q4.shape)
    jx = _x(M, seed=6)
    jo = jmm.matmul_w4a8(jx, jw, interpret=True)
    tw = _cpu(jw)
    assert isinstance(tw, mm.W4A8Weight)
    to = mm.matmul_w4a8(bridge.to_torch(jx, "cpu"), tw)
    assert to.dtype == torch.bfloat16 and to.shape == (M, N)
    _close_bf16(to, jo)
    if M >= mm._PREFILL_M:  # the route: exactly the int4 dequant + dot
        np.testing.assert_array_equal(
            _np(to), _np(mm.matmul_int4(bridge.to_torch(jx, "cpu"), _cpu(q4))))


@pytest.mark.parametrize("M", [8, 40])
def test_matmul_w8a8_matches_jax(M):
    """Exact int32 sums on both sides; the activation scales agree to 1
    ulp (see above), so fp32 outputs agree to a few fp32 ulps unless a
    flipped x rounding moves one product by 1/127 of its row's scale."""
    jv, js = jquant.quantize_int8(jnp.asarray(_weights(7)), axes=(0,))
    jx = _x(M, seed=8, dtype=jnp.float32)
    jxq, jsx = jmm.quantize_activations(jx)
    txq, tsx = mm.quantize_activations(bridge.to_torch(jx, "cpu"))
    np.testing.assert_allclose(tsx.numpy(), np.asarray(jsx), rtol=2.4e-7)
    assert (txq.numpy() != np.asarray(jxq)).mean() < 1e-3
    jo = jmm.matmul_w8a8(jx, jv, js[0], interpret=True)
    to = mm.matmul_w8a8(bridge.to_torch(jx, "cpu"), bridge.to_torch(jv, "cpu"),
                        bridge.to_torch(js[0], "cpu"))
    assert to.dtype == torch.float32 and to.shape == (M, N)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5, atol=2e-3 * np.abs(jo).max())
    # the kernel's arithmetic on the same integers is bit-exact
    want = mm.matmul_w8a8_plain(bridge.to_torch(jxq, "cpu"), bridge.to_torch(jsx, "cpu"),
                                bridge.to_torch(jv, "cpu"), bridge.to_torch(js[0], "cpu"),
                                torch.float32)
    exact = (np.asarray(jxq).astype(np.int64) @ np.asarray(jv).astype(np.int64))
    exact = exact.astype(np.float32) * np.asarray(jsx) * np.asarray(js[0])
    np.testing.assert_array_equal(want.numpy(), exact)


@pytest.mark.parametrize("g", [32, 128])
def test_matmul_int8_grouped_matches_jax(g):
    w = jnp.asarray(_weights(9))
    wg = w.reshape(K // g, g, N)
    amax = jnp.max(jnp.abs(wg), axis=1)
    scales = jnp.where(amax > 0, amax / 127.0, 1.0)  # [K//g, N]
    vals = jnp.clip(jnp.round(wg / scales[:, None, :]), -127, 127).astype(jnp.int8).reshape(K, N)
    jx = _x(8, seed=10)
    jo = jmm.matmul_int8(jx, vals, scales, interpret=True)
    tv, ts = bridge.to_torch(vals, "cpu"), bridge.to_torch(scales, "cpu")
    to = mm.matmul_int8(bridge.to_torch(jx, "cpu"), tv, ts)
    assert to.dtype == torch.bfloat16
    _close_bf16(to, jo)
    np.testing.assert_array_equal(_np(mm.quantized_matmul(bridge.to_torch(jx, "cpu"), (tv, ts))),
                                  _np(to))


# ---------------------------------------------------------------------------
# matmul_q.cu's split plan
# ---------------------------------------------------------------------------

# (K, N) of the fused projections (wqkv, wo, w_gate_up, w_down) of
# Llama-3-8B, then of Llama-3-70B
PLAN_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
               (8192, 10240), (8192, 8192), (8192, 57344), (28672, 8192)]


@pytest.mark.parametrize("M", [8, 100, 256])
@pytest.mark.parametrize("K,N", PLAN_SHAPES)
def test_q_plan_whole_tiles_reach_the_target(K, N, M):
    """Every split of K holds whole 128-row tiles (so whole groups of every
    size the kernels take), the splits cover K exactly, and splits x output
    tiles reach the block target of the regime (decode at M <= 16, else a
    prompt bucket), unless K has run out of two-tile splits.  A split
    prompt bucket stays within one wave of the 132 SMs."""
    splits, kps = mm._q_plan(M, K, N)
    assert kps % mm._Q_BK == 0 and all(kps % g == 0 for g in mm._Q_GROUPS)
    assert splits == -(-K // kps) and kps * (splits - 1) < K <= kps * splits
    tiles = -(-M // mm._q_rows(M)) * -(-N // mm._Q_BN)
    target = mm._Q_DECODE_BLOCKS if M <= mm._SMALL_M else mm._Q_PROMPT_BLOCKS
    assert splits * tiles >= target or kps == 2 * mm._Q_BK
    if splits > 1:
        assert kps >= 2 * mm._Q_BK and tiles < target
        if M > mm._SMALL_M:
            assert splits * tiles <= 132


# ---------------------------------------------------------------------------
# concat_weights and the quantized_matmul dispatch over every kind
# ---------------------------------------------------------------------------

KINDS = ["float", "int8", "int8_grouped", "int4", "int4_planes", "w4a8", "w8a8",
         "w8a8_legacy", "biased_int4", "biased_float"]


def _jax_weight(kind, w):
    """A JAX weight of ``kind`` for float weights [K, n]."""
    if kind == "float":
        return w
    if kind in ("int8", "w8a8", "w8a8_legacy"):
        v, s = jquant.quantize_int8(w, axes=(0,))
        return {"int8": (v, s[0]), "w8a8": jmm.W8A8Weight(v, s[0]),
                "w8a8_legacy": ("w8a8", v, s[0])}[kind]
    if kind == "int8_grouped":
        g = 64
        wg = w.reshape(w.shape[0] // g, g, -1)
        s = jnp.maximum(jnp.max(jnp.abs(wg), axis=1), 1e-12) / 127.0
        v = jnp.round(wg / s[:, None, :]).astype(jnp.int8).reshape(w.shape)
        return (v, s)
    if kind == "int4":
        return jquant.quantize_int4(w, group_size=32)
    if kind == "int4_planes":
        return jquant.quantize_int4(w, group_size=128)
    if kind == "w4a8":
        q4 = jquant.quantize_int4(w, group_size=32, layout="halves")
        return jmm.W4A8Weight(q4.packed, q4.scales, 32, q4.shape)
    inner = _jax_weight(kind.split("_", 1)[1], w)
    bias = jnp.asarray(np.random.default_rng(11).standard_normal(w.shape[1]), jnp.float32)
    return jmm.BiasedWeight(inner, bias)


@pytest.mark.parametrize("kind", KINDS)
def test_quantized_matmul_dispatch_matches_jax(kind):
    jw = _jax_weight(kind, jnp.asarray(_weights(12)))
    tw = _cpu(jw)
    jx = _x(8, seed=13)
    jo = jmm.quantized_matmul(jx, jw, interpret=True)
    to = mm.quantized_matmul(bridge.to_torch(jx, "cpu"), tw)
    assert to.dtype == torch.bfloat16 and to.shape == (8, N)
    _close_bf16(to, jo)


@pytest.mark.parametrize("kind", KINDS)
def test_concat_weights_matches_jax(kind):
    """Fusing three same-input weights gives the JAX package's fused weight
    (same integers, scales and bias), and its matmul equals the three
    unfused matmuls side by side."""
    parts = [jnp.asarray(_weights(20 + i, n=n)) for i, n in enumerate((128, 64, 64))]
    jws = [_jax_weight(kind, p) for p in parts]
    jf = jmm.concat_weights(jws)
    tf = mm.concat_weights([_cpu(w) for w in jws])
    want, got = _leaves(_cpu(jf)), _leaves(tf)
    assert type(tf) is type(_cpu(jf)) and len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_np(a), _np(b))
    x = bridge.to_torch(_x(8, seed=14), "cpu")
    fused = mm.quantized_matmul(x, tf)
    split = torch.cat([mm.quantized_matmul(x, _cpu(w)) for w in jws], dim=1)
    if kind in ("w8a8", "w8a8_legacy"):
        # exact int sums, and the fused call quantizes x the same way
        np.testing.assert_array_equal(_np(fused), _np(split))
    else:
        _close_bf16(fused, split)


def _leaves(tree):
    """Tensors of a port weight in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _leaves(x)]
    if isinstance(tree, (tquant.Int4Weight, mm.W4A8Weight)):
        return [tree.packed, tree.scales]
    if isinstance(tree, mm.W8A8Weight):
        return [tree.vals, tree.scales]
    if isinstance(tree, mm.BiasedWeight):
        return _leaves(tree.w) + [tree.bias]
    return []


# ---------------------------------------------------------------------------
# the CUDA wrappers take only what their kernels take
# ---------------------------------------------------------------------------


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper checks its inputs before it builds or launches anything:
    CPU tensors (or a wrong dtype) raise ValueError and launch nothing."""
    x = torch.zeros(8, 128, dtype=torch.bfloat16)
    q4 = tquant.quantize_int4(torch.randn(128, 64), group_size=32)
    xq, sx = mm.quantize_activations(x)
    v8 = torch.zeros(128, 64, dtype=torch.int8)
    s8 = torch.ones(64)
    calls = [
        lambda: mm.matmul_int4_cuda(x, q4.packed, q4.scales, 32, torch.bfloat16),
        lambda: mm.matmul_w4a8_cuda(xq, sx, q4.packed, q4.scales, 32, torch.bfloat16),
        lambda: mm.matmul_w8a8_cuda(xq, sx, v8, s8, torch.float32),
        lambda: mm.matmul_int8_grouped_cuda(x, v8, torch.ones(4, 64), 32, torch.bfloat16),
        lambda: mm.matmul_int8_cuda(x.float(), v8, s8, torch.float32),
        lambda: mm.matmul_int4_cuda(x.half(), q4.packed, q4.scales, 32, torch.float32),
        lambda: mm.matmul_int4_cuda(x, q4.packed, q4.scales, 16, torch.bfloat16),
    ]
    wrappers = (mm.matmul_int4_cuda, mm.matmul_w4a8_cuda, mm.matmul_w8a8_cuda,
                mm.matmul_int8_grouped_cuda, mm.matmul_int8_cuda)
    before = [f.launches for f in wrappers]
    for call in calls:
        with pytest.raises(ValueError):
            call()
    assert [f.launches for f in wrappers] == before

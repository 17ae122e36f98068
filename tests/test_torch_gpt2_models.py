"""GPT-2's model paths in the port against the JAX package, on the CPU,
at head_dim 64 (GPT-2 124M's): ``models/gpt2.py``'s forward,
``prefill_with_kv`` and ``max_attention_logit``, prefill and decode steps
in three KV types, and the verify step, in fp32 and bf16
(tests/test_torch_gpt2.py holds the other paths, the kernels' plain
versions, the HF conversion and the engines).

JAX's params come from its own init and reach the port through
``bridge``; JAX runs its model functions jitted with its Pallas kernels in
interpret mode; the port runs the plain versions of its kernels.  Each
tolerance is stated with its reason.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models import gpt2 as jgpt2
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.models import gpt2
from _torch_threads import one_torch_thread  # noqa: F401

# two layers of two heads of 64: GPT-2 124M's head_dim at a tiny size
_TINY64 = dict(vocab_size=1024, max_position=128, num_layers=2, num_heads=2, hidden=128)
CFG = gpt2.GPT2Config(**_TINY64)
JCFG = jgpt2.GPT2Config(**_TINY64)
# fp32 on both sides: summation order and exp2 against exp, ~1e-6 on O(1)
# attention outputs
F32_TOL = 1e-5
# logits (|logit| < ~1 at these widths): fp32 summation order moves them
# ~1e-6; a flipped int8/fp8 KV rounding by up to ~5e-3 after two layers
LOGIT_TOL = 5e-3
# bf16 on both sides, which round at the same points: fp32 sums in another
# order can flip a bf16 rounding of an activation (2^-8 of it) that two
# layers carry into the logits; the final LayerNorm's bf16 output then
# meets the head in fp32
BF16_LOGIT_TOL = 2e-2


def to_torch(x):
    return bridge.to_torch(x, device="cpu")


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


@functools.lru_cache(maxsize=None)
def _params(dtype):
    """(dtype, JAX params, port params, JAX config, port config): JAX's
    random init at the tiny head_dim-64 config in ``dtype``, and the same
    values carried to the port by ``bridge.params_from_jax``."""
    jp = jgpt2.init_params(dataclasses.replace(JCFG, dtype=dtype), jax.random.PRNGKey(0))
    return (dtype, jp, bridge.params_from_jax(jp, device="cpu"),
            dataclasses.replace(JCFG, dtype=dtype), dataclasses.replace(CFG, dtype=dtype))


@functools.lru_cache(maxsize=None)
def _jitted(fn, jcfg):
    """JAX's model function ``fn`` with ``jcfg`` and interpret mode bound,
    jitted once a module, as the JAX engine runs it (eagerly, interpret
    mode compiles each of its hundreds of small ops apart).  The arguments
    after ``cfg`` go by keyword."""
    return jax.jit(functools.partial(fn, cfg=jcfg, interpret=True))


# the model tests run in both dtypes where a call is cheap, and otherwise
# in one each, so that every path meets fp32 or bf16 and both meet each
DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return LOGIT_TOL if dtype == "float32" else BF16_LOGIT_TOL


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, shape)


# --- models/gpt2.py against flash_attn_tpu/models/gpt2.py -------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_prefill_with_kv_and_probe_match_jax(dtype):
    """forward (online), prefill_with_kv (clamped; every layer's k, v) and
    max_attention_logit on the same tokens."""
    dtype, jp, tp, jcfg, cfg = _params(dtype)
    toks = _tokens(1, (2, 40))
    jl = _jitted(jgpt2.forward, jcfg)(jp, jnp.asarray(toks))
    tl = gpt2.forward(tp, torch.from_numpy(toks), cfg)
    assert tl.shape == (2, 40, CFG.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_tol(dtype))
    pos = np.tile(np.arange(40), (2, 1))
    jl, jkv = _jitted(jgpt2.prefill_with_kv, jcfg)(jp, jnp.asarray(toks), jnp.asarray(pos))
    tl, tkv = gpt2.prefill_with_kv(tp, torch.from_numpy(toks), torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_tol(dtype))
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        assert tk.shape == (2, 40, 2, 64) and tk.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(tk), _np(jk), atol=_tol(dtype))
        np.testing.assert_allclose(_np(tv), _np(jv), atol=_tol(dtype))
    if dtype == "float32":
        want = jgpt2.max_attention_logit(jp, jnp.asarray(toks[:1]), jcfg)
        got = gpt2.max_attention_logit(tp, torch.from_numpy(toks[:1]), cfg)
        assert abs(got - want) <= F32_TOL * max(1.0, abs(want))


@pytest.mark.parametrize("dtype,kv_mode", [("float32", "none"), ("float32", "int8"),
                                           ("bfloat16", "fp8")])
def test_prefill_and_decode_steps_match_jax(dtype, kv_mode):
    """prefill of two prompts into a cache, then two decode steps fed
    JAX's greedy tokens: logits at each step and the cache after."""
    dtype, jp, tp, jcfg, cfg = _params(dtype)
    toks = _tokens(2, (2, 21))
    jc = jgpt2.make_cache(jcfg, 2, 64, mode=kv_mode)
    tc = gpt2.make_cache(cfg, 2, 64, mode=kv_mode, device="cpu")
    jl, jc = _jitted(jgpt2.prefill, jcfg)(jp, jnp.asarray(toks), cache=jc)
    tl, tc = gpt2.prefill(tp, torch.from_numpy(toks), cfg, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_tol(dtype))
    for _ in range(2):
        nxt = jnp.argmax(jl, axis=-1)
        jl, jc = _jitted(jgpt2.decode_step, jcfg)(jp, nxt, cache=jc)
        tl, tc = gpt2.decode_step(tp, to_torch(nxt).long(), cfg, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_tol(dtype))
    want = bridge.kv_cache_from_jax(jc, device="cpu")
    assert tc.length.tolist() == want.length.tolist() == [23, 23]
    if dtype == "float32":
        # a stored int8 or e4m3 value whose input flipped a rounding moves
        # one step (1, or at most 1/8 of it); float values agree to LOGIT_TOL
        for a, b in zip(tc.k + tc.v, want.k + want.v):
            step = LOGIT_TOL if kv_mode == "none" else np.maximum(1.0, np.abs(_np(b)) / 8)
            assert np.all(np.abs(_np(a) - _np(b)) <= step)


@pytest.mark.parametrize("dtype", ["bfloat16"])
def test_decode_multi_matches_jax(dtype):
    """The verify step: T = 5 tokens a sequence after a prefill (one
    sequence at 30 of 64 positions, one at 7), int8 KV."""
    dtype, jp, tp, jcfg, cfg = _params(dtype)
    jc = jgpt2.make_cache(jcfg, 2, 64, mode="int8")
    tc = gpt2.make_cache(cfg, 2, 64, mode="int8", device="cpu")
    for slot, n in enumerate((30, 7)):
        toks = _tokens(3 + slot, (1, n))
        pos = np.arange(n)[None]
        _, jkv = _jitted(jgpt2.prefill_with_kv, jcfg)(jp, jnp.asarray(toks), jnp.asarray(pos))
        _, tkv = gpt2.prefill_with_kv(tp, torch.from_numpy(toks), torch.from_numpy(pos), cfg)
        for layer, ((jk, jv), (tk, tv)) in enumerate(zip(jkv, tkv)):
            jc = jc.insert_at(layer, slot, jk[0], jv[0], 0)
            tc.insert_at(layer, slot, tk[0], tv[0], 0)
        jc, tc = jc.set_length(slot, n), tc.set_length(slot, n)
    toks = _tokens(5, (2, 5))
    jl, jc = _jitted(jgpt2.decode_multi, jcfg)(jp, jnp.asarray(toks), cache=jc)
    tl, tc = gpt2.decode_multi(tp, torch.from_numpy(toks), cfg, tc)
    assert tl.shape == (2, 5, CFG.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_tol(dtype))
    assert tc.length.tolist() == [35, 12]

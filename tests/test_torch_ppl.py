"""The perplexity harness (``utils/ppl.py``) against the JAX package's, on
the CPU: ``decode_nll`` and ``kv_ppl_delta`` with the cache in the model's
dtype, int8 and fp8 on GPT2_TINY, and ``forward_nll`` on GPT-2 and on
LLAMA_TINY with float, int8 and int4 weights.

JAX's params are made by its own init (and quantized by its own
``quantize_weights``) and carried to the port by ``bridge``; the tokens
come from numpy seeds.  JAX runs its Pallas kernels in interpret mode,
its prefill and decode step under ``jax.jit`` so that each cache mode
compiles once; the port runs the plain versions of its kernels.
"""

import functools
import types

import jax
import numpy as np
import pytest
import torch

from flash_attn_tpu.models import gpt2 as jgpt2
from flash_attn_tpu.models import llama as jllama
from flash_attn_tpu.utils import ppl as jppl
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.models import gpt2, llama
from flash_attn_tpu_torch.utils import ppl
from _torch_threads import one_torch_thread  # noqa: F401

# nll in nats a token, fp32 on both sides.  The float cache: summation
# order only (measured 6e-8 on 6.93).  int8 and fp8: a value whose input
# differs by fp32 rounding can quantize one code apart (measured 5.8e-6
# with fp8 on 6.93).  Forward: summation order through two layers and
# the head (measured 4.8e-7); the int4 and int8 matmuls dequantize the
# same codes and scales on both sides.
NLL_TOL = {"none": 1e-5, "int8": 1e-4, "fp8": 1e-4}
FWD_TOL = 1e-5
# BASELINE's perplexity delta at the same KV bit width: the bound of
# tests/test_hf_parity.py:test_kv_ppl_delta_harness
PPL_BOUND = 0.05


@functools.lru_cache(maxsize=None)
def _gpt2():
    jp = jgpt2.init_params(jgpt2.GPT2_TINY, jax.random.PRNGKey(0))
    return jp, bridge.params_from_jax(jax.device_get(jp), device="cpu")


# JAX's prefill and decode step compiled once a cache mode (the harness
# calls them as module functions with ``interpret``)
_JMODULE = types.SimpleNamespace(
    make_cache=jgpt2.make_cache,
    prefill=jax.jit(jgpt2.prefill, static_argnums=(2,), static_argnames=("interpret",)),
    decode_step=jax.jit(jgpt2.decode_step, static_argnums=(2,), static_argnames=("interpret",)))


def _prompt_and_continuation(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, gpt2.GPT2_TINY.vocab_size, 16),
            rng.integers(0, gpt2.GPT2_TINY.vocab_size, 8))


def test_kv_ppl_delta_matches_jax():
    """kv_ppl_delta at modes none, int8 and fp8 (a prompt of 16, a
    continuation of 8): each mode's nll against JAX's within NLL_TOL, its
    ppl e^nll and its delta against the float cache's, within the 5 %
    bound."""
    jp, tp = _gpt2()
    prompt, cont = _prompt_and_continuation(5)
    want = jppl.kv_ppl_delta(jp, jgpt2.GPT2_TINY, prompt, cont, interpret=True, module=_JMODULE)
    got = ppl.kv_ppl_delta(tp, gpt2.GPT2_TINY, prompt, cont)
    assert list(got) == ["none", "int8", "fp8"]
    base = got["none"]["ppl"]
    for mode, res in got.items():
        assert abs(res["nll"] - want[mode]["nll"]) < NLL_TOL[mode], mode
        assert res["ppl"] == pytest.approx(np.exp(res["nll"]), rel=1e-12)
        assert res["delta_ppl"] == pytest.approx(res["ppl"] - base, abs=1e-9)
        assert abs(res["delta_ppl"]) / base < PPL_BOUND, mode


@pytest.mark.parametrize("kv_mode", ["none", "int8", "fp8"])
def test_decode_nll_matches_jax(kv_mode):
    """decode_nll alone, another prompt and continuation, against JAX's."""
    jp, tp = _gpt2()
    prompt, cont = _prompt_and_continuation(6)
    want = jppl.decode_nll(jp, jgpt2.GPT2_TINY, prompt, cont, kv_mode=kv_mode, interpret=True,
                           module=_JMODULE)
    got = ppl.decode_nll(tp, gpt2.GPT2_TINY, prompt, cont, kv_mode=kv_mode)
    assert abs(got - want) < NLL_TOL[kv_mode]


def test_forward_nll_gpt2_matches_jax():
    """forward_nll with the default forward (GPT-2) on 32 tokens."""
    jp, tp = _gpt2()
    toks = np.random.default_rng(7).integers(0, gpt2.GPT2_TINY.vocab_size, 32)
    want = jppl.forward_nll(jp, jgpt2.GPT2_TINY, toks, interpret=True)
    got = ppl.forward_nll(tp, gpt2.GPT2_TINY, toks)
    assert abs(got - want) < FWD_TOL


@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_forward_nll_llama_quantized_matches_jax(mode):
    """forward_nll through Llama's forward at LLAMA_TINY with float, int8
    and int4 (group 32) weights, JAX's quantized params carried over by
    the bridge: each against JAX's, and the quantized ones within the
    bound of tests/test_hf_parity.py:test_weight_quant_ppl_delta (8 %)
    of the float nll."""
    cfg = jllama.LLAMA_TINY
    jp = jllama.init_params(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(6).integers(1, cfg.vocab_size, 32)
    jfwd = lambda p, t: jllama.forward(p, t, cfg, interpret=True)  # noqa: E731
    tfwd = lambda p, t: llama.forward(p, t, llama.LLAMA_TINY)  # noqa: E731
    jq = jp if mode is None else jllama.quantize_weights(jp, mode=mode, group_size=32)
    tq = bridge.params_from_jax(jax.device_get(jq), device="cpu")
    want = jppl.forward_nll(jq, cfg, toks, forward_fn=jfwd)
    got = ppl.forward_nll(tq, llama.LLAMA_TINY, toks, forward_fn=tfwd)
    assert abs(got - want) < FWD_TOL
    if mode is not None:
        base = ppl.forward_nll(bridge.params_from_jax(jax.device_get(jp), device="cpu"),
                               llama.LLAMA_TINY, toks, forward_fn=tfwd)
        assert abs(got - base) / base < 0.08

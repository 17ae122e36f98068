"""The port's continuous-batching engine against the JAX engine at
LLAMA_TINY with int8 weights, plus the port's package rules, on the CPU.

Greedy tokens must equal the JAX engine's token for token.  Both engines
run their default paths: the prompts admitted in one step (two or more,
within the capacity) go through one packed prefill, the others one per
call.
"""

import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.engine.engine import InferenceEngine as JEngine
from flash_attn_tpu.models import llama as jllama
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.engine.engine import InferenceEngine
from flash_attn_tpu_torch.engine.sampler import SamplingParams, sample
from flash_attn_tpu_torch.engine.scheduler import (
    ContinuousBatchingScheduler,
    bucket_length,
)
from flash_attn_tpu_torch.models import llama
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CFG = llama.LLAMA_TINY
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [300, 2, 41], list(range(40, 75)), [9]]
MAX_TOKENS = [6, 4, 5, 7]


def params_from_jax(tree):
    """The bridge onto the CPU, where these tests run the plain versions."""
    return bridge.params_from_jax(jax.device_get(tree), device="cpu")


def kv_cache_from_jax(cache):
    return bridge.kv_cache_from_jax(jax.device_get(cache), device="cpu")


@pytest.fixture(scope="module")
def both_params():
    jp = jllama.quantize_weights(jllama.init_params(jllama.LLAMA_TINY, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp)


@pytest.mark.parametrize("kv_mode", ["int8", "fp8", "none"])
def test_engine_greedy_tokens_equal_jax(both_params, kv_mode):
    """Four requests through two slots (slot reuse, idle slots decoding
    alongside): every generated token equals the JAX engine's."""
    jp, tp = both_params
    jadapter = jllama.make_adapter(jllama.LLAMA_TINY, interpret=True)
    jeng = JEngine(jp, jadapter, max_batch=2, capacity=64, kv_mode=kv_mode,
                   cache_dtype=jnp.float32)
    teng = InferenceEngine(tp, llama.make_adapter(CFG), max_batch=2, capacity=64,
                           kv_mode=kv_mode, cache_dtype=torch.float32, device="cpu")
    jreqs = [jeng.submit(p, max_tokens=n) for p, n in zip(PROMPTS, MAX_TOKENS)]
    treqs = [teng.submit(p, max_tokens=n) for p, n in zip(PROMPTS, MAX_TOKENS)]
    jeng.run()
    teng.run()
    for jr, tr, n in zip(jreqs, treqs, MAX_TOKENS):
        assert tr.done and len(tr.generated) == n
        assert tr.generated == jr.generated
    assert teng.metrics.completed_requests == len(PROMPTS)
    assert teng.metrics.decode_tokens == jeng.metrics.decode_tokens
    # the first admission (two prompts, two slots) took the packed prefill
    assert teng.packed_prefills >= 1


@pytest.mark.parametrize("mode", ["int4", "w4a8"])
def test_engine_greedy_tokens_equal_jax_int4_w8a8_head(mode):
    """The quantized serving modes at LLAMA_TINY: int4 (g = 128, packed as
    planes by JAX and repacked by the bridge) or W4A8 (g = 32) layers, a
    W8A8 head, fused projections and fp8 KV.  Every greedy token equals
    the JAX engine's."""
    g = 128 if mode == "int4" else 32
    jp = jllama.fuse_projections(jllama.quantize_weights(
        jllama.init_params(jllama.LLAMA_TINY, jax.random.PRNGKey(0)), mode,
        group_size=g, skip=("tok_emb",), head_mode="w8a8"))
    tp = params_from_jax(jp)
    assert "wqkv" in tp["blocks"][0] and type(tp["lm_head"]).__name__ == "W8A8Weight"
    jadapter = jllama.make_adapter(jllama.LLAMA_TINY, interpret=True)
    jeng = JEngine(jp, jadapter, max_batch=2, capacity=64, kv_mode="fp8",
                   cache_dtype=jnp.float32)
    teng = InferenceEngine(tp, llama.make_adapter(CFG), max_batch=2, capacity=64,
                           kv_mode="fp8", cache_dtype=torch.float32, device="cpu")
    jreqs = [jeng.submit(p, max_tokens=n) for p, n in zip(PROMPTS, MAX_TOKENS)]
    treqs = [teng.submit(p, max_tokens=n) for p, n in zip(PROMPTS, MAX_TOKENS)]
    jeng.run()
    teng.run()
    for jr, tr, n in zip(jreqs, treqs, MAX_TOKENS):
        assert tr.done and len(tr.generated) == n
        assert tr.generated == jr.generated
    assert teng.packed_prefills >= 1


def test_engine_matches_direct_greedy_decode(both_params):
    """One request through the engine equals prefill + decode_step by hand."""
    _, tp = both_params
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    eng = InferenceEngine(tp, llama.make_adapter(CFG), max_batch=1, capacity=32,
                          kv_mode="int8", cache_dtype=torch.float32, device="cpu")
    req = eng.submit(prompt, max_tokens=5)
    eng.run()
    toks = torch.tensor([prompt + [0] * (32 - len(prompt))])
    logits, kvs = llama.prefill_with_kv(tp, toks, torch.arange(32)[None], CFG)
    cache = llama.make_cache(CFG, 1, 32, mode="int8", device="cpu")
    for i, (k, v) in enumerate(kvs):
        cache.insert_prompt(i, 0, k[0], v[0])
    cache.set_length(0, len(prompt))
    want = [int(logits[0, len(prompt) - 1].argmax())]
    for _ in range(4):
        step_logits, cache = llama.decode_step(tp, torch.tensor(want[-1:]), CFG, cache)
        want.append(int(step_logits[0].argmax()))
    assert req.generated == want


@pytest.mark.parametrize("kv_mode", ["int8", "fp8", "none"])
def test_kv_cache_append_matches_jax(kv_mode):
    """A multi-token append (plain quantize), then a one-token append (K2's
    plain version), each followed by advance: the port's cache equals the
    JAX cache carried over by the bridge."""
    from flash_attn_tpu.engine.kv_cache import KVCache as JKVCache
    from flash_attn_tpu_torch.engine.kv_cache import KVCache

    L, B, S, Hk, D = 2, 2, 32, 2, 16
    r = np.random.default_rng(3)
    jc = JKVCache.create(L, B, S, Hk, D, dtype=jnp.float32, mode=kv_mode)
    tc = KVCache.create(L, B, S, Hk, D, dtype=torch.float32, mode=kv_mode, device="cpu")
    for t in (5, 1):
        for layer in range(L):
            k = r.standard_normal((B, t, Hk, D)).astype(np.float32)
            v = r.standard_normal((B, t, Hk, D)).astype(np.float32)
            jc = jc.append(layer, jnp.asarray(k), jnp.asarray(v))
            tc = tc.append(layer, torch.from_numpy(k), torch.from_numpy(v))
        jc, tc = jc.advance(t), tc.advance(t)
    got = kv_cache_from_jax(jc)
    np.testing.assert_array_equal(tc.length.numpy(), got.length.numpy())
    for layer in range(L):
        for mine, theirs in ((tc.k, got.k), (tc.v, got.v)):
            # identical quantization arithmetic on identical fp32 inputs
            np.testing.assert_array_equal(mine[layer].float().numpy(),
                                          theirs[layer].float().numpy())
        if kv_mode != "none":
            # XLA may turn amax / qmax into amax * (1 / qmax): 1 ulp on a scale
            np.testing.assert_allclose(tc.k_scale[layer].numpy(),
                                       got.k_scale[layer].numpy(), rtol=2.4e-7)
            np.testing.assert_allclose(tc.v_scale[layer].numpy(),
                                       got.v_scale[layer].numpy(), rtol=2.4e-7)


def test_engine_rejects_unported_options(both_params):
    """A mesh whose ranks sit on more than one device is still to port (the
    single-device mesh is ported: tests/test_torch_sharded.py); a LoRA bank
    is ported and, as in JAX, refused for an adapter without the LoRA
    paths."""
    from flash_attn_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    _, tp = both_params
    adapter = llama.make_adapter(CFG)
    across = make_mesh(MeshConfig(sp=2), ["cpu", "cuda:0"])
    with pytest.raises(NotImplementedError):
        InferenceEngine(tp, adapter, max_batch=1, capacity=32, device="cpu", mesh=across)
    with pytest.raises(ValueError, match="lora_bank needs the adapter's lora paths"):
        InferenceEngine(tp, dataclasses.replace(adapter, decode_step_lora=None), max_batch=1,
                        capacity=32, device="cpu", lora_bank=object())


def test_scheduler_slot_lifecycle_and_buckets():
    s = ContinuousBatchingScheduler(max_batch=2)
    r1, r2, r3 = s.submit([1, 2], 4), s.submit([3], 4), s.submit([4], 2)
    assert [r.uid for r in s.admit()] == [r1.uid, r2.uid]
    assert r3.slot is None and s.waiting
    s.complete(r1)
    assert s.admit() == [r3] and r3.slot == 0
    assert [bucket_length(n) for n in (1, 32, 33, 1000, 9000)] == [32, 32, 64, 1024, 16384]


def test_sampler_greedy_and_stochastic():
    logits = torch.tensor([[0.0, 3.0, 1.0], [5.0, -1.0, 0.0]])
    assert sample(logits, None, SamplingParams()).tolist() == [1, 0]
    gen = torch.Generator().manual_seed(0)
    toks = sample(logits, gen, SamplingParams(temperature=1.0, top_k=1))
    assert toks.tolist() == [1, 0]  # top-1 leaves one choice
    toks = sample(logits.repeat(50, 1), gen, SamplingParams(temperature=1.0, top_p=0.5))
    assert set(toks.tolist()) <= {0, 1}


def _port_sources():
    files = sorted((ROOT / "flash_attn_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither jax nor the JAX package,
    and the host library's loader builds the port's own C++ copies (the C
    ABI shim and the page allocator), not the JAX package's sources or its
    built library."""
    files = _port_sources()
    assert len(files) > 10 and (ROOT / "chip_smoke.py").exists()
    names = {p.relative_to(ROOT).as_posix() for p in files}
    for module in ("engine/paged.py", "engine/prefix_cache.py", "ops/paged_decode.py",
                   "runtime/abi.py", "ops/flash_bwd.py", "utils/train.py",
                   "utils/profiling.py", "engine/_graph.py"):
        assert f"flash_attn_tpu_torch/{module}" in names
    from flash_attn_tpu_torch.runtime import abi

    native = ROOT / "flash_attn_tpu_torch/runtime/native"
    assert abi._SRCS == [native / "fatt_abi.cc", native / "page_allocator.cc"]
    assert all(p.exists() for p in abi._SRCS + abi._HDRS)
    loader = (ROOT / "flash_attn_tpu_torch/runtime/abi.py").read_text()
    assert "libfatpu" not in loader and '_NATIVE / "page_allocator.cc"' in loader
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "flash_attn_tpu"):
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {name}")
    assert not bad, bad

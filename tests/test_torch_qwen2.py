"""Qwen-2's shape in the port's Llama model against the JAX package, on
the CPU.

Qwen-2-7B differs from the Llama configs where nothing else in the tests
reaches: a bias on the q/k/v projections (``qkv_bias``: wq/wk/wv are
``BiasedWeight``s) and 7 query heads per KV head (28 / 4), where every
attention kernel had run only at 1, 2, 4 or 8.  A tiny config keeps both
(7 heads of 32 over 1 KV head, q_dim 224 against hidden 128) and goes
through every serving path and both engines on both sides.  The sliding
window and the logit softcap, which no default config sets, are held on
every path; ``convert_hf_model``
is held against HF ``Qwen2ForCausalLM`` and ``LlamaForCausalLM`` built
from config and against JAX's conversion.

Inputs are made with numpy from a seed and handed to both sides; the
params go through the bridge.  JAX runs its Pallas kernels in interpret
mode; the port runs the plain versions of its kernels.  The model is fp32
on both sides, so the two differ only in the order of fp32 sums.
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
from flash_attn_tpu.engine.engine import PagedInferenceEngine as JPagedEngine
from flash_attn_tpu.engine.engine import SpecConfig as JSpecConfig
from flash_attn_tpu.engine.paged import PagedKVPool as JPool
from flash_attn_tpu.models import llama as jllama
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.engine.engine import (
    InferenceEngine,
    PagedInferenceEngine,
    SpecConfig,
)
from flash_attn_tpu_torch.engine.paged import PagedKVPool
from flash_attn_tpu_torch.models import llama
from flash_attn_tpu_torch.ops.matmul import BiasedWeight
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
QTINY = dict(vocab_size=512, hidden=128, intermediate=256, num_layers=2, num_heads=7,
             num_kv_heads=1, head_dim=32, max_position=256, rope_theta=10000.0,
             dtype="float32", qkv_bias=True)
CFG = llama.LlamaConfig(**QTINY)
JCFG = jllama.LlamaConfig(**QTINY)
# fp32 on both sides: summation order moves O(1) logits by ~1e-6, and a
# quantized KV value rounded to its neighbouring code by that order moves
# them by up to ~1e-3 (tests/test_torch_llama.py's bound)
LOGIT_TOL = 2e-3
F32_TOL = 1e-4
PROMPTS = [[5, 6, 7, 8, 9, 10, 11], [300, 2, 41], list(range(40, 75)), [9]]
MAX_TOKENS = [6, 4, 5, 7]


def _bridge(tree):
    return bridge.params_from_jax(jax.device_get(tree), device="cpu")


def _np(t):
    return t.detach().float().numpy()


def _jit(fn, cfg):
    """A JAX model function with ``cfg`` and interpret mode bound, jitted
    (interpret mode runs ~3x faster traced whole than eagerly).  The
    decode steps take ``cfg`` before their cache or pool, the prefills
    last."""
    if fn.__name__.startswith("decode"):
        return jax.jit(lambda p, t, c: fn(p, t, cfg, c, interpret=True))
    return jax.jit(lambda p, *args: fn(p, *args, cfg, interpret=True))


@pytest.fixture(scope="module")
def params():
    """{"float" | "int8": (JAX params, the port's)}: the int8 tree is
    quantized by each package from the same float weights."""
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    jq = jllama.quantize_weights(jp)
    return {"float": (jp, _bridge(jp)), "int8": (jq, llama.quantize_weights(_bridge(jp)))}


def test_config_fields_and_qwen2_7b_equal_jax():
    """The port's LlamaConfig has JAX's fields with JAX's defaults, and
    QWEN2_7B, LLAMA3_8B and LLAMA3_70B equal JAX's field by field."""
    assert list(llama.LlamaConfig.__dataclass_fields__) == list(
        jllama.LlamaConfig.__dataclass_fields__)
    for name in ("QWEN2_7B", "LLAMA3_8B", "LLAMA3_70B", "LLAMA_TINY"):
        mine, theirs = getattr(llama, name), getattr(jllama, name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), name
    q = llama.QWEN2_7B
    assert q.qkv_bias and q.num_heads // q.num_kv_heads == 7
    assert (q.sliding_window, q.attn_logit_softcap) == (None, None)


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _leaves(getattr(tree, f.name))]
    return []


@pytest.mark.parametrize("mode", ["int8", "w4a8"])
def test_quantize_and_fuse_keep_the_bias_float(params, mode):
    """Quantizing wraps the quantized weight in a BiasedWeight whose bias
    stays float, bit for bit the JAX package's tree (fused too); the
    fused model gives the unfused one's logits."""
    jp, tp = params["float"]
    g = 32
    jq = jllama.fuse_projections(jllama.quantize_weights(jp, mode, group_size=g))
    tq = llama.quantize_weights(tp, mode, group_size=g)
    wq = tq["blocks"][0]["wq"]
    assert isinstance(wq, BiasedWeight) and wq.bias.dtype == torch.float32
    torch.testing.assert_close(wq.bias, tp["blocks"][0]["wq"].bias, rtol=0, atol=0)
    fused = llama.fuse_projections(tq)
    wqkv = fused["blocks"][0]["wqkv"]
    assert isinstance(wqkv, BiasedWeight) and wqkv.bias.shape == (CFG.num_heads * 32 + 64,)
    mine, theirs = _leaves(fused), _leaves(_bridge(jq))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and torch.equal(a, b)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (1, 12))).long()
    pos = torch.arange(12)[None]
    a, _ = llama.prefill_with_kv(tq, toks, pos, CFG)
    b, _ = llama.prefill_with_kv(fused, toks, pos, CFG)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_init_params_draws_a_bias_and_quantizes_on_the_fly():
    """init_params with qkv_bias draws a [N] bias for wq/wk/wv (none for
    wo) and, with ``quantize``, equals quantize_weights of the float draw."""
    a = llama.init_params(CFG, seed=3, device="cpu")
    blk = a["blocks"][0]
    assert [isinstance(blk[n], BiasedWeight) for n in ("wq", "wk", "wv", "wo")] == [
        True, True, True, False]
    assert blk["wk"].bias.shape == (32,) and float(blk["wk"].bias.abs().max()) > 0
    b = llama.init_params(CFG, seed=3, device="cpu", quantize="int8", fuse=True)
    want = llama.fuse_projections(llama.quantize_weights(a))
    mine, theirs = _leaves(b), _leaves(want)
    assert len(mine) == len(theirs)
    for x, y in zip(mine, theirs):
        assert torch.equal(x, y)


def _packed(rng, lens, total):
    toks, seg, pos = (np.zeros((1, total), np.int32) for _ in range(3))
    off = 0
    for i, n in enumerate(lens):
        toks[0, off:off + n] = rng.integers(0, CFG.vocab_size, n)
        seg[0, off:off + n] = i + 1
        pos[0, off:off + n] = np.arange(n)
        off += n
    return toks, pos, seg, off


@pytest.mark.parametrize("weights", ["float", "int8"])
def test_prefills_match_jax(params, weights):
    """prefill_with_kv (24 tokens) and prefill_packed (three prompts in a
    [1, 32] row): logits and every layer's K/V equal JAX's."""
    jp, tp = params[weights]
    rng = np.random.default_rng(2)
    toks = rng.integers(0, CFG.vocab_size, (1, 24)).astype(np.int32)
    pos = np.arange(24, dtype=np.int32)[None]
    jl, jkv = _jit(jllama.prefill_with_kv, JCFG)(jp, jnp.asarray(toks), jnp.asarray(pos))
    tl, tkv = llama.prefill_with_kv(tp, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                                    CFG)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=F32_TOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(_np(tk), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=1e-5)
    toks, pos, seg, n = _packed(rng, (10, 7, 9), 32)
    jl, jkv = _jit(jllama.prefill_packed, JCFG)(jp, jnp.asarray(toks), jnp.asarray(pos),
                                                jnp.asarray(seg))
    tl, tkv = llama.prefill_packed(tp, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                                   torch.from_numpy(seg), CFG)
    np.testing.assert_allclose(_np(tl)[:, :n], np.asarray(jl)[:, :n], atol=F32_TOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(_np(tk), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=1e-5)


# (weights, KV mode): both weight kinds and every KV mode
CACHE_CASES = [("float", "none"), ("int8", "int8"), ("int8", "fp8")]


@pytest.mark.parametrize("weights,kv_mode", CACHE_CASES)
def test_cached_paths_match_jax(params, weights, kv_mode):
    """Into a 2-slot, 64-position cache: prefill_chunk of a 40-token prompt
    into slot 1 in chunks of 16, then two decode_step calls for both slots,
    then decode_multi of 3 tokens: every real logit equals JAX's within
    LOGIT_TOL, and the lengths agree."""
    jp, tp = params[weights]
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, CFG.vocab_size, 40)
    jcache = jllama.make_cache(JCFG, 2, 64, mode=kv_mode)
    tcache = llama.make_cache(CFG, 2, 64, mode=kv_mode, device="cpu")
    jchunk = jax.jit(lambda p, t, c, start: jllama.prefill_chunk(
        p, t, JCFG, c, 1, start, interpret=True))
    for start in range(0, 40, 16):
        chunk = prompt[start:start + 16]
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(chunk)] = chunk
        jl, jcache = jchunk(jp, jnp.asarray(toks), jcache, jnp.int32(start))
        tl, tcache = llama.prefill_chunk(tp, torch.from_numpy(toks).long(), CFG, tcache, 1,
                                         start)
        m = len(chunk)
        np.testing.assert_allclose(_np(tl)[:, :m], np.asarray(jl)[:, :m], atol=LOGIT_TOL)
    jcache = jcache.set_length(1, 40)
    tcache.set_length(1, 40)
    jstep = _jit(jllama.decode_step, JCFG)
    for step in rng.integers(0, CFG.vocab_size, (2, 2)).astype(np.int32):
        jl, jcache = jstep(jp, jnp.asarray(step), jcache)
        tl, tcache = llama.decode_step(tp, torch.from_numpy(step).long(), CFG, tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
    toks = rng.integers(0, CFG.vocab_size, (2, 3)).astype(np.int32)
    jl, jcache = _jit(jllama.decode_multi, JCFG)(jp, jnp.asarray(toks), jcache)
    tl, tcache = llama.decode_multi(tp, torch.from_numpy(toks).long(), CFG, tcache)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))


def test_paged_paths_match_jax(params):
    """int8 weights, fp8 KV: a 16-token prompt's K/V (the port's prefill,
    handed to both pools) in slot 0 of a pool of pages of 8, then
    prefill_suffix_paged of 12 tokens from 16, then two decode_step_paged
    steps for both slots: logits equal JAX's."""
    kv_mode = "fp8"
    jp, tp = params["int8"]
    B, mp, page = 2, 8, 8
    jpool = JPool.create(CFG.num_layers, 24, page, B, mp, CFG.num_kv_heads, CFG.head_dim,
                         dtype=jnp.float32, mode=kv_mode)
    rng = np.random.default_rng(4)
    order = rng.permutation(np.arange(1, 24))
    for b in range(B):
        jpool = jpool.assign_pages(b, order[b * mp:(b + 1) * mp].tolist())
    prompt = rng.integers(0, CFG.vocab_size, (1, 16))
    _, kvs = llama.prefill_with_kv(tp, torch.from_numpy(prompt), torch.arange(16)[None], CFG)
    for layer, (k, v) in enumerate(kvs):
        jpool = jpool.append_prefill(layer, 0, jnp.asarray(_np(k[0])), jnp.asarray(_np(v[0])), 0)
    jpool = jpool.set_lengths([16, 3])
    tpool = bridge.paged_pool_from_jax(jax.device_get(jpool), device="cpu")
    suffix = rng.integers(0, CFG.vocab_size, (1, 12)).astype(np.int32)
    jl, jpool = jax.jit(lambda p, t, pool: jllama.prefill_suffix_paged(
        p, t, JCFG, pool, 0, 16, interpret=True, sub_chunk=16))(jp, jnp.asarray(suffix), jpool)
    tl, tpool = llama.prefill_suffix_paged(tp, torch.from_numpy(suffix).long(), CFG, tpool, 0,
                                           16, sub_chunk=16)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
    jpool, tpool = jpool.set_lengths([28, 3]), tpool.set_lengths([28, 3])
    jdec = _jit(jllama.decode_step_paged, JCFG)
    toks = np.array([int(np.asarray(jl)[0, -1].argmax()), 5], np.int32)
    for _ in range(2):
        jl, jpool = jdec(jp, jnp.asarray(toks), jpool)
        tl, tpool = llama.decode_step_paged(tp, torch.from_numpy(toks).long(), CFG, tpool)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
        toks = np.asarray(jl).argmax(-1).astype(np.int32)


def _run(engine, requests):
    reqs = [engine.submit(p, max_tokens=n) for p, n in requests]
    engine.run()
    assert all(r.done and len(r.generated) == n for r, (_, n) in zip(reqs, requests))
    return [list(r.generated) for r in reqs]


# (engine kind, KV mode, engine kwargs)
ENGINE_CASES = {
    "packed": ("contiguous", "int8", {}),
    "chunked": ("contiguous", "fp8", {"prefill_chunk_size": 16}),
    "n-gram": ("contiguous", "none", {"spec": "ngram"}),
    "paged-prefix": ("paged", "int8", {"prefix_cache": True, "num_pages": 17}),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_tokens_equal_jax(params, case):
    """Both engines at int8 weights, two slots: packed prefill (the
    default), chunks of 16, n-gram speculation (K = 3) and the paged
    engine with a prefix cache (a second wave that hits the first wave's
    prefix): every greedy token equals the JAX engine's."""
    kind, kv_mode, kw = ENGINE_CASES[case]
    jp, tp = params["int8"]
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("spec") == "ngram":
        jkw["spec"], tkw["spec"] = JSpecConfig(num_draft=3, ngram=2), SpecConfig(num_draft=3,
                                                                               ngram=2)
    jadapter = jllama.make_adapter(JCFG, interpret=True)
    if kind == "paged":
        jeng = JPagedEngine(jp, jadapter, max_batch=2, capacity=64, page_size=8,
                            kv_mode=kv_mode, cache_dtype=jnp.float32, **jkw)
        teng = PagedInferenceEngine(tp, llama.make_adapter(CFG), max_batch=2, capacity=64,
                                    page_size=8, kv_mode=kv_mode, cache_dtype=torch.float32,
                                    device="cpu", **tkw)
        shared = list(range(1, 17))
        waves = [[(shared + [21, 22, 23], 4), (list(range(60, 80)), 3)],
                 [(shared + [41, 42], 4), (shared + [7] * 9, 3)]]
    else:
        jeng = JEngine(jp, jadapter, max_batch=2, capacity=64, kv_mode=kv_mode,
                       cache_dtype=jnp.float32, **jkw)
        teng = InferenceEngine(tp, llama.make_adapter(CFG), max_batch=2, capacity=64,
                               kv_mode=kv_mode, cache_dtype=torch.float32, device="cpu", **tkw)
        waves = [list(zip(PROMPTS, MAX_TOKENS))]
    for wave in waves:
        assert _run(teng, wave) == _run(jeng, wave)
    if case == "packed":
        assert teng.packed_prefills >= 1
    if case == "n-gram":
        assert teng.metrics.spec_steps == jeng.metrics.spec_steps > 0
    if case == "paged-prefix":
        assert (teng.prefix.hits, teng.prefix.misses) == (jeng.prefix.hits, jeng.prefix.misses)
        assert teng.prefix.hits > 0


# a window shorter than the 24-token prompt, and a cap below the scores
# of this init (|s| up to ~0.1), so that each option moves the logits
LOCAL = dict(sliding_window=8, attn_logit_softcap=0.02)


def test_window_and_softcap_match_jax(params):
    """Both options at once: forward, prefill_with_kv and three decode
    steps past the window (fp8 KV: the softcap's online mode) against
    JAX; each option alone moves the port's logits."""
    cfg, jcfg = dataclasses.replace(CFG, **LOCAL), dataclasses.replace(JCFG, **LOCAL)
    jp, tp = params["int8"]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, CFG.vocab_size, (1, 24)).astype(np.int32)
    pos = np.arange(24, dtype=np.int32)[None]
    jf = _jit(jllama.forward, jcfg)(jp, jnp.asarray(toks))
    tf = llama.forward(tp, torch.from_numpy(toks).long(), cfg)
    np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=F32_TOL)
    for name in LOCAL:
        other = llama.forward(tp, torch.from_numpy(toks).long(),
                              dataclasses.replace(cfg, **{name: None}))
        assert float((tf - other).abs().max()) > 1e-3, name
    jl, jkv = _jit(jllama.prefill_with_kv, jcfg)(jp, jnp.asarray(toks), jnp.asarray(pos))
    tl, _ = llama.prefill_with_kv(tp, torch.from_numpy(toks).long(), torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=F32_TOL)
    jcache = jllama.make_cache(jcfg, 1, 64, mode="fp8")
    for i, (k, v) in enumerate(jkv):
        jcache = jcache.append(i, k, v)
    jcache = jcache.advance(24)
    tcache = bridge.kv_cache_from_jax(jax.device_get(jcache), device="cpu")
    jstep = _jit(jllama.decode_step, jcfg)
    for tok in rng.integers(0, CFG.vocab_size, (3, 1)).astype(np.int32):
        jl, jcache = jstep(jp, jnp.asarray(tok), jcache)
        tl, tcache = llama.decode_step(tp, torch.from_numpy(tok).long(), cfg, tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)


def _local_pairs(tp, cfg, path):
    """(got, want) logits of ``path`` with the option and of a path that
    honors it already (held against JAX above and in
    tests/test_torch_window_paths.py), on a 12-token prompt past the
    window of 8: the chunked, packed and suffix prefills against
    ``prefill_with_kv``, the verify step against two decode steps, the
    paged decode step against the contiguous one."""
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, CFG.vocab_size, (1, 12)))
    pos = torch.arange(12)[None]
    want, kvs = llama.prefill_with_kv(tp, toks, pos, cfg)
    if path == "prefill_chunk":
        cache = llama.make_cache(cfg, 1, 16, device="cpu")
        return llama.prefill_chunk(tp, toks, cfg, cache, 0, 0)[0], want
    if path == "prefill_packed":
        row = torch.cat([toks, toks[:, :4]], dim=1)
        seg = torch.tensor([[1] * 12 + [2] * 4])
        rpos = torch.cat([pos, pos[:, :4]], dim=1)
        return llama.prefill_packed(tp, row, rpos, seg, cfg)[0][:, :12], want
    if path == "prefill_suffix_paged":
        ppool = PagedKVPool.create(cfg.num_layers, 5, 4, 1, 4, cfg.num_kv_heads, cfg.head_dim,
                                   dtype=torch.float32, device="cpu")
        ppool.assign_pages(0, [1, 2, 3, 4])
        return llama.prefill_suffix_paged(tp, toks, cfg, ppool, 0, 0)[0], want
    caches = [llama.make_cache(cfg, 1, 16, device="cpu") for _ in range(2)]
    for cache in caches:
        for i, (k, v) in enumerate(kvs):
            cache.append(i, k, v)
        cache.advance(12)
    cache = caches[0]
    two = torch.tensor([[int(want[0, -1].argmax()), 7]])
    if path == "decode_multi":
        got = llama.decode_multi(tp, two, cfg, caches[1])[0]
        steps = [llama.decode_step(tp, two[:, i], cfg, cache)[0] for i in range(2)]
        return got, torch.stack(steps, dim=1)
    ppool = PagedKVPool.create(cfg.num_layers, 5, 4, 1, 4, cfg.num_kv_heads, cfg.head_dim,
                               dtype=torch.float32, device="cpu")
    ppool.assign_pages(0, [1, 2, 3, 4])
    for i, (k, v) in enumerate(kvs):
        ppool.append_prefill(i, 0, k[0], v[0], 0)
    ppool.set_lengths([12])
    got = llama.decode_step_paged(tp, two[:, 0], cfg, ppool)[0]
    return got, llama.decode_step(tp, two[:, 0], cfg, cache)[0]


@pytest.mark.parametrize("option", ["sliding_window", "attn_logit_softcap"])
@pytest.mark.parametrize("path", ["prefill_chunk", "prefill_suffix_paged", "prefill_packed",
                                  "decode_multi", "decode_step_paged"])
def test_window_and_softcap_refused_on_other_paths(params, option, path):
    """The packed, chunked, verify and paged paths, which refused either
    option before their kernels took it, now honor it: each gives the
    logits of a path that honors it already, on a prompt past the window
    (fp32, F32_TOL: the two differ in the order of fp32 sums)."""
    _, tp = params["float"]
    cfg = dataclasses.replace(CFG, **{option: LOCAL[option]})
    got, want = _local_pairs(tp, cfg, path)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL)


def _hf_model(kind, tied=False):
    """A HF model built from config with random weights from the seed."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(11)
    common = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                  num_hidden_layers=2, num_attention_heads=7 if kind == "qwen2" else 4,
                  num_key_value_heads=1 if kind == "qwen2" else 2,
                  max_position_embeddings=128, rope_theta=10000.0, rms_norm_eps=1e-6,
                  tie_word_embeddings=tied)
    if kind == "qwen2":
        # head_dim 128 / 7 is not whole: widen hidden to 7 x 32
        common.update(hidden_size=224)
        model = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(**common))
    else:
        model = transformers.LlamaForCausalLM(transformers.LlamaConfig(**common))
    return model.eval()


@pytest.mark.parametrize("kind,tied", [("qwen2", False), ("llama", False), ("llama", True)])
def test_convert_hf_model_matches_hf_and_jax(kind, tied):
    """convert_hf_model of a HF Qwen2ForCausalLM (qkv bias, G = 7) or
    LlamaForCausalLM (tied head or not) built from config: the config and
    every param equal JAX's conversion of the same model; the port's
    logits equal HF's (fp32 on both: 2e-4 on logits of ~1) and its greedy
    tokens equal HF's token for token."""
    model = _hf_model(kind, tied)
    params, cfg = llama.convert_hf_model(model, dtype="float32", device="cpu")
    assert cfg.qkv_bias == (kind == "qwen2") and cfg.tie_embeddings == tied
    assert isinstance(params["blocks"][0]["wq"], BiasedWeight) == (kind == "qwen2")
    jparams, jcfg = jllama.convert_hf_model(model, dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    mine, theirs = _leaves(params), _leaves(_bridge(jparams))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert torch.equal(a, b)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (1, 16))).long()
    with torch.no_grad():
        want = model(toks).logits
    got, _ = llama.prefill_with_kv(params, toks, torch.arange(16)[None], cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)
    # greedy: 6 tokens by the port's cache against HF's full forward
    cache = llama.make_cache(cfg, 1, 32, device="cpu")
    logits, kvs = llama.prefill_with_kv(params, toks, torch.arange(16)[None], cfg)
    for i, (k, v) in enumerate(kvs):
        cache.insert_prompt(i, 0, k[0], v[0])
    cache.set_length(0, 16)
    seq, mine = toks, [int(logits[0, -1].argmax())]
    for _ in range(5):
        step, cache = llama.decode_step(params, torch.tensor(mine[-1:]), cfg, cache)
        mine.append(int(step[0].argmax()))
    with torch.no_grad():
        for _ in range(6):
            nxt = model(seq).logits[0, -1].argmax()
            seq = torch.cat([seq, nxt.view(1, 1)], dim=1)
    assert mine == seq[0, 16:].tolist()


def test_converters_import_no_transformers():
    """convert_hf_model reads the model it is given: only load_hf imports
    transformers (lazily), in models/llama.py and models/mixtral.py."""
    for name in ("llama", "mixtral"):
        tree = ast.parse((ROOT / f"flash_attn_tpu_torch/models/{name}.py").read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            imports = [n for n in ast.walk(fn) if isinstance(n, (ast.Import, ast.ImportFrom))]
            names = [getattr(n, "module", None) or n.names[0].name for n in imports]
            if fn.name != "load_hf":
                assert not any((m or "").startswith("transformers") for m in names), (name,
                                                                                       fn.name)
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        assert not any("transformers" in (getattr(n, "module", None) or n.names[0].name)
                       for n in top)

"""Speculative decoding in the port against the JAX package, on the CPU:
``flash_decode`` on a BSHD cache (the JAX API's default layout, JAX's
``_decode_kernel``), ``flash_decode_chunk`` (K1's chunk mode), the
multi-token ``KVCache.append`` past the capacity, ``llama.decode_multi``
and the engine's n-gram and draft-model speculation.

Inputs are made with numpy from a seed and handed to both sides.  JAX runs
its Pallas kernels in interpret mode; the port runs the plain versions of
its kernels.  Both engines run their default paths (the prompts admitted
in one step go through one packed prefill; a draft cache is filled one
prompt per call).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.engine.engine import InferenceEngine as JEngine
from flash_attn_tpu.engine.engine import SpecConfig as JSpecConfig
from flash_attn_tpu.engine.kv_cache import KVCache as JKVCache
from flash_attn_tpu.models import llama as jllama
from flash_attn_tpu.ops import quant as jquant
from flash_attn_tpu.ops.decode import flash_decode as j_flash_decode
from flash_attn_tpu.ops.decode import flash_decode_chunk as j_flash_decode_chunk
from flash_attn_tpu_torch import bridge, flash_decode, flash_decode_chunk
from flash_attn_tpu_torch.engine.engine import InferenceEngine, SpecConfig, _ngram_draft
from flash_attn_tpu_torch.engine.kv_cache import KVCache
from flash_attn_tpu_torch.models import llama
from _torch_threads import one_torch_thread  # noqa: F401

CFG = llama.LLAMA_TINY
# bf16 outputs: one bf16 rounding of a value of size ~1 is 2^-8 ~ 4e-3;
# the two sides also round p (or p * v_scale) to bf16 relative to different
# running maxima, so allow a few roundings
BF16_TOL = 2e-2
# fp32 q: both sides compute in fp32 and differ by summation order
F32_TOL = 1e-5
# logits are O(0.1) at this init; fp32 summation order moves them ~1e-6,
# a flipped int8/fp8 KV rounding by up to ~1e-3
LOGIT_TOL = 2e-3
DTYPES = {"bf16": jnp.bfloat16, "fp16": jnp.float16, "fp32": jnp.float32}


def to_torch(x):
    return None if x is None else bridge.to_torch(x, device="cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _cache(kv, layout, seed, B=2, S=256, Hk=2, D=64):
    """(k, v, k_scale, v_scale) as JAX arrays in ``layout``; scales shaped
    like the cache with a trailing 1, as JAX's quantize_kv makes them."""
    r = np.random.default_rng(seed)
    shape = (B, S, Hk, D) if layout == "bshd" else (B, Hk, S, D)
    k = jnp.asarray(r.standard_normal(shape), jnp.float32)
    v = jnp.asarray(r.standard_normal(shape), jnp.float32)
    if kv in DTYPES:
        return k.astype(DTYPES[kv]), v.astype(DTYPES[kv]), None, None
    kq, ks, vq, vs = jquant.quantize_kv(k, v, kv)
    return kq, vq, ks, vs


@pytest.mark.parametrize("kv,qdt", [("fp32", "fp32"), ("bf16", "bf16"), ("fp16", "fp16"),
                                    ("int8", "fp32"), ("int8", "bf16"), ("fp8", "bf16")])
def test_flash_decode_bshd_default_matches_jax(kv, qdt):
    """flash_decode(q, k, v) with a [B, S, Hk, D] cache and NO kv_layout
    reads it as BSHD, as the JAX API does: against JAX's default-layout
    flash_decode, which runs its BSHD kernel _decode_kernel (GQA 4:1,
    kv_length, [B, S, Hk, 1] scales, online softmax for fp8 on both
    sides)."""
    k, v, ks, vs = _cache(kv, "bshd", seed=1)
    q = jnp.asarray(np.random.default_rng(2).standard_normal((2, 8, 64)), DTYPES[qdt])
    kv_length = np.array([200, 37], np.int32)
    jo, jl = j_flash_decode(q, k, v, k_scale=ks, v_scale=vs, kv_length=jnp.asarray(kv_length),
                            return_lse=True, interpret=True)
    to, tl = flash_decode(to_torch(q), to_torch(k), to_torch(v), k_scale=to_torch(ks),
                          v_scale=to_torch(vs), kv_length=torch.from_numpy(kv_length),
                          return_lse=True)
    assert to.shape == (2, 8, 64) and to.dtype == to_torch(q).dtype
    tol = F32_TOL if qdt == "fp32" else BF16_TOL
    np.testing.assert_allclose(_np(to), _np(to_torch(jo)), atol=tol, rtol=tol)
    # lse sums fp32 p on both sides from the same fp32 scores
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


def test_flash_decode_bshd_broadcast_scales_and_explicit_layout():
    """Per-sequence scales [B, 1, 1, 1] broadcast over S and Hk, and an
    explicit kv_layout="bshd", give JAX's result; asking for clamped
    softmax on BSHD still runs online, as in JAX."""
    k, v, _, _ = _cache("bf16", "bshd", seed=3)
    kq = jnp.clip(jnp.round(k.astype(jnp.float32) * 20), -127, 127).astype(jnp.int8)
    vq = jnp.clip(jnp.round(v.astype(jnp.float32) * 20), -127, 127).astype(jnp.int8)
    s = jnp.asarray([[[[0.05]]], [[[0.04]]]], jnp.float32)
    q = jnp.asarray(np.random.default_rng(4).standard_normal((2, 8, 64)), jnp.float32)
    jo = j_flash_decode(q, kq, vq, k_scale=s, v_scale=s, interpret=True)
    to = flash_decode(to_torch(q), to_torch(kq), to_torch(vq), k_scale=to_torch(s),
                      v_scale=to_torch(s), kv_layout="bshd", softmax_mode="clamped")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("T,G", [pytest.param(1, 4, id="1"), pytest.param(3, 4, id="3"),
                                 pytest.param(5, 8, id="5-G8")])
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("softmax_mode", ["online", "clamped"])
def test_flash_decode_chunk_matches_jax(T, G, kv, softmax_mode):
    """The chunk path (K1c's plain version, split-KV on) against JAX's
    flash_decode_chunk on a BHSD cache: T tokens per sequence, GQA G:1
    (G = 8 at T = 5: the 70B verify step's 40 rows per KV head), lengths
    including the chunk.  The logits stay below 27 natural units, so fp8's
    clamped ceiling (80 in JAX's interpret mode, 40 in the port) never
    bites."""
    k, v, ks, vs = _cache(kv, "bhsd", seed=5)
    q = jnp.asarray(np.random.default_rng(6).standard_normal((2, T, 2 * G, 64)), jnp.bfloat16)
    kv_length = np.array([200, 37], np.int32)
    jo, jl = j_flash_decode_chunk(q, k, v, k_scale=ks, v_scale=vs,
                                  kv_length=jnp.asarray(kv_length), softmax_mode=softmax_mode,
                                  return_lse=True, interpret=True)
    sc = lambda s: None if s is None else to_torch(s)[..., 0].contiguous()  # noqa: E731
    to, tl = flash_decode_chunk(to_torch(q), to_torch(k), to_torch(v), k_scale=sc(ks),
                                v_scale=sc(vs), kv_length=torch.from_numpy(kv_length),
                                softmax_mode=softmax_mode, return_lse=True)
    assert to.shape == (2, T, 2 * G, 64) and tl.shape == (2, T, 2 * G)
    np.testing.assert_allclose(_np(to), _np(to_torch(jo)), atol=BF16_TOL, rtol=BF16_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("T,H", [pytest.param(3, 8, id="chunk"),
                                 pytest.param(1, 32, id="decode-G16")])
def test_flash_decode_chunk_splits_agree(T, H):
    """The chunk kernel's split rule (K1c's plain version): each split takes
    ceil(n / nsplit) of a sequence's n live tiles, so 1, 3 and 7 splits
    partition the same keys, also for a sequence far below the capacity
    (9 of 256: one live tile, six empty splits) and for a decode call with
    16 heads per KV head (K1c's too).  fp32 q and an int8 cache compute in
    fp32 throughout, so the merged results differ only by summation order."""
    k, v, ks, vs = (to_torch(x) for x in _cache("int8", "bhsd", seed=11))
    ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    q = torch.from_numpy(np.random.default_rng(12).standard_normal((2, T, H, 64))).float()
    lens = torch.tensor([200, 9], dtype=torch.int32)

    def run(n):
        if T == 1:
            return flash_decode(q[:, 0], k, v, k_scale=ks, v_scale=vs, kv_length=lens,
                                num_splits=n, return_lse=True, kv_layout="bhsd")
        return flash_decode_chunk(q, k, v, k_scale=ks, v_scale=vs, kv_length=lens,
                                  num_splits=n, return_lse=True)

    want, want_lse = run(1)
    for n in (3, 7):
        got, got_lse = run(n)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-6, rtol=1e-6)


def test_flash_decode_chunk_bshd_matches_jax():
    """A BSHD chunk (JAX's jnp oracle; the port's plain version, online)."""
    k, v, ks, vs = _cache("int8", "bshd", seed=7)
    q = jnp.asarray(np.random.default_rng(8).standard_normal((2, 3, 8, 64)), jnp.float32)
    kv_length = jnp.asarray([100, 3], jnp.int32)
    jo = j_flash_decode_chunk(q, k, v, k_scale=ks, v_scale=vs, kv_length=kv_length,
                              kv_layout="bshd", interpret=True)
    to = flash_decode_chunk(to_torch(q), to_torch(k), to_torch(v), k_scale=to_torch(ks),
                            v_scale=to_torch(vs), kv_length=to_torch(kv_length),
                            kv_layout="bshd")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=F32_TOL, rtol=F32_TOL)


def test_flash_decode_chunk_is_t_decode_steps():
    """Row t of a chunk equals a one-token decode at length
    kv_length - (T - 1) + t: the per-row causal limit."""
    k, v, ks, vs = (to_torch(x) for x in _cache("fp8", "bhsd", seed=9))
    ks, vs = ks[..., 0].contiguous(), vs[..., 0].contiguous()
    q = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 4, 8, 64))).bfloat16()
    lens = torch.tensor([90, 4], dtype=torch.int32)
    got = flash_decode_chunk(q, k, v, k_scale=ks, v_scale=vs, kv_length=lens, num_splits=1)
    for t in range(4):
        want = flash_decode(q[:, t].contiguous(), k, v, k_scale=ks, v_scale=vs,
                            kv_length=lens - 3 + t, kv_layout="bhsd", num_splits=1)
        torch.testing.assert_close(got[:, t], want, atol=0, rtol=0)


@pytest.mark.parametrize("mode", ["none", "int8", "fp8"])
def test_kv_cache_multi_append_past_capacity_matches_jax(mode):
    """A T = 3 append with one slot at capacity - 1, one inside and one
    past the capacity: values land at the start clamped to capacity - T
    and scales at their own positions, dropped past the end, as JAX's
    append writes them; the buffers equal JAX's."""
    L, B, S, Hk, D, T = 1, 3, 32, 2, 16, 3
    r = np.random.default_rng(11)
    jc = JKVCache.create(L, B, S, Hk, D, dtype=jnp.float32, mode=mode)
    for i in range(B):  # fill the last 8 positions, so scales there are not 1
        jc = jc.set_length(i, S - 8)
    k0 = r.standard_normal((B, 8, Hk, D)).astype(np.float32)
    jc = jc.append(0, jnp.asarray(k0), jnp.asarray(k0 * 2))
    tc = bridge.kv_cache_from_jax(jax.device_get(jc), device="cpu")
    lens = np.array([S - 1, 5, S + 2], np.int32)
    for i, n in enumerate(lens):
        jc, tc = jc.set_length(i, int(n)), tc.set_length(i, int(n))
    k = r.standard_normal((B, T, Hk, D)).astype(np.float32)
    v = r.standard_normal((B, T, Hk, D)).astype(np.float32)
    jc = jc.append(0, jnp.asarray(k), jnp.asarray(v))
    tc.append(0, torch.from_numpy(k), torch.from_numpy(v))
    got = bridge.kv_cache_from_jax(jax.device_get(jc), device="cpu")
    for mine, theirs in ((tc.k[0], got.k[0]), (tc.v[0], got.v[0])):
        np.testing.assert_array_equal(_np(mine), _np(theirs))
    if mode != "none":
        # XLA may turn amax / qmax into amax * (1 / qmax): 1 ulp on a scale
        for mine, theirs in ((tc.k_scale[0], got.k_scale[0]), (tc.v_scale[0], got.v_scale[0])):
            np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=2.4e-7)


@pytest.fixture(scope="module")
def int8_params():
    jp = jllama.quantize_weights(jllama.init_params(jllama.LLAMA_TINY, jax.random.PRNGKey(0)))
    return jp, bridge.params_from_jax(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("kv_mode", ["none", "int8", "fp8"])
def test_decode_multi_matches_jax(int8_params, kv_mode):
    """Three verify steps of T = 3 from different lengths, with a rollback
    of one slot after each (as the engine rolls back after acceptance):
    logits and lengths equal JAX's decode_multi."""
    jp, tp = int8_params
    jcache = jllama.make_cache(jllama.LLAMA_TINY, 2, 64, mode=kv_mode).set_length(0, 5)
    tcache = llama.make_cache(CFG, 2, 64, mode=kv_mode, device="cpu").set_length(0, 5)
    jmulti = jax.jit(lambda p, t, c: jllama.decode_multi(p, t, jllama.LLAMA_TINY, c,
                                                         interpret=True))
    r = np.random.default_rng(12)
    for _ in range(3):
        toks = r.integers(0, CFG.vocab_size, (2, 3)).astype(np.int32)
        jl, jcache = jmulti(jp, jnp.asarray(toks), jcache)
        tl, tcache = llama.decode_multi(tp, torch.from_numpy(toks).long(), CFG, tcache)
        assert tl.shape == (2, 3, CFG.vocab_size) and tl.dtype == torch.float32
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
        np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))
        jcache = jcache.set_length(1, int(jcache.length[1]) - 2)
        tcache.set_length(1, int(tcache.length[1]) - 2)


def test_ngram_draft():
    assert _ngram_draft([1, 2, 3, 1, 2], 2, 3) == [3, 1, 2]
    assert _ngram_draft([1, 2, 3, 4, 1, 2], 2, 4) == [3, 4, 1, 2]
    assert _ngram_draft([5, 6, 5, 6], 2, 3) == [5, 6, 6]
    assert _ngram_draft([7, 8, 9], 2, 2) == [9, 9]


# --- the engine ---------------------------------------------------------

PROMPT = [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]  # repetitive: n-gram lookup finds drafts


@pytest.fixture(scope="module")
def tiny():
    """LLAMA_TINY fp32 params (as tests/test_engine.py's spec tests use
    them) and a smaller draft over the same vocabulary, both sides."""
    jp = jllama.init_params(jllama.LLAMA_TINY, jax.random.PRNGKey(0))
    dcfg = dataclasses.replace(CFG, hidden=64, intermediate=128, num_layers=1,
                               num_heads=2, num_kv_heads=1)
    jdcfg = dataclasses.replace(jllama.LLAMA_TINY, hidden=64, intermediate=128, num_layers=1,
                                num_heads=2, num_kv_heads=1)
    jdp = jllama.init_params(jdcfg, jax.random.PRNGKey(99))
    conv = lambda t: bridge.params_from_jax(jax.device_get(t), device="cpu")  # noqa: E731
    return {"jax": (jp, jdp, jdcfg), "torch": (conv(jp), conv(jdp), dcfg)}


def _jax_adapter(cfg):
    return jllama.make_adapter(cfg, interpret=True)


def _run(engine, requests):
    reqs = [engine.submit(p, max_tokens=n) for p, n in requests]
    engine.run()
    assert all(r.done and len(r.generated) == n for r, (_, n) in zip(reqs, requests))
    return [list(r.generated) for r in reqs], engine.metrics


def _engines(tiny, spec_kind, K, **kw):
    """(JAX engine, port engine) with n-gram (``spec_kind`` "ngram"),
    self-draft ("self"), small-draft ("small") or no speculation (None)."""
    jp, jdp, jdcfg = tiny["jax"]
    tp, tdp, tdcfg = tiny["torch"]
    jspec = tspec = None
    if spec_kind == "ngram":
        jspec, tspec = JSpecConfig(num_draft=K, ngram=2), SpecConfig(num_draft=K, ngram=2)
    elif spec_kind == "self":
        jspec = JSpecConfig(num_draft=K, draft_params=jp, draft_adapter=_jax_adapter(jllama.LLAMA_TINY))
        tspec = SpecConfig(num_draft=K, draft_params=tp, draft_adapter=llama.make_adapter(CFG))
    elif spec_kind == "small":
        jspec = JSpecConfig(num_draft=K, draft_params=jdp, draft_adapter=_jax_adapter(jdcfg))
        tspec = SpecConfig(num_draft=K, draft_params=tdp, draft_adapter=llama.make_adapter(tdcfg))
    jeng = JEngine(jp, _jax_adapter(jllama.LLAMA_TINY), max_batch=2, capacity=64,
                   cache_dtype=jnp.float32, spec=jspec, **kw)
    teng = InferenceEngine(tp, llama.make_adapter(CFG), max_batch=2, capacity=64,
                           cache_dtype=torch.float32, spec=tspec, device="cpu", **kw)
    return jeng, teng


@pytest.mark.parametrize("spec_kind", ["ngram", "self", "small"])
def test_engine_spec_tokens_equal_jax(tiny, spec_kind):
    """n-gram, self-draft and small-draft speculation (K = 3, two slots):
    every greedy token, the verify steps and the emitted tokens equal the
    JAX engine's; a self-draft accepts every draft."""
    K = 3
    requests = [(PROMPT, 8), ([9, 10, 11], 6)]
    jeng, teng = _engines(tiny, spec_kind, K)
    jtoks, jm = _run(jeng, requests)
    ttoks, tm = _run(teng, requests)
    assert ttoks == jtoks
    assert teng.packed_prefills == 1  # both prompts in one packed prefill
    assert tm.spec_steps > 0 and tm.spec_steps == jm.spec_steps
    assert tm.spec_emitted == jm.spec_emitted and tm.decode_tokens == jm.decode_tokens
    if spec_kind == "self":
        assert tm.spec_emitted == tm.spec_steps * (K + 1)
    if teng.draft_cache is not None:
        assert torch.equal(teng.draft_cache.length, teng.cache.length)


def test_engine_draft_spec_survives_headroom_fallback(tiny):
    """A 58-token prompt in a 64-token cache forces plain-decode rounds
    (verify needs K + 1 = 4 of headroom) while the other slot keeps room
    and speculates again after it completes.  The tokens equal the JAX
    PLAIN engine's, and the self-draft keeps full acceptance in every
    verify round, resumed ones included: the draft cache stayed in
    lockstep through the fallback rounds."""
    K = 3
    requests = [([(i % 11) + 1 for i in range(58)], 6), ([9, 10, 11, 12, 13, 14], 24)]
    jeng, _ = _engines(tiny, None, K)
    _, teng = _engines(tiny, "self", K)
    verify_rounds = []
    multi = teng.adapter.decode_multi
    teng.adapter = dataclasses.replace(
        teng.adapter, decode_multi=lambda *a: verify_rounds.append(1) or multi(*a))
    jtoks, _ = _run(jeng, requests)
    ttoks, tm = _run(teng, requests)
    assert ttoks == jtoks
    assert tm.spec_steps > 0
    assert tm.spec_emitted == tm.spec_steps * (K + 1), (tm.spec_emitted, tm.spec_steps)
    assert tm.steps > len(verify_rounds) > 0  # plain rounds happened, then verify resumed
    assert torch.equal(teng.draft_cache.length, teng.cache.length)


def test_engine_spec_constructor_errors(tiny):
    """The JAX engine's checks: a target without decode_multi, a draft
    adapter without prefill or decode, and draft speculation with a mesh
    or chunked prefill all raise ValueError."""
    tp, _, _ = tiny["torch"]
    adapter = llama.make_adapter(CFG)
    kw = dict(max_batch=1, capacity=32, device="cpu")
    with pytest.raises(ValueError, match="decode_multi"):
        InferenceEngine(tp, dataclasses.replace(adapter, decode_multi=None),
                        spec=SpecConfig(), **kw)
    for bad in (dataclasses.replace(adapter, prefill_with_kv=None),
                dataclasses.replace(adapter, decode_step=None)):
        with pytest.raises(ValueError, match="draft adapter"):
            InferenceEngine(tp, adapter, spec=SpecConfig(draft_params=tp, draft_adapter=bad), **kw)
    draft = SpecConfig(draft_params=tp, draft_adapter=adapter)
    with pytest.raises(ValueError, match="sharded"):
        InferenceEngine(tp, adapter, spec=draft, mesh=object(), **kw)
    with pytest.raises(ValueError, match="chunked prefill"):
        InferenceEngine(tp, adapter, spec=draft, prefill_chunk_size=16, **kw)

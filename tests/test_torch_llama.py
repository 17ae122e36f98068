"""The port's Llama model and JAX->torch bridge against the JAX package at
LLAMA_TINY with int8 weights, on the CPU.

Both sides hold the same weights: the JAX params are quantized by the
JAX package and carried over by flash_attn_tpu_torch.bridge.  JAX runs its
Pallas kernels in interpret mode; the port runs its plain versions.
LLAMA_TINY is an fp32 model, so the two sides differ only by summation
order (and, for quantized KV, by a rare one-step rounding flip of a
cached value that order caused).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.engine.kv_cache import KVCache as JKVCache
from flash_attn_tpu.models import llama as jllama
from flash_attn_tpu.ops.decode import flash_decode as j_flash_decode
from flash_attn_tpu.ops.quant import quantize_kv as j_quantize_kv
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.models import llama
from flash_attn_tpu_torch.ops.decode import flash_decode
from _torch_threads import one_torch_thread  # noqa: F401

CFG = llama.LLAMA_TINY
# logits are O(0.1) at this init; fp32 summation order moves them ~1e-6,
# a flipped int8/fp8 KV rounding by up to ~1e-3
LOGIT_TOL = 2e-3


def params_from_jax(tree):
    """The bridge onto the CPU, where these tests run the plain versions."""
    return bridge.params_from_jax(jax.device_get(tree), device="cpu")


def kv_cache_from_jax(cache):
    return bridge.kv_cache_from_jax(jax.device_get(cache), device="cpu")


@pytest.fixture(scope="module")
def both_params():
    assert jllama.LLAMA_TINY == jllama.LlamaConfig(**{
        f: getattr(CFG, f) for f in CFG.__dataclass_fields__})
    jp = jllama.quantize_weights(jllama.init_params(jllama.LLAMA_TINY, jax.random.PRNGKey(0)))
    return jp, params_from_jax(jp)


def test_bridge_params_keep_int8_tuples(both_params):
    jp, tp = both_params
    wq = tp["blocks"][0]["wq"]
    assert isinstance(wq, tuple) and wq[0].dtype == torch.int8
    assert wq[1].shape == (CFG.num_heads * CFG.head_dim,)
    np.testing.assert_array_equal(wq[0].numpy(), np.asarray(jp["blocks"][0]["wq"][0]))
    assert tp["lm_head"].dtype == torch.float32  # head stays float


def test_quantize_weights_matches_jax():
    jp = jllama.init_params(jllama.LLAMA_TINY, jax.random.PRNGKey(1))
    jq = jllama.quantize_weights(jp)
    tq = llama.quantize_weights(params_from_jax(jp))
    for name in ("wq", "w_down"):
        np.testing.assert_array_equal(tq["blocks"][1][name][0].numpy(),
                                      np.asarray(jq["blocks"][1][name][0]))
        np.testing.assert_array_equal(tq["blocks"][1][name][1].numpy(),
                                      np.asarray(jq["blocks"][1][name][1]))


def test_prefill_with_kv_matches_jax(both_params):
    jp, tp = both_params
    toks = np.random.default_rng(0).integers(0, CFG.vocab_size, (1, 24)).astype(np.int32)
    pos = np.arange(24, dtype=np.int32)[None]
    jl, jkv = jax.jit(lambda p, t, q: jllama.prefill_with_kv(
        p, t, q, jllama.LLAMA_TINY, interpret=True))(jp, jnp.asarray(toks), jnp.asarray(pos))
    tl, tkv = llama.prefill_with_kv(tp, torch.from_numpy(toks).long(),
                                    torch.from_numpy(pos), CFG)
    assert tl.shape == (1, 24, CFG.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


@pytest.mark.parametrize("kv_mode", ["none", "int8", "fp8"])
def test_decode_step_matches_jax(both_params, kv_mode):
    jp, tp = both_params
    jcache = jllama.make_cache(jllama.LLAMA_TINY, 2, 64, mode=kv_mode)
    tcache = llama.make_cache(CFG, 2, 64, mode=kv_mode, device="cpu")
    jstep = jax.jit(lambda p, t, c: jllama.decode_step(
        p, t, jllama.LLAMA_TINY, c, interpret=True))
    toks = np.random.default_rng(1).integers(0, CFG.vocab_size, (6, 2)).astype(np.int32)
    for step in range(6):
        jl, jcache = jstep(jp, jnp.asarray(toks[step]), jcache)
        tl, tcache = llama.decode_step(tp, torch.from_numpy(toks[step]).long(), CFG, tcache)
        assert tl.shape == (2, CFG.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))
    # the port's cache equals the JAX cache after the bridge
    got = kv_cache_from_jax(jcache)
    np.testing.assert_allclose(tcache.k[1].float().numpy(), got.k[1].float().numpy(),
                               atol=0.51 if kv_mode == "int8" else 0.07)


def test_bridge_kv_cache_fp8_depermutes_scale_lanes():
    """An fp8 JAX cache at capacity 2048 stores its scale lanes permuted
    evens-then-odds; the bridge must hand the port natural order."""
    B, Hk, S, D, T = 2, 2, 2048, 16, 37
    r = np.random.default_rng(2)
    k = r.standard_normal((B, T, Hk, D)).astype(np.float32)
    v = r.standard_normal((B, T, Hk, D)).astype(np.float32)
    jc = JKVCache.create(1, B, S, Hk, D, dtype=jnp.float32, mode="fp8")
    assert jc.scale_perm_chunk == 2048
    jc = jc.append(0, jnp.asarray(k), jnp.asarray(v)).advance(T)
    # one more token through the fused append (permuted lane write)
    k1 = r.standard_normal((B, 1, Hk, D)).astype(np.float32)
    v1 = r.standard_normal((B, 1, Hk, D)).astype(np.float32)
    jc = jc.append(0, jnp.asarray(k1), jnp.asarray(v1)).advance(1)
    tc = kv_cache_from_jax(jc)
    assert tc.k_scale[0].shape == (B, Hk, S)
    _, want_ks, _, want_vs = j_quantize_kv(jnp.asarray(np.concatenate([k, k1], 1)),
                                           jnp.asarray(np.concatenate([v, v1], 1)), "fp8")
    want_ks = np.swapaxes(np.asarray(want_ks)[..., 0], 1, 2)  # [B, Hk, T+1]
    want_vs = np.swapaxes(np.asarray(want_vs)[..., 0], 1, 2)
    np.testing.assert_allclose(tc.k_scale[0][:, :, :T + 1].numpy(), want_ks, rtol=2.4e-7)
    np.testing.assert_allclose(tc.v_scale[0][:, :, :T + 1].numpy(), want_vs, rtol=2.4e-7)
    assert (tc.k_scale[0][:, :, T + 1:] == 1.0).all()
    # decode over both caches agrees
    q = jnp.asarray(r.standard_normal((B, 4, D)), jnp.float32)
    kc, vc, ks, vs = jc.layer(0)
    jo = j_flash_decode(q, kc, vc, k_scale=ks, v_scale=vs, kv_length=jc.length,
                        kv_layout="bhsd", interpret=True, **jc.scale_args())
    to = flash_decode(torch.from_numpy(np.array(q)), tc.k[0], tc.v[0],
                      k_scale=tc.k_scale[0], v_scale=tc.v_scale[0],
                      kv_length=tc.length, kv_layout="bhsd")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)


def test_init_params_int8_on_the_fly_matches_quantize_weights():
    a = llama.init_params(CFG, seed=3, device="cpu", quantize="int8")
    b = llama.quantize_weights(llama.init_params(CFG, seed=3, device="cpu"))
    for name in ("wq", "w_gate"):
        assert torch.equal(a["blocks"][0][name][0], b["blocks"][0][name][0])
        assert torch.equal(a["blocks"][0][name][1], b["blocks"][0][name][1])
    assert torch.equal(a["tok_emb"], b["tok_emb"])


def test_entry_points_default_to_the_card():
    """Without device='cpu' the entry points ask for CUDA and raise when
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_params(CFG, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.make_cache(CFG, 1, 32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.to_torch(np.zeros(2, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.params_from_jax({"w": np.zeros(2, np.float32)})


# (mode, head_mode, group_size, fuse).  At g = 128 the JAX package packs
# int4 as planes and the bridge repacks it as halves.
QUANT_CASES = [
    ("int4", None, 32, False),
    ("int4", "w8a8", 128, True),
    ("w4a8", "w8a8", 32, True),
    ("w4a8", None, 32, False),
    ("int8", "w8a8", 128, False),
    ("int8", "w8a8", 128, True),
    # weight-only heads, whose kernels take the head's fp32 activations
    ("int8", "int8", 128, False),
    ("int4", "int4", 32, True),
]


def _weight_leaves(tree):
    """Every tensor of a port params tree, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _weight_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _weight_leaves(x)]
    if hasattr(tree, "__dataclass_fields__"):
        return [t for f in tree.__dataclass_fields__ for t in _weight_leaves(getattr(tree, f))]
    return []


@pytest.mark.parametrize("mode,head_mode,g,fuse", QUANT_CASES)
def test_quantized_modes_match_jax(mode, head_mode, g, fuse):
    """quantize_weights (+ fuse_projections) on the bridged float params
    gives the JAX package's quantized tree bit for bit, and its prefill and
    fp8-KV decode logits match JAX's.  Tolerance as LOGIT_TOL; the int8
    activations of w4a8/w8a8 add at most a flipped x rounding (1/127 of a
    row's step) whose effect on a logit is ~1e-4."""
    jp = jllama.init_params(jllama.LLAMA_TINY, jax.random.PRNGKey(4))
    skip = ("tok_emb",) if head_mode else ("tok_emb", "lm_head")
    jq = jllama.quantize_weights(jp, mode, group_size=g, skip=skip, head_mode=head_mode)
    tq = llama.quantize_weights(params_from_jax(jp), mode, group_size=g, skip=skip,
                                head_mode=head_mode)
    if fuse:
        jq, tq = jllama.fuse_projections(jq), llama.fuse_projections(tq)
    bridged = params_from_jax(jq)
    assert ("wqkv" in bridged["blocks"][0]) == fuse
    mine, theirs = _weight_leaves(tq), _weight_leaves(bridged)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and torch.equal(a, b)

    toks = np.random.default_rng(5).integers(0, CFG.vocab_size, (1, 20)).astype(np.int32)
    pos = np.arange(20, dtype=np.int32)[None]
    jprefill = jax.jit(lambda p, t, q: jllama.prefill_with_kv(
        p, t, q, jllama.LLAMA_TINY, interpret=True)[0])
    jl = jprefill(jq, jnp.asarray(toks), jnp.asarray(pos))
    tl, _ = llama.prefill_with_kv(tq, torch.from_numpy(toks).long(), torch.from_numpy(pos), CFG)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)

    jcache = jllama.make_cache(jllama.LLAMA_TINY, 2, 32, mode="fp8")
    tcache = llama.make_cache(CFG, 2, 32, mode="fp8", device="cpu")
    jstep = jax.jit(lambda p, t, c: jllama.decode_step(p, t, jllama.LLAMA_TINY, c,
                                                       interpret=True))
    steps = np.random.default_rng(6).integers(0, CFG.vocab_size, (3, 2)).astype(np.int32)
    for step in steps:
        jl, jcache = jstep(jq, jnp.asarray(step), jcache)
        tl, tcache = llama.decode_step(tq, torch.from_numpy(step).long(), CFG, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)


@pytest.mark.parametrize("mode", ["int4", "w4a8", "w8a8"])
def test_init_params_quantized_and_fused_on_the_fly(mode):
    """init_params(quantize, head_mode, fuse) quantizes and fuses each
    block as it is made; the result equals quantizing and fusing the float
    model afterwards."""
    a = llama.init_params(CFG, seed=7, device="cpu", quantize=mode, group_size=32,
                          head_mode="w8a8", fuse=True)
    b = llama.fuse_projections(llama.quantize_weights(
        llama.init_params(CFG, seed=7, device="cpu"), mode, group_size=32,
        skip=("tok_emb",), head_mode="w8a8"))
    assert set(a["blocks"][0]) == set(b["blocks"][0]) and "wqkv" in a["blocks"][0]
    assert type(a["lm_head"]).__name__ == "W8A8Weight"
    mine, theirs = _weight_leaves(a), _weight_leaves(b)
    assert len(mine) == len(theirs)
    for x, y in zip(mine, theirs):
        assert torch.equal(x, y)

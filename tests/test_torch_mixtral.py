"""The port's Mixtral (top-2 routed MoE over the Llama attention stack) and
its router against the JAX package at MIXTRAL_TINY, on the CPU: the
router, the MoE layer and the serving paths in three weight kinds
and ``quantize_weights`` in every mode bit for bit
(tests/test_torch_mixtral_engine.py holds the engines and the HF
conversion).

Inputs are made with numpy from a seed and handed to both sides; the
params go through the bridge.  JAX runs its Pallas kernels in interpret
mode; the port runs the plain versions of its kernels.  The model is fp32
on both sides, so the two differ only in the order of fp32 sums, except
where a router's top-2 is a near tie: the tests' seeds leave every
token's expert set equal (each test that could flip says so).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.engine.paged import PagedKVPool as JPool
from flash_attn_tpu.models import mixtral as jmx
from flash_attn_tpu.parallel import moe as jmoe
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.models import mixtral as mx
from flash_attn_tpu_torch.ops.matmul import W4A8Weight, W8A8Weight
from flash_attn_tpu_torch.ops.quant import Int4Weight
from flash_attn_tpu_torch.parallel import moe
from _torch_threads import one_torch_thread  # noqa: F401

CFG = mx.MIXTRAL_TINY
JCFG = jmx.MIXTRAL_TINY
# fp32 on both sides: summation order moves O(0.1) logits by ~1e-6; the
# int8 / int4 weight products and a quantized KV value rounded to its
# neighbouring code by that order move them by up to ~1e-3
# (tests/test_torch_llama.py's bound)
LOGIT_TOL = 2e-3
F32_TOL = 1e-4


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
    """{"float" | "int8" | "int4": (JAX params, the port's)}: each
    package quantizes the same float weights (int4 at g = 32, as the JAX
    package's tests do at this width)."""
    jp = jmx.init_params(JCFG, jax.random.PRNGKey(0))
    tp = _bridge(jp)
    out = {"float": (jp, tp)}
    for mode, g in (("int8", 128), ("int4", 32)):
        # jitted: eagerly, each projection's quantization compiles its ops
        jq = jax.jit(functools.partial(jmx.quantize_weights, mode=mode, group_size=g))(jp)
        out[mode] = (jq, mx.quantize_weights(tp, mode, group_size=g))
    return out


def test_configs_equal_jax():
    for name in ("MIXTRAL_8X7B", "MIXTRAL_TINY"):
        mine, theirs = getattr(mx, name), getattr(jmx, name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), name
    assert list(mx.MixtralConfig.__dataclass_fields__) == list(
        jmx.MixtralConfig.__dataclass_fields__)


def test_router_topk_matches_jax_on_random_logits():
    """Random logits [64, 8], top 2 and top 3: the same experts chosen and
    the same weights (fp32 softmax over k values: 1e-6)."""
    logits = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    for k in (2, 3):
        want = np.asarray(jmoe.router_topk(jnp.asarray(logits), k))
        got = moe.router_topk(torch.from_numpy(logits), k).numpy()
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert ((got > 0).sum(-1) == k).all()


def test_router_topk_breaks_exact_ties_as_jax():
    """Exact ties at and across the top-k boundary go to the lower expert
    index, as jax.lax.top_k breaks them: the same experts chosen, and the
    weights JAX's to an ulp (each side's softmax rounds 1/3 its own way)."""
    logits = np.array([
        [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],    # all equal: experts 0, 1
        [0.0, 2.0, 2.0, 2.0, 1.0, 0.0, 0.0, 0.0],    # three-way tie at the top
        [3.0, 0.5, 0.5, 3.0, 0.5, 0.5, 3.0, 0.5],    # three-way tie, spread
        [-1.0, -2.0, 0.0, -2.0, 0.0, -5.0, -2.0, 0.0],
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 7.0],    # one top, seven tied below
        [5.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0, 4.0],
    ], np.float32)
    for k in (1, 2, 3):
        want = np.asarray(jmoe.router_topk(jnp.asarray(logits), k))
        got = moe.router_topk(torch.from_numpy(logits), k).numpy()
        np.testing.assert_array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    chosen = moe.router_topk(torch.from_numpy(logits), 2).numpy() > 0
    assert chosen[0].nonzero()[0].tolist() == [0, 1]
    assert chosen[1].nonzero()[0].tolist() == [1, 2]
    assert chosen[2].nonzero()[0].tolist() == [0, 3]
    assert chosen[5].nonzero()[0].tolist() == [0, 1]


def test_moe_ffn_reference_and_stack_experts_match_jax(params):
    """stack_experts gives JAX's stacked arrays, and the dense oracle on
    them equals JAX's (fp32 throughout: 1e-6 on outputs of ~1e-3)."""
    jp, tp = params["float"]
    mine = mx.stack_experts(tp["blocks"][1])
    theirs = jmx.stack_experts(jp["blocks"][1])
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    x = np.random.default_rng(1).standard_normal((16, CFG.hidden)).astype(np.float32)
    want = jmoe.moe_ffn_reference(jnp.asarray(x), *theirs, top_k=CFG.top_k)
    got = moe.moe_ffn_reference(torch.from_numpy(x), *mine, top_k=CFG.top_k)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weights", ["float", "int8", "int4"])
def test_moe_mlp_matches_jax(params, weights):
    """_moe_mlp on x [2, 8, H] (the residual included) against JAX's, and
    with float experts against the dense oracle on the normed input."""
    jp, tp = params[weights]
    x = np.random.default_rng(2).standard_normal((2, 8, CFG.hidden)).astype(np.float32)
    want = jax.jit(lambda x, blk: jmx._moe_mlp(x, blk, JCFG, interpret=True))(
        jnp.asarray(x), jp["blocks"][0])
    got = mx._moe_mlp(torch.from_numpy(x), tp["blocks"][0], CFG)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)
    if weights == "float":
        blk = tp["blocks"][0]
        h = mx._rms_norm(torch.from_numpy(x), blk["mlp_norm"], CFG.rms_eps).reshape(-1,
                                                                                    CFG.hidden)
        dense = moe.moe_ffn_reference(h, *mx.stack_experts(blk), top_k=CFG.top_k)
        np.testing.assert_allclose(_np(got - torch.from_numpy(x)).reshape(-1, CFG.hidden),
                                   _np(dense), atol=1e-5)


@pytest.mark.parametrize("weights", ["float", "int8", "int4"])
def test_serving_paths_match_jax(params, weights):
    """One weight kind through every serving path: prefill_with_kv (and
    forward at float weights), prefill_packed of three prompts, two
    decode_step calls and decode_multi of 3 tokens on an int8 cache, and
    two decode_step_paged calls on an fp8 pool: logits equal JAX's."""
    jp, tp = params[weights]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, CFG.vocab_size, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12))
    jl, jkv = _jit(jmx.prefill_with_kv, JCFG)(jp, jnp.asarray(toks), jnp.asarray(pos))
    tl, tkv = mx.prefill_with_kv(tp, torch.from_numpy(toks).long(), torch.from_numpy(pos), CFG)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=F32_TOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(_np(tk), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(_np(tv), np.asarray(jv), atol=1e-5)
    if weights == "float":
        jf = _jit(jmx.forward, JCFG)(jp, jnp.asarray(toks))
        tf = mx.forward(tp, torch.from_numpy(toks).long(), CFG)
        np.testing.assert_allclose(_np(tf), np.asarray(jf), atol=F32_TOL)

    ptoks, ppos, seg = (np.zeros((1, 32), np.int32) for _ in range(3))
    off = 0
    for i, n in enumerate((10, 7, 9)):
        ptoks[0, off:off + n] = rng.integers(0, CFG.vocab_size, n)
        seg[0, off:off + n], ppos[0, off:off + n] = i + 1, np.arange(n)
        off += n
    jl, _ = _jit(jmx.prefill_packed, JCFG)(jp, *(jnp.asarray(a) for a in (ptoks, ppos, seg)))
    tl, _ = mx.prefill_packed(tp, torch.from_numpy(ptoks).long(), torch.from_numpy(ppos),
                              torch.from_numpy(seg), CFG)
    np.testing.assert_allclose(_np(tl)[:, :off], np.asarray(jl)[:, :off], atol=F32_TOL)

    # the prompts' K/V (the port's, handed to both caches) in an int8 cache
    jcache = jmx.make_cache(JCFG, 2, 32, mode="int8")
    for i, (k, v) in enumerate(tkv):
        jcache = jcache.append(i, jnp.asarray(_np(k)), jnp.asarray(_np(v)))
    jcache = jcache.advance(12)
    tcache = bridge.kv_cache_from_jax(jax.device_get(jcache), device="cpu")
    jstep = _jit(jmx.decode_step, JCFG)
    for step in rng.integers(0, CFG.vocab_size, (2, 2)).astype(np.int32):
        jl, jcache = jstep(jp, jnp.asarray(step), jcache)
        tl, tcache = mx.decode_step(tp, torch.from_numpy(step).long(), CFG, tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
    multi = rng.integers(0, CFG.vocab_size, (2, 3)).astype(np.int32)
    jl, jcache = _jit(jmx.decode_multi, JCFG)(jp, jnp.asarray(multi), jcache)
    tl, tcache = mx.decode_multi(tp, torch.from_numpy(multi).long(), CFG, tcache)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))

    # the same prompts' K/V in an fp8 pool of pages of 8
    jpool = JPool.create(CFG.num_layers, 9, 8, 2, 4, CFG.num_kv_heads, CFG.head_dim,
                         dtype=jnp.float32, mode="fp8")
    for b, pages in enumerate(([3, 7, 1, 5], [2, 8, 4, 6])):
        jpool = jpool.assign_pages(b, pages)
        for i, (k, v) in enumerate(tkv):
            jpool = jpool.append_prefill(i, b, jnp.asarray(_np(k[b])), jnp.asarray(_np(v[b])),
                                         0)
    jpool = jpool.set_lengths([12, 12])
    tpool = bridge.paged_pool_from_jax(jax.device_get(jpool), device="cpu")
    jdec = _jit(jmx.decode_step_paged, JCFG)
    for step in rng.integers(0, CFG.vocab_size, (2, 2)).astype(np.int32):
        jl, jpool = jdec(jp, jnp.asarray(step), jpool)
        tl, tpool = mx.decode_step_paged(tp, torch.from_numpy(step).long(), CFG, tpool)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)


def test_sliding_window_prefill_and_decode_match_jax(params):
    """sliding_window=6 (tests/test_mixtral.py:147): prefill_with_kv of 12
    tokens and two decode steps past the window equal JAX's, and differ
    from the global model's; the packed prefill and the verify step take
    it too (held against JAX in tests/test_torch_window_paths.py): the
    prompt packed alone gives the one-prompt prefill's logits, and a
    verify round of 2 tokens two decode steps' logits."""
    jp, tp = params["float"]
    cfg, jcfg = (dataclasses.replace(c, sliding_window=6) for c in (CFG, JCFG))
    prompt = np.random.default_rng(7).integers(0, CFG.vocab_size, (1, 12)).astype(np.int32)
    pos = np.arange(12, dtype=np.int32)[None]
    jl, jkv = _jit(jmx.prefill_with_kv, jcfg)(jp, jnp.asarray(prompt), jnp.asarray(pos))
    tl, _ = mx.prefill_with_kv(tp, torch.from_numpy(prompt).long(), torch.from_numpy(pos), cfg)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=F32_TOL)
    one = tl
    glob, _ = mx.prefill_with_kv(tp, torch.from_numpy(prompt).long(), torch.from_numpy(pos), CFG)
    assert float((tl[:, -1] - glob[:, -1]).abs().max()) > 1e-4
    jcache = jmx.make_cache(jcfg, 1, 32)
    for i, (k, v) in enumerate(jkv):
        jcache = jcache.append(i, k, v)
    jcache = jcache.advance(12)
    tcache = bridge.kv_cache_from_jax(jax.device_get(jcache), device="cpu")
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    jstep = _jit(jmx.decode_step, jcfg)
    for _ in range(2):
        jl, jcache = jstep(jp, jnp.asarray(tok), jcache)
        tl, tcache = mx.decode_step(tp, torch.from_numpy(tok).long(), cfg, tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=F32_TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    t = torch.from_numpy(prompt).long()
    packed, _ = mx.prefill_packed(tp, t, torch.from_numpy(pos), torch.ones_like(t), cfg)
    np.testing.assert_allclose(_np(packed), _np(one), atol=F32_TOL)
    multi = bridge.kv_cache_from_jax(jax.device_get(jcache), device="cpu")
    steps = bridge.kv_cache_from_jax(jax.device_get(jcache), device="cpu")
    two = np.array([[tok[0], 7]], np.int64)
    ml, _ = mx.decode_multi(tp, torch.from_numpy(two), cfg, multi)
    for i in range(2):
        sl, steps = mx.decode_step(tp, torch.from_numpy(two[:, i]), cfg, steps)
        np.testing.assert_allclose(_np(ml[:, i]), _np(sl), atol=F32_TOL)


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


KINDS = {"int8": tuple, "int4": Int4Weight, "w8a8": W8A8Weight, "w4a8": W4A8Weight}


@pytest.mark.parametrize("mode", list(KINDS))
def test_quantize_weights_matches_jax(params, mode):
    """Every attention and expert projection in ``mode``, bit for bit the
    JAX package's tree after the bridge; router, embedding and head stay
    float (the same tensors)."""
    jp, tp = params["float"]
    jq = jmx.quantize_weights(jp, mode, group_size=32)
    tq = mx.quantize_weights(tp, mode, group_size=32)
    blk = tq["blocks"][0]
    assert isinstance(blk["wq"], KINDS[mode]) and isinstance(blk["experts"][3]["w_down"],
                                                             KINDS[mode])
    assert blk["router"] is tp["blocks"][0]["router"]
    assert tq["tok_emb"] is tp["tok_emb"] and tq["lm_head"] is tp["lm_head"]
    mine, theirs = _leaves(tq), _leaves(_bridge(jq))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_init_params_quantizes_on_the_fly(mode):
    """init_params(quantize) equals quantize_weights of the float draw from
    the same seed; the router, embedding and head stay float."""
    a = mx.init_params(CFG, seed=3, device="cpu", quantize=mode, group_size=32)
    b = mx.quantize_weights(mx.init_params(CFG, seed=3, device="cpu"), mode, group_size=32)
    assert a["blocks"][0]["router"].dtype == torch.float32
    mine, theirs = _leaves(a), _leaves(b)
    assert len(mine) == len(theirs)
    for x, y in zip(mine, theirs):
        assert torch.equal(x, y)

"""Gemma-2-27B's shape in the port against the JAX package, on the CPU.

27B differs from 9B where nothing else in the tests reaches: head_dim 128
(the card's K4, K9 and K10 take the window and the softcap there in
instances of their own), ``q_dim = num_heads * head_dim`` (4096) unequal to
``hidden`` (4608), and ``query_pre_attn_scalar`` (144) unequal to head_dim,
so the attention scale is 1/12, not D^-1/2.  A tiny config keeps those
three properties (q_dim 128 against hidden 48, scalar 12 against head_dim
32) and goes through ``prefill_with_kv``, ``forward``, ``decode_step``
(int8 and fp8 KV), the engine and one ``make_train_step`` step on both
sides; K4's and K9 + K10's plain versions (their CPU path, the card's
oracle) are held at head_dim 128 with the window and the softcap against
JAX's jnp oracles, ``mha_reference`` and ``_jnp_backward``.

Inputs are made with numpy from a seed and handed to both sides; the
params go through the bridge.  JAX runs its Pallas kernels in interpret
mode; the port runs the plain versions of its kernels.  Each tolerance is
stated with its reason.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.engine.engine import InferenceEngine as JEngine
from flash_attn_tpu.models import gemma2 as jgemma2
from flash_attn_tpu.ops.attention import _jnp_backward
from flash_attn_tpu.ops.reference import mha_reference as j_mha_reference
from flash_attn_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from flash_attn_tpu.ops.rope import rope_rotate as j_rope_rotate
from flash_attn_tpu.utils import train as jtrain
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.engine.engine import InferenceEngine
from flash_attn_tpu_torch.models import gemma2
from flash_attn_tpu_torch.ops import flash_bwd as fb
from flash_attn_tpu_torch.ops import flash_fwd as ff
from flash_attn_tpu_torch.utils import train
from _torch_threads import one_torch_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def _jitted(fn, jcfg):
    """JAX's model function ``fn`` with ``jcfg`` and interpret mode bound,
    jitted once a module, as the JAX engine runs it (eagerly, interpret
    mode compiles each of its small ops apart).  The arguments after
    ``cfg`` go by keyword."""
    return jax.jit(functools.partial(fn, cfg=jcfg, interpret=True))

# 27B's proportions at a tiny size, built on each side from its own config
# class: q_dim 4 x 32 = 128 != hidden 48, query_pre_attn_scalar 12 != 32
TINY_27B = dict(vocab_size=512, hidden=48, intermediate=96, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=32, max_position=128, sliding_window=16,
                query_pre_attn_scalar=12.0, dtype="float32")
CFG = gemma2.Gemma2Config(**TINY_27B)
JCFG = jgemma2.Gemma2Config(**TINY_27B)
# fp32 on both sides: summation order, exp2 against exp, and tanh on
# scores in base-2 against natural units: ~1e-6 on O(1) outputs
F32_TOL = 1e-5
# logits (capped at 30) are O(1): fp32 summation order moves them ~1e-5; a
# flipped int8/fp8 KV rounding by up to ~5e-3 after two layers (as
# tests/test_torch_gemma2.py holds GEMMA2_TINY's)
LOGIT_TOL = 5e-3
# the backward in fp32: summation order, relative to the largest value
# (tests/test_torch_train.py's fp32 bound)
BWD_TOL = 2e-6


def test_config_matches_jax_27b():
    """The tiny config has 27B's properties, and the port's GEMMA2_27B is
    JAX's field for field."""
    assert CFG.num_heads * CFG.head_dim != CFG.hidden
    assert CFG.query_pre_attn_scalar != CFG.head_dim
    for f in jgemma2.Gemma2Config.__dataclass_fields__:
        assert getattr(gemma2.GEMMA2_27B, f) == getattr(jgemma2.GEMMA2_27B, f), f
    big = gemma2.GEMMA2_27B
    assert (big.num_heads * big.head_dim, big.hidden, big.query_pre_attn_scalar ** -0.5) == (
        4096, 4608, 1 / 12)


# --- K4's and K9 + K10's plain versions at head_dim 128 -----------------------

B, SQ, SK, H, HK, D = 2, 37, 53, 4, 2, 128
SCALE = 144.0 ** -0.5  # 27B's query_pre_attn_scalar
# Gemma's window (left only, causal) and a two-sided one (not causal),
# each with a cap of 2 (on scores of ~3: tanh far from linear) and without
ATTN_CASES = [pytest.param(w, c, cap, id=f"w{w[0]}.{w[1]}-c{int(c)}-cap{cap}")
              for w, c in (((7, -1), True), ((3, 3), False)) for cap in (2.0, None)]


def _attn_inputs(seed):
    """q (x3 so that a cap of 2 bends the scores), k, v, dout, fp32."""
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, SQ, H, D)).astype(np.float32) * 3.0
    k, v = (r.standard_normal((B, SK, HK, D)).astype(np.float32) for _ in range(2))
    dout = r.standard_normal((B, SQ, H, D)).astype(np.float32)
    return q, k, v, dout


@pytest.mark.parametrize("window,causal,cap", ATTN_CASES)
def test_flash_fwd_d128_window_softcap_matches_reference(window, causal, cap):
    """K4's plain version at head_dim 128, GQA 4/2, Sq=37 < Sk=53 (the
    window and the causal mask bottom-right aligned), scale 1/12, q
    rotated in the kernel, both softmax modes (clamped is exact here:
    every base-2 score lies far below its ceiling of 80): out and lse
    against JAX's fp32 mha_reference on the q rotated outside (F32_TOL)."""
    q, k, v, _ = _attn_inputs(11)
    jc, js = j_rope_cos_sin(jnp.arange(SQ)[None] + (SK - SQ), D, 10000.0)
    jq = j_rope_rotate(jnp.asarray(q), jc, js)
    jo, jl = j_mha_reference(jq, jnp.asarray(k), jnp.asarray(v), causal=causal, scale=SCALE,
                             window=window, logit_softcap=cap, return_lse=True)
    jl = np.asarray(jl)
    live = np.isfinite(jl)
    for mode in ("online", "clamped"):
        to, tl = ff.flash_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                              causal=causal, scale=SCALE, window=window, logit_softcap=cap,
                              rope_cos=bridge.to_torch(jc, device="cpu"),
                              rope_sin=bridge.to_torch(js, device="cpu"), softmax_mode=mode)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(tl.numpy()[live], jl[live], atol=F32_TOL, rtol=F32_TOL)
        assert (tl.numpy()[~live] == ff.NEG_INF).all()


@pytest.mark.parametrize("window,causal,cap", ATTN_CASES)
def test_flash_bwd_d128_window_softcap_matches_jnp_backward(window, causal, cap):
    """flash_bwd (K9 + K10's plain version) at head_dim 128, GQA 4/2,
    Sq=37 < Sk=53, scale 1/12, against JAX's plain ``_jnp_backward`` on
    the same out and lse (from mha_reference): dq, dk, dv to BWD_TOL of
    their largest value.  A missed 1 - t^2 factor moves dq by far more
    at cap 2 on these scores."""
    q, k, v, dout = _attn_inputs(13)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    jo, jl = j_mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=SCALE,
                             return_lse=True, **kw)
    want = _jnp_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jo, jl,
                         jnp.asarray(dout), bias=None, segs=None, scale=SCALE,
                         want_dbias=False, **kw)[:3]
    lse = torch.from_numpy(np.array(jl))
    got = fb.flash_bwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       torch.from_numpy(np.array(jo)), lse, torch.from_numpy(dout),
                       scale=SCALE, **kw)
    for g, w, x, name in zip(got, want, (q, k, v), ("dq", "dk", "dv")):
        w = np.asarray(w)
        assert g.shape == x.shape, name
        assert float(np.abs(g.numpy() - w).max() / np.abs(w).max()) < BWD_TOL, name


# --- models/gemma2.py at 27B's proportions -------------------------------------

@pytest.fixture(scope="module")
def params():
    jp = jgemma2.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, bridge.params_from_jax(jax.device_get(jp), device="cpu")


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (1, n)).astype(np.int32)


def test_bridge_carries_27b_shapes(params):
    """The bridge carries every leaf as it is, at q_dim != hidden: wq
    [hidden, q_dim], wk/wv [hidden, kv_dim], wo [q_dim, hidden]."""
    jp, tp = params
    blk, jblk = tp["blocks"][1], jp["blocks"][1]
    assert tuple(blk["wq"].shape) == (48, 128) and tuple(blk["wo"].shape) == (128, 48)
    assert tuple(blk["wk"].shape) == (48, 64)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm"):
        np.testing.assert_array_equal(blk[name].numpy(), np.asarray(jblk[name]))
    np.testing.assert_array_equal(tp["tok_emb"].numpy(), np.asarray(jp["tok_emb"]))


def test_prefill_and_forward_match_jax(params):
    """A 24-token prompt (past the window of 16) through prefill_with_kv
    (clamped) and forward (online): logits and each layer's K/V against
    JAX's in interpret mode (LOGIT_TOL; K/V 1e-4 after one layer's fp32
    sums).  The scale is query_pre_attn_scalar's: at head_dim's the
    logits move a hundred times further than the port is from JAX (the
    random weights' scores are small, so the move itself is ~1e-2)."""
    jp, tp = params
    toks = _prompt(3, 24)
    pos = np.arange(24, dtype=np.int32)[None]
    jl, jkv = _jitted(jgemma2.prefill_with_kv, JCFG)(jp, jnp.asarray(toks), jnp.asarray(pos))
    tl, tkv = gemma2.prefill_with_kv(tp, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                                     CFG)
    assert tl.shape == (1, 24, CFG.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        assert tuple(tk.shape) == (1, 24, CFG.num_kv_heads, CFG.head_dim)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    jf = _jitted(jgemma2.forward, JCFG)(jp, jnp.asarray(toks))
    tf = gemma2.forward(tp, torch.from_numpy(toks).long(), CFG)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=LOGIT_TOL)
    other = gemma2.Gemma2Config(**{**TINY_27B, "query_pre_attn_scalar": 32.0})
    moved = gemma2.forward(tp, torch.from_numpy(toks).long(), other)
    off = float(np.abs(tf.numpy() - np.asarray(jf)).max())
    assert float((moved - tf).abs().max()) > 100 * off


@pytest.mark.parametrize("kv_mode", ["int8", "fp8"])
def test_decode_step_matches_jax(params, kv_mode):
    """Two sequences prefilled to 14 and 10 tokens (the bridge carries
    JAX's cache over), then 6 decode steps that cross the window of 16:
    logits every step (LOGIT_TOL), the lengths and the K values (one int8
    step, 0.51 of a scale unit; fp8 to 0.07) at the end."""
    jp, tp = params
    jcache = jgemma2.make_cache(JCFG, 2, 64, mode=kv_mode)
    for b, n in enumerate((14, 10)):
        _, kvs = _jitted(jgemma2.prefill_with_kv, JCFG)(jp, jnp.asarray(_prompt(5 + b, n)),
                                                        jnp.arange(n)[None])
        for i, (k, v) in enumerate(kvs):
            jcache = jcache.insert_at(i, b, k[0], v[0], 0)
        jcache = jcache.set_length(b, n)
    tcache = bridge.kv_cache_from_jax(jax.device_get(jcache), device="cpu")
    assert tuple(tcache.k[0].shape[1:3]) == (CFG.num_kv_heads, 64)
    jstep = jax.jit(lambda p, t, c: jgemma2.decode_step(p, t, JCFG, c, interpret=True))
    toks = np.random.default_rng(9).integers(0, CFG.vocab_size, (6, 2)).astype(np.int32)
    for step in range(6):
        jl, jcache = jstep(jp, jnp.asarray(toks[step]), jcache)
        tl, tcache = gemma2.decode_step(tp, torch.from_numpy(toks[step]).long(), CFG, tcache)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))
    got = bridge.kv_cache_from_jax(jax.device_get(jcache), device="cpu")
    np.testing.assert_allclose(tcache.k[0].float().numpy(), got.k[0].float().numpy(),
                               atol=0.51 if kv_mode == "int8" else 0.07)


# prompts past the window of 16 (and one shorter), through two slots
PROMPTS = [list(range(40, 70)), [5, 6, 7, 8, 9], list(range(100, 121))]
MAX_TOKENS = [6, 4, 7]


@pytest.mark.parametrize("kv_mode", ["none", "fp8"])
def test_engine_greedy_tokens_equal_jax(params, kv_mode):
    """The Gemma adapter through InferenceEngine, two slots, one prompt a
    prefill call: every generated token equals the JAX engine's."""
    jp, tp = params
    jeng = JEngine(jp, jgemma2.make_adapter(JCFG, interpret=True), max_batch=2, capacity=64,
                   kv_mode=kv_mode, cache_dtype=jnp.float32)
    teng = InferenceEngine(tp, gemma2.make_adapter(CFG), max_batch=2, capacity=64,
                           kv_mode=kv_mode, cache_dtype=torch.float32, device="cpu")
    jreqs = [jeng.submit(p, max_tokens=n) for p, n in zip(PROMPTS, MAX_TOKENS)]
    treqs = [teng.submit(p, max_tokens=n) for p, n in zip(PROMPTS, MAX_TOKENS)]
    jeng.run()
    teng.run()
    for jr, tr, n in zip(jreqs, treqs, MAX_TOKENS):
        assert tr.done and len(tr.generated) == n
        assert tr.generated == jr.generated


def test_train_step_matches_jax():
    """One make_train_step step (remat on) on the same fp32 params and
    batch (S=40, past the window of 16) against JAX's: loss to 1e-5
    relative, grad_norm to 1e-4, every param to a tenth of lr (mean 1e-6),
    as tests/test_torch_gemma2_train.py holds GEMMA2_TINY's."""
    jparams = jgemma2.init_params(JCFG, jax.random.PRNGKey(1))
    tp = bridge.params_from_jax(jax.device_get(jparams), device="cpu")
    batch = np.random.default_rng(6).integers(0, CFG.vocab_size, (2, 41)).astype(np.int32)
    tok, tgt = batch[:, :-1], batch[:, 1:]
    jinit, jstep = jtrain.make_train_step(lambda p, t: jgemma2.forward(p, t, JCFG, interpret=True),
                                          jtrain.TrainConfig(remat=True))
    jparams, _, jm = jax.jit(jstep)(jparams, jinit(jparams), jnp.asarray(tok), jnp.asarray(tgt))
    init_fn, step_fn = train.make_train_step(
        lambda p, t, remat: gemma2.forward(p, t, CFG, remat=remat), train.TrainConfig(remat=True))
    tp, _, m = step_fn(tp, init_fn(tp), torch.from_numpy(tok).long(),
                       torch.from_numpy(tgt).long())
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    lr = train.TrainConfig().learning_rate
    diffs = [np.abs(g.detach().numpy() - np.asarray(w))
             for g, w in zip(train.param_leaves(tp), jax.tree.leaves(jparams))]
    assert max(float(d.max()) for d in diffs) <= 0.1 * lr
    assert sum(float(d.sum()) for d in diffs) / sum(d.size for d in diffs) < 1e-6

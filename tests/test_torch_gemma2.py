"""Gemma-2 serving in the port against the JAX package, on the CPU: K4's
plain version with a sliding window, the logit softcap, an explicit scale
and head_dim 16, 64 and 256; the decode plain version (K1's) with window
and softcap in bf16, int8 and fp8 caches, its split plan over the live
walk and the default-mode rule; ``models/gemma2.py`` (prefill, forward,
decode steps, quantization, HF conversion) and ``InferenceEngine`` on the
Gemma adapter, token for token against JAX's, with prompts longer than
the window.

Inputs are made with numpy from a seed and handed to both sides.  JAX runs
its Pallas kernels in interpret mode or through its plain oracles
(``mha_reference``, ``_decode_jnp``); the port runs the plain versions of
its kernels.  Each tolerance is stated with its reason.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.engine.engine import InferenceEngine as JEngine
from flash_attn_tpu.models import gemma2 as jgemma2
from flash_attn_tpu.ops import decode as jdecode
from flash_attn_tpu.ops.attention import flash_attention as j_flash_attention
from flash_attn_tpu.ops.reference import mha_reference as j_mha_reference
from flash_attn_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from flash_attn_tpu.ops.rope import rope_rotate as j_rope_rotate
from flash_attn_tpu_torch import bridge, flash_attention
from flash_attn_tpu_torch.engine.engine import InferenceEngine
from flash_attn_tpu_torch.models import gemma2
from flash_attn_tpu_torch.ops import decode as dec
from flash_attn_tpu_torch.ops import flash_fwd as ff
from _torch_threads import one_torch_thread  # noqa: F401


@functools.lru_cache(maxsize=None)
def _jitted(fn, jcfg):
    """JAX's model function ``fn`` with ``jcfg`` and interpret mode bound,
    jitted once a module, as the JAX engine runs it (eagerly, interpret
    mode compiles each of its small ops apart).  The arguments after
    ``cfg`` go by keyword."""
    return jax.jit(functools.partial(fn, cfg=jcfg, interpret=True))

CFG = gemma2.GEMMA2_TINY
# fp32 on both sides: summation order, exp2 against exp, and tanh on
# scores in base-2 against natural units: ~1e-6 on O(1) outputs
F32_TOL = 1e-5
# GEMMA2_TINY logits (capped at 30) are O(1): fp32 summation order moves
# them ~1e-5; a flipped int8/fp8 KV rounding (or an int8 activation's, in
# the quantized projections) by up to ~5e-3 after two layers
LOGIT_TOL = 5e-3


def to_torch(x):
    return bridge.to_torch(x, device="cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


# --- K4's plain version: window, softcap, scale, head dims ----------------

# (D, window, softmax_mode, causal): the window's three forms at every head
# dim the port meets (GPT-2's 64, Gemma-2-9B's 256, the tiny models' 16)
FWD_CASES = [
    (16, (5, -1), "online", True), (16, (-1, 4), "clamped", False),
    (64, (6, 3), "online", False), (64, (9, -1), "clamped", True),
    (256, (11, -1), "clamped", True), (256, (-1, 7), "online", True),
    (256, (8, 2), "clamped", False),
]


@pytest.mark.parametrize("D,window,softmax_mode,causal", FWD_CASES)
def test_flash_fwd_window_softcap_matches_reference(D, window, softmax_mode, causal):
    """GQA 4/2, a shifted ragged shape (Sq=37, Sk=53: the window and the
    causal mask bottom-right aligned), scale 0.3, a softcap of 2 (below
    the scores' spread, so it bites), q rotated in the kernel: out and lse
    against JAX's exact fp32 mha_reference on the q rotated outside."""
    B, Sq, Sk, H, Hk = 2, 37, 53, 4, 2
    r = np.random.default_rng(D + window[0])
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Sk, Hk, D), (B, Sk, Hk, D)))
    jc, js = j_rope_cos_sin(jnp.arange(Sq)[None], D, 10000.0)
    to, tl = ff.flash_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, scale=0.3, window=window, logit_softcap=2.0,
                          rope_cos=to_torch(jc), rope_sin=to_torch(js),
                          softmax_mode=softmax_mode)
    jq = j_rope_rotate(jnp.asarray(q), jc, js)
    jo, jl = j_mha_reference(jq, jnp.asarray(k), jnp.asarray(v), causal=causal, scale=0.3,
                             window=window, logit_softcap=2.0, return_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=F32_TOL, rtol=F32_TOL)
    jl = np.asarray(jl)
    live = np.isfinite(jl)
    np.testing.assert_allclose(tl.numpy()[live], jl[live], atol=F32_TOL, rtol=F32_TOL)
    assert (tl.numpy()[~live] == ff.NEG_INF).all()


def test_flash_fwd_window_softcap_matches_jax_flash_attention():
    """One JAX flash_attention call in interpret mode (its Pallas kernel,
    block skipping and all): bf16, GQA 4/2, D=64, S=150 (ragged blocks),
    the sliding window (40, -1), softcap 5, scale 1/8, q rotated in the
    kernel, clamped.  bf16 outputs: a bf16 rounding of an O(1) value is
    2^-8 and the sides round p against different maxima."""
    B, S, H, Hk, D = 1, 150, 4, 2, 64
    r = np.random.default_rng(7)
    q, k, v = (jnp.asarray(r.standard_normal(s).astype(np.float32), jnp.bfloat16)
               for s in ((B, S, H, D), (B, S, Hk, D), (B, S, Hk, D)))
    jc, js = j_rope_cos_sin(jnp.arange(S)[None], D, 10000.0)
    jo, jl = j_flash_attention(q, k, v, causal=True, scale=0.125, window=(40, -1),
                               logit_softcap=5.0, rope_cos=jc, rope_sin=js,
                               softmax_mode="clamped", return_lse=True, interpret=True)
    to, tl = flash_attention(to_torch(q), to_torch(k), to_torch(v), causal=True, scale=0.125,
                             window=(40, -1), logit_softcap=5.0, rope_cos=to_torch(jc),
                             rope_sin=to_torch(js), softmax_mode="clamped", return_lse=True)
    np.testing.assert_allclose(_np(to), _np(jo), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-2)


def test_flash_fwd_window_and_softcap_arguments():
    """Window and softcap go through the backward too (so do segment
    ids); a window composes with positions, which it compares (positions
    0..7 give the causal window by index), and with segment ids and no
    positions it compares the indices (one segment gives the causal window
    by index); the wrappers refuse what K4 does not take (a window or a
    softcap at head_dim 64, masks at 256; raised before any build) and
    pass a window and a softcap at head_dim 128, with or without masks
    (segment ids alone too), on to the CUDA check."""
    q = torch.zeros(1, 8, 2, 32)
    ids = torch.zeros(1, 8, dtype=torch.int32)
    out = flash_attention(q.clone().requires_grad_(True), q, q, causal=True, window=(4, -1),
                          logit_softcap=30.0)
    assert out.requires_grad
    # segment ids are differentiable too (K9/K10 take them)
    out = flash_attention(q.clone().requires_grad_(True), q, q, q_segment_ids=ids,
                          kv_segment_ids=ids)
    assert out.requires_grad
    pos = torch.arange(8, dtype=torch.int32)[None]
    qr = torch.from_numpy(np.random.default_rng(0).standard_normal((1, 8, 2, 32)).astype(
        np.float32))
    a, _ = ff.flash_fwd(qr, qr, qr, window=(4, -1), q_positions=pos, kv_positions=pos)
    b, _ = ff.flash_fwd(qr, qr, qr, window=(4, -1), causal=True)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="window"):
        ff.flash_fwd(q, q, q, window=(-2, 0))
    # both sides open is no window at all
    a, _ = ff.flash_fwd(q + 1, q, q, causal=True, window=(-1, -1))
    b, _ = ff.flash_fwd(q + 1, q, q, causal=True)
    assert torch.equal(a, b)
    bf = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        ff.flash_fwd_cuda(bf, bf, bf, True, 1.0, None, None, True)
    # the window and the softcap at head_dim 128 and 256 without masks,
    # masks at 64 and 128
    b64, b128, b256 = (torch.zeros(1, 8, 2, d, dtype=torch.bfloat16) for d in (64, 128, 256))
    with pytest.raises(NotImplementedError, match="head_dim 128 and 256"):
        ff.flash_fwd_cuda(b64, b64, b64, True, 1.0, None, None, True, None, (4, -1))
    with pytest.raises(NotImplementedError, match="head_dim 128 and 256"):
        ff.flash_fwd_cuda(b64, b64, b64, True, 1.0, None, None, True, None, None, 50.0)
    with pytest.raises(ValueError, match="CUDA"):
        ff.flash_fwd_cuda(b128, b128, b128, True, 1.0, None, None, True,
                          ff.Masks(None, None, ids, ids), (4, -1))
    a, _ = ff.flash_fwd(qr, qr, qr, window=(4, -1), causal=True, q_segment_ids=ids,
                        kv_segment_ids=ids)
    b, _ = ff.flash_fwd(qr, qr, qr, window=(4, -1), causal=True)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        ff.flash_fwd_cuda(b128, b128, b128, True, 1.0, None, None, True,
                          ff.Masks(ids, ids, None, None), (4, -1))
    with pytest.raises(NotImplementedError, match="head_dim 64 and 128"):
        ff.flash_fwd_cuda(b256, b256, b256, False, 1.0, None, None, True,
                          ff.Masks(None, None, ids, ids))
    # at head_dim 128 the window and the softcap pass on to the tensors'
    # check (Gemma-2-27B's K4 instance): CPU tensors raise before any build
    with pytest.raises(ValueError, match="CUDA"):
        ff.flash_fwd_cuda(b128, b128, b128, True, 1.0, None, None, True, None, (4, -1), 50.0)
    with pytest.raises(ValueError, match="CUDA"):
        ff.flash_fwd_cuda(b128, b128, b128, False, 1.0, None, None, False, None, (3, 3))
    assert ff.flash_fwd_cuda.launches == 0 and ff.flash_fwd_cuda.local_launches == 0
    # K1 takes head dims up to 256, and the window in decode mode only
    qd = torch.zeros(1, 2, 512, dtype=torch.bfloat16)
    kd = torch.zeros(1, 1, 64, 512, dtype=torch.bfloat16)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="D <= 256"):
        dec.flash_decode_cuda(qd, kd, kd, None, None, lens, 1.0, False, 80.0, 1, 64)
    q5 = torch.zeros(1, 10, 256, dtype=torch.bfloat16)
    k5 = torch.zeros(1, 1, 64, 256, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="decode mode"):
        dec.flash_decode_cuda(q5, k5, k5, None, None, lens, 1.0, False, 80.0, 1, None, 5,
                              "bhsd", 16)
    assert dec.flash_decode_cuda.launches == 0


# --- the decode plain version (K1's): window, softcap, splits ----------------

W = 20  # the decode tests' window
DEC_S = 96
# lengths 0, 1, W - 1, W, W + 1, the capacity, and past it (an idle slot)
DEC_LENS = [0, 1, W - 1, W, W + 1, DEC_S, DEC_S + 9]


def _decode_inputs(kv: str, seed: int):
    """q [B, H, D] fp32 and a BSHD cache for JAX (values, scales
    [B, S, Hk, 1] or None): bf16 values, or int8 / e4m3 codes with
    positive scales."""
    B, H, Hk, D = len(DEC_LENS), 4, 2, 32
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, H, D)).astype(np.float32)
    vals, scales = [], []
    for _ in range(2):
        x = r.standard_normal((B, DEC_S, Hk, D)).astype(np.float32)
        if kv == "bf16":
            vals.append(jnp.asarray(x, jnp.bfloat16))
            scales.append(None)
            continue
        if kv == "int8":
            vals.append(jnp.asarray(np.clip(np.round(x * 40), -127, 127).astype(np.int8)))
        else:
            vals.append(jnp.asarray(x * 8, jnp.float8_e4m3fn))
        scales.append(jnp.asarray(r.uniform(0.01, 0.05, (B, DEC_S, Hk, 1)), jnp.float32))
    return q, vals, scales


def _bhsd(x):
    return None if x is None else to_torch(x).transpose(1, 2).contiguous()


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_decode_window_softcap_matches_jax(kv):
    """flash_decode on a BHSD cache with window 20 and softcap 3 (it
    bites: the scores spread past it), at lengths 0, 1, W-1, W, W+1, S and
    past S, against JAX's jnp oracle ``_decode_jnp`` on the same values;
    1, 3 and 7 splits of the live walk agree.  fp32 q: the port computes
    in fp32 throughout, so only summation order differs.  The default
    softmax mode runs (online for every type at this cap); bf16 also runs
    clamped, exact here (every score is under the cap)."""
    q, (k, v), (ks, vs) = _decode_inputs(kv, 11)
    lens = np.asarray(DEC_LENS, np.int32)
    want = jdecode._decode_jnp(jnp.asarray(q), k, v, jnp.asarray(lens), scale=0.25,
                               num_splits=1, k_scale=ks, v_scale=vs, logit_softcap=3.0,
                               window=W)
    want = np.asarray(want)
    tk, tv = _bhsd(k), _bhsd(v)
    tks = None if ks is None else _bhsd(ks)[..., 0].contiguous()
    tvs = None if vs is None else _bhsd(vs)[..., 0].contiguous()
    modes = [None, "clamped"] if kv == "bf16" else [None]
    outs = []
    for mode in modes:
        for ns in (1, 3, 7):
            got = dec.flash_decode(torch.from_numpy(q), tk, tv, k_scale=tks, v_scale=tvs,
                                   kv_length=torch.from_numpy(lens), scale=0.25, window=W,
                                   logit_softcap=3.0, kv_layout="bhsd", num_splits=ns,
                                   softmax_mode=mode)
            np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
            outs.append(got)
    # length 0 attends to nothing: out 0
    assert not outs[0][0].any()
    for got in outs[1:]:
        np.testing.assert_allclose(got.numpy(), outs[0].numpy(), atol=1e-6)


def test_decode_window_split_plan_and_mode_rule():
    """The live-walk splits of a windowed call cover [max(0, len - W),
    min(len, S)) once, whatever the split count; a windowed K1 call plans
    its count on min(window, S) (fixed by shapes, so one captured grid
    serves every length); the default mode follows JAX's rule (fp8 with a
    cap whose base-2 bound reaches the fp8 ceiling runs online); the
    options still to port (the BSHD layout) raise."""
    lens = torch.tensor([0, 1, 19, 20, 21, 64, 65, 96, 130])
    for ns in (1, 3, 7, 13):
        bounds = dec.split_bounds(ns, None, DEC_S, lens, window=W)
        for b, n in enumerate(lens.tolist()):
            got = sorted(p for lo, hi in bounds for p in range(int(lo[b]), min(int(hi[b]), DEC_S,
                                                                                n)))
            assert got == list(range(max(0, n - W), min(n, DEC_S)))
    assert dec._splits(8 * 1, 8, min(4096, 8192), None) == (13, 320)
    for dt, jdt in ((torch.float8_e4m3fn, jnp.float8_e4m3fn), (torch.int8, jnp.int8),
                    (torch.bfloat16, jnp.bfloat16)):
        for cap in (None, 20.0, 27.0, 27.8, 50.0):
            assert dec._default_softmax_mode(dt, cap) == jdecode._default_softmax_mode(
                jnp.dtype(jdt), cap)
    assert dec._default_softmax_mode(torch.float8_e4m3fn, 50.0) == "online"
    q = torch.zeros(1, 2, 32)
    k = torch.zeros(1, 64, 1, 32)
    with pytest.raises(NotImplementedError, match="BHSD"):
        dec.flash_decode(q, k, k, window=16)  # the BSHD layout
    with pytest.raises(NotImplementedError, match="BHSD"):
        dec.flash_decode_chunk(q[:, None], k, k, kv_length=torch.tensor([64], dtype=torch.int32),
                               logit_softcap=30.0, kv_layout="bshd")
    with pytest.raises(ValueError, match="window"):
        dec.flash_decode(q, k.transpose(1, 2), k.transpose(1, 2), window=0, kv_layout="bhsd")


# --- models/gemma2.py --------------------------------------------------------

def _params(quant: str):
    jp = jgemma2.init_params(jgemma2.GEMMA2_TINY, jax.random.PRNGKey(0))
    if quant == "int8":
        jp = jgemma2.quantize_weights(jp)
    return jp, bridge.params_from_jax(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def float_params():
    return _params("float")


@pytest.fixture(scope="module")
def int8_params():
    return _params("int8")


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, (1, n)).astype(np.int32)


def test_bridge_and_quantize_weights_match_jax(float_params):
    """The bridge carries Gemma's params (zero-centred norms included) as
    they are; the port's int8 quantization equals JAX's bit for bit and
    leaves tok_emb (the tied head) float."""
    jp, tp = float_params
    np.testing.assert_array_equal(tp["blocks"][0]["post_mlp_norm"].numpy(),
                                  np.asarray(jp["blocks"][0]["post_mlp_norm"]))
    assert not tp["final_norm"].any()
    jq = jgemma2.quantize_weights(jp)
    tq = gemma2.quantize_weights(tp)
    for name in ("wq", "wo", "w_gate", "w_down"):
        for i in (0, 1):
            np.testing.assert_array_equal(tq["blocks"][1][name][i].numpy(),
                                          np.asarray(jq["blocks"][1][name][i]))
    assert isinstance(tq["tok_emb"], torch.Tensor)


@pytest.mark.parametrize("quant", ["float", "int8"])
def test_prefill_and_forward_match_jax(float_params, int8_params, quant):
    """A 24-token prompt (past the window of 16: the sliding layer and the
    global one differ) through prefill_with_kv (clamped) and forward
    (online): logits and each layer's K/V against JAX's in interpret
    mode.  The final logits stay inside the cap."""
    jp, tp = float_params if quant == "float" else int8_params
    toks = _prompt(3, 24)
    pos = np.arange(24, dtype=np.int32)[None]
    jl, jkv = _jitted(jgemma2.prefill_with_kv, jgemma2.GEMMA2_TINY)(jp, jnp.asarray(toks),
                                                                     jnp.asarray(pos))
    tl, tkv = gemma2.prefill_with_kv(tp, torch.from_numpy(toks).long(), torch.from_numpy(pos), CFG)
    assert tl.shape == (1, 24, CFG.vocab_size) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-4)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)
    assert float(tl.abs().max()) <= CFG.final_logit_softcap
    jf = _jitted(jgemma2.forward, jgemma2.GEMMA2_TINY)(jp, jnp.asarray(toks))
    tf = gemma2.forward(tp, torch.from_numpy(toks).long(), CFG)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=LOGIT_TOL)
    wide = dataclasses.replace(CFG, sliding_window=1000)
    assert not np.allclose(gemma2.forward(tp, torch.from_numpy(toks).long(), wide)[0, -1].numpy(),
                           tf[0, -1].numpy(), atol=1e-5)


@pytest.mark.parametrize("quant,kv_mode", [("float", "none"), ("float", "int8"),
                                           ("float", "fp8"), ("int8", "none"),
                                           ("int8", "int8"), ("int8", "fp8")])
def test_decode_step_matches_jax(float_params, int8_params, quant, kv_mode):
    """Two sequences prefilled to 14 and 10 tokens (the bridge carries the
    JAX cache over), then 6 decode steps that cross the window of 16 (K2's
    append, K1 with the sliding layer's window and the softcap; fp8 KV
    runs online, as JAX's default rule has it): logits every step, and the
    caches' lengths and K values at the end."""
    jp, tp = float_params if quant == "float" else int8_params
    jcfg = jgemma2.GEMMA2_TINY
    jcache = jgemma2.make_cache(jcfg, 2, 64, mode=kv_mode)
    for b, n in enumerate((14, 10)):
        toks = _prompt(5 + b, n)
        _, kvs = _jitted(jgemma2.prefill_with_kv, jcfg)(jp, jnp.asarray(toks),
                                                        jnp.arange(n)[None])
        for i, (k, v) in enumerate(kvs):
            jcache = jcache.insert_at(i, b, k[0], v[0], 0)
        jcache = jcache.set_length(b, n)
    tcache = bridge.kv_cache_from_jax(jax.device_get(jcache), device="cpu")
    jstep = jax.jit(lambda p, t, c: jgemma2.decode_step(p, t, jcfg, c, interpret=True))
    toks = np.random.default_rng(9).integers(0, CFG.vocab_size, (6, 2)).astype(np.int32)
    for step in range(6):
        jl, jcache = jstep(jp, jnp.asarray(toks[step]), jcache)
        tl, tcache = gemma2.decode_step(tp, torch.from_numpy(toks[step]).long(), CFG, tcache)
        assert tl.shape == (2, CFG.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))
    got = bridge.kv_cache_from_jax(jax.device_get(jcache), device="cpu")
    np.testing.assert_allclose(tcache.k[0].float().numpy(), got.k[0].float().numpy(),
                               atol=0.51 if kv_mode == "int8" else 0.07)


# prompts longer than the window of 16 (and one shorter), through two slots
PROMPTS = [list(range(40, 70)), [5, 6, 7, 8, 9], list(range(100, 121)), [300, 2, 41] * 7]
MAX_TOKENS = [6, 4, 7, 5]


@pytest.mark.parametrize("kv_mode", ["none", "int8", "fp8"])
def test_engine_greedy_tokens_equal_jax(int8_params, kv_mode):
    """The Gemma adapter (int8 weights) through InferenceEngine, two
    slots, one prompt a prefill call (no prefill_packed, as in JAX):
    every generated token equals the JAX engine's."""
    jp, tp = int8_params
    jeng = JEngine(jp, jgemma2.make_adapter(jgemma2.GEMMA2_TINY, interpret=True), max_batch=2,
                   capacity=64, kv_mode=kv_mode, cache_dtype=jnp.float32)
    teng = InferenceEngine(tp, gemma2.make_adapter(CFG), max_batch=2, capacity=64,
                           kv_mode=kv_mode, cache_dtype=torch.float32, device="cpu")
    jreqs = [jeng.submit(p, max_tokens=n) for p, n in zip(PROMPTS, MAX_TOKENS)]
    treqs = [teng.submit(p, max_tokens=n) for p, n in zip(PROMPTS, MAX_TOKENS)]
    jeng.run()
    teng.run()
    for jr, tr, n in zip(jreqs, treqs, MAX_TOKENS):
        assert tr.done and len(tr.generated) == n
        assert tr.generated == jr.generated
    assert teng.packed_prefills == 0
    assert teng.metrics.decode_tokens == jeng.metrics.decode_tokens


def test_convert_hf_state_dict_matches_hf():
    """HF Gemma2ForCausalLM built from config (random init, no download,
    as tests/test_gemma2.py does it): the converted params equal JAX's
    conversion, and the port's forward matches HF's logits (fp32 on both
    sides; HF's eager attention takes another op order)."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hcfg = transformers.Gemma2Config(
        vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        max_position_embeddings=128, sliding_window=16, query_pre_attn_scalar=16,
        rope_theta=10000.0, attn_implementation="eager")
    model = transformers.Gemma2ForCausalLM(hcfg).eval()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    params, dims = gemma2.convert_hf_state_dict(sd, device="cpu")
    jparams, jdims = jgemma2.convert_hf_state_dict(sd)
    assert dims == jdims
    np.testing.assert_array_equal(params["blocks"][1]["wq"].numpy(),
                                  np.asarray(jparams["blocks"][1]["wq"]))
    np.testing.assert_array_equal(params["blocks"][0]["pre_mlp_norm"].numpy(),
                                  np.asarray(jparams["blocks"][0]["pre_mlp_norm"]))
    tokens = np.random.RandomState(1).randint(0, 512, size=(2, 24))
    with torch.no_grad():
        want = model(torch.tensor(tokens)).logits.numpy()
    got = gemma2.forward(params, torch.from_numpy(tokens), CFG)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)

"""A sliding-window Llama (Mistral-7B's layout) and the logit softcap on
every serving path of the port, against the JAX package on the CPU.

The ops first, at tiny shapes, with windows smaller than, equal to and
larger than a key tile or a page, ``window=1``, lengths below and past
the window and a softcap: ``flash_decode_chunk`` (K1c's plain version)
against JAX's jnp oracle ``_decode_chunk_jnp``, ``paged_flash_decode``
and ``paged_flash_decode_chunk`` (K8's and K8c's) against JAX's kernel in
interpret mode, and ``flash_attention`` with segment ids and positions
and a window (K4's masked instance: packed and chunk form) against JAX's
in interpret mode.  Then the models: ``LLAMA_TINY`` with a window of 6
and with a softcap through ``prefill_packed``, ``prefill_chunk``,
``decode_multi``, ``decode_step_paged`` and ``prefill_suffix_paged``; and
the engines, greedy tokens equal to JAX's with prompts past the window
(packed, chunked, paged with a prefix cache, n-gram), ``MIXTRAL_TINY``
windowed through packed prefill and ``decode_multi``.

Inputs are made with numpy from a seed and handed to both sides; the
params go through the bridge.  JAX runs its model functions jitted, its
Pallas kernels in interpret mode; the port runs the plain versions of its
kernels.  Everything is fp32 on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.engine.engine import InferenceEngine as JEngine
from flash_attn_tpu.engine.engine import PagedInferenceEngine as JPagedEngine
from flash_attn_tpu.engine.engine import SpecConfig as JSpecConfig
from flash_attn_tpu.engine.kv_cache import KVCache as JKVCache
from flash_attn_tpu.engine.paged import PagedKVPool as JPool
from flash_attn_tpu.models import llama as jllama
from flash_attn_tpu.models import mixtral as jmx
from flash_attn_tpu.ops import quant as jquant
from flash_attn_tpu.ops.attention import flash_attention as j_flash_attention
from flash_attn_tpu.ops.decode import _decode_chunk_jnp
from flash_attn_tpu.ops.paged_decode import paged_flash_decode as j_paged_decode
from flash_attn_tpu.ops.paged_decode import paged_flash_decode_chunk as j_paged_chunk
from flash_attn_tpu_torch import bridge, flash_attention
from flash_attn_tpu_torch.engine.engine import (
    InferenceEngine,
    PagedInferenceEngine,
    SpecConfig,
)
from flash_attn_tpu_torch.models import llama
from flash_attn_tpu_torch.models import mixtral as mx
from flash_attn_tpu_torch.ops.decode import flash_decode_chunk
from flash_attn_tpu_torch.ops.paged_decode import paged_flash_decode, paged_flash_decode_chunk
from _torch_threads import one_torch_thread  # noqa: F401

# fp32 on both sides, the ops differ only in the order of fp32 sums, the
# split-KV merge and, for 1-byte caches, where each side multiplies the
# scales in: 1e-4 on outputs of ~1 and on the LSE
OP_TOL = 1e-4
# model logits (~0.1 at this init): fp32 summation order moves them ~1e-6,
# an int8/fp8 KV value rounded to its neighbouring code by that order by
# up to ~1e-3 (tests/test_torch_llama.py's bound)
LOGIT_TOL = 2e-3
WINDOW = 6
CFG = dataclasses.replace(llama.LLAMA_TINY, sliding_window=WINDOW)
JCFG = dataclasses.replace(jllama.LLAMA_TINY, sliding_window=WINDOW)
# a cap below this init's scores (|s| up to ~0.1), so that it bends them
CAP = 0.02
CAP_CFG = dataclasses.replace(llama.LLAMA_TINY, attn_logit_softcap=CAP)
JCAP_CFG = dataclasses.replace(jllama.LLAMA_TINY, attn_logit_softcap=CAP)


def _np(t):
    return t.detach().float().numpy()


def _bridge(tree):
    return bridge.params_from_jax(jax.device_get(tree), device="cpu")


# --- flash_decode_chunk (K1c) against JAX's jnp oracle ---------------------

# (kv type, T, window, softcap, lengths): a window of 1, below a key tile
# (5), exactly one (64) and above it (100); lengths below the window, at
# it and far past it; a softcap with and without a window
CHUNK_CASES = [
    ("none", 3, 1, None, [70, 3]),
    ("none", 5, 5, None, [200, 4]),
    ("int8", 5, 64, None, [200, 64]),
    ("fp8", 4, 100, None, [230, 90]),
    ("int8", 5, None, 2.0, [150, 7]),
    ("fp8", 2, 37, 2.0, [180, 41]),
]


_ORACLE = jax.jit(_decode_chunk_jnp, static_argnames=("scale", "return_lse", "window",
                                                     "logit_softcap"))


@pytest.mark.parametrize("kv,T,window,cap,lens", CHUNK_CASES)
def test_flash_decode_chunk_window_softcap_matches_jnp_oracle(kv, T, window, cap, lens):
    """fp32 q over a BHSD cache of 256 (fp32, or int8 or fp8 with their
    scales), GQA 4/2, 1 and 3 splits of the windowed live walk,
    against ``_decode_chunk_jnp`` on the same cache as BSHD; the fp8
    default is the clamped softmax (its scores stay far below the
    ceiling), the others online."""
    r = np.random.default_rng(len(lens) * 7 + T)
    B, S, Hk, H, D = 2, 256, 2, 4, 32
    k = r.standard_normal((B, S, Hk, D)).astype(np.float32)
    v = r.standard_normal((B, S, Hk, D)).astype(np.float32)
    q = r.standard_normal((B, T, H, D)).astype(np.float32)
    ks = vs = None
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    if kv != "none":
        jk, ks, jv, vs = jquant.quantize_kv(jk, jv, kv)
    kv_length = np.array(lens, np.int32)
    jo, jl = _ORACLE(jnp.asarray(q), jk, jv, jnp.asarray(kv_length), scale=D ** -0.5,
                     k_scale=ks, v_scale=vs, return_lse=True, window=window, logit_softcap=cap)
    jo, jl = np.asarray(jo), np.asarray(jl)

    def bhsd(x):  # [B, S, Hk, ...] -> [B, Hk, S, ...]
        return bridge.to_torch(x, device="cpu").transpose(1, 2).contiguous()

    tk, tv = bhsd(jk), bhsd(jv)
    tks = None if ks is None else bhsd(ks)[..., 0].float()
    tvs = None if vs is None else bhsd(vs)[..., 0].float()
    # a row that sees no key (a chunk longer than its sequence): lse -inf
    # in the oracle, -1e30 in the port
    live = np.isfinite(jl)
    for num_splits in (1, 3):
        to, tl = flash_decode_chunk(torch.from_numpy(q), tk, tv,
                                    kv_length=torch.from_numpy(kv_length), k_scale=tks,
                                    v_scale=tvs, window=window, logit_softcap=cap,
                                    num_splits=num_splits, return_lse=True, kv_layout="bhsd")
        np.testing.assert_allclose(to.numpy(), jo, atol=OP_TOL, rtol=OP_TOL)
        np.testing.assert_allclose(tl.numpy()[live], jl[live], atol=OP_TOL, rtol=OP_TOL)
        assert (tl.numpy()[~live] <= -1e29).all()


# --- paged decode (K8) and chunk (K8c) against JAX in interpret mode -------

PAGE, NPAGES, MAXP, HK, D = 8, 16, 4, 2, 32
TABLE = [[9, 3, 14, 6], [1, 12, 5, 10]]


def _paged_inputs(mode, lens, seed):
    """The same tokens in a JAX pool and the port's (pages of 8, a
    shuffled table), lengths set; (JAX args, JAX kwargs, port args, port
    kwargs) of a paged decode over layer 0 with 4 query heads."""
    r = np.random.default_rng(seed)
    B = len(lens)
    k = r.standard_normal((MAXP * PAGE, HK, D)).astype(np.float32)
    v = r.standard_normal((MAXP * PAGE, HK, D)).astype(np.float32)
    jp = JPool.create(1, NPAGES, PAGE, B, MAXP, HK, D, dtype=jnp.float32, mode=mode)
    for b in range(B):
        jp = jp.assign_pages(b, TABLE[b])
        jp = jp.append_prefill(0, b, jnp.asarray(k * (b + 1)), jnp.asarray(v - b), 0)
    jp = jp.set_lengths(lens)
    tp = bridge.paged_pool_from_jax(jax.device_get(jp), device="cpu")
    ks = None if jp.k_scale is None else jp.k_scale[0]
    vs = None if jp.v_scale is None else jp.v_scale[0]
    jargs = (jp.k_pages[0], jp.v_pages[0], jp.block_table, jp.length)
    targs = (tp.k_pages[0], tp.v_pages[0], tp.block_table, tp.length)
    tkw = {} if tp.k_scale is None else {"k_scale": tp.k_scale[0], "v_scale": tp.v_scale[0]}
    return jargs, dict(k_scale=ks, v_scale=vs, scales_permuted=jp.scales_permuted), targs, tkw


# (kv type, T (1: decode mode), window, softcap, lengths): windows of 1,
# below a page (5), a page (8) and above one (13), lengths below, at and
# past them
PAGED_CASES = [
    ("none", 1, 1, None, [30, 1]),
    ("int8", 1, 5, None, [29, 3]),
    ("fp8", 1, 13, 2.0, [32, 13]),
    ("none", 1, None, 2.0, [21, 9]),
    ("none", 4, 8, None, [27, 8]),
    ("int8", 3, 13, None, [31, 14]),
    ("fp8", 5, 5, 2.0, [26, 6]),
]


@pytest.mark.parametrize("kv,T,window,cap,lens", PAGED_CASES)
def test_paged_window_softcap_matches_jax(kv, T, window, cap, lens):
    """``paged_flash_decode`` (T = 1) and ``paged_flash_decode_chunk``
    with a window and the softcap, 1 and 3 splits, against JAX's in
    interpret mode; the default softmax mode on both sides (fp8: clamped,
    its scores far below the ceiling)."""
    jargs, jkw, targs, tkw = _paged_inputs(kv, lens, seed=len(lens) + T)
    r = np.random.default_rng(T)
    if T == 1:
        q = r.standard_normal((len(lens), 4, D)).astype(np.float32)
        jo, jl = j_paged_decode(jnp.asarray(q), *jargs, **jkw, window=window,
                                logit_softcap=cap, interpret=True, return_lse=True)
        calls = [paged_flash_decode(torch.from_numpy(q), *targs, **tkw, window=window,
                                    logit_softcap=cap, num_splits=n, return_lse=True)
                 for n in (1, 3)]
    else:
        q = r.standard_normal((len(lens), T, 4, D)).astype(np.float32)
        jo, jl = j_paged_chunk(jnp.asarray(q), *jargs, **jkw, window=window,
                               logit_softcap=cap, interpret=True, return_lse=True)
        calls = [paged_flash_decode_chunk(torch.from_numpy(q), *targs, **tkw, window=window,
                                          logit_softcap=cap, num_splits=n, return_lse=True)
                 for n in (1, 3)]
    for to, tl in calls:
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=OP_TOL, rtol=OP_TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=OP_TOL, rtol=OP_TOL)


# --- K4 with segment ids, positions and a window ---------------------------

def _fa_pair(q, k, v, **kw):
    """(JAX's flash_attention in interpret mode, the port's) on the same
    numpy inputs, each (out, lse)."""
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    tkw = {n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    jo, jl = j_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), return_lse=True,
                               interpret=True, **jkw)
    to, tl = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                             return_lse=True, **tkw)
    return (np.asarray(jo), np.asarray(jl)), (to.numpy(), tl.numpy())


@pytest.mark.parametrize("form,window,cap,mode", [
    ("packed", (5, -1), None, "clamped"),
    ("packed", (0, -1), None, "online"),
    ("packed", (70, -1), 2.0, "clamped"),
    ("chunk", (5, -1), None, "clamped"),
    ("chunk", (63, -1), 2.0, "online"),
    ("chunk", (3, 2), None, "clamped"),
])
def test_flash_attention_masks_window_matches_jax(form, window, cap, mode):
    """The packed form (three prompts of 90, 40 and 30 in one row of 168,
    the last 8 padding: segment ids 1-3 and 0, positions restarting a
    prompt) and the chunk form (a chunk of 24 at positions 60-83 over a
    cache of 128 at its indices, no segment ids), GQA 4/2, q rotated in
    the kernel, with a window that compares the positions (of 1, 6, 64
    and 71 keys, and a two-sided one) and the softcap: against JAX's
    flash_attention in interpret mode.  A window wider than every prompt
    leaves the output as it is without one."""
    r = np.random.default_rng(window[0] + 3)
    H, Hk, Dh = 4, 2, 32
    if form == "packed":
        lens = (90, 40, 30)
        S = 168
        seg = np.concatenate([np.full(n, i + 1) for i, n in enumerate(lens)]
                             + [np.zeros(S - sum(lens))]).astype(np.int32)[None]
        pos = np.concatenate([np.arange(n) for n in lens]
                             + [np.zeros(S - sum(lens))]).astype(np.int32)[None]
        kw = dict(q_segment_ids=seg, kv_segment_ids=seg, q_positions=pos, kv_positions=pos)
        Sq, Sk = S, S
    else:
        Sq, Sk, start = 24, 128, 60
        kw = dict(q_positions=(start + np.arange(Sq, dtype=np.int32))[None],
                  kv_positions=np.arange(Sk, dtype=np.int32)[None])
        pos = kw["q_positions"]
    q = r.standard_normal((1, Sq, H, Dh)).astype(np.float32)
    k = r.standard_normal((1, Sk, Hk, Dh)).astype(np.float32)
    v = r.standard_normal((1, Sk, Hk, Dh)).astype(np.float32)
    inv = 1.0 / 10000.0 ** (np.arange(0, Dh, 2) / Dh)
    ang = pos[0][:, None].astype(np.float32) * inv[None]
    kw.update(rope_cos=np.cos(ang).astype(np.float32), rope_sin=np.sin(ang).astype(np.float32),
              window=window, logit_softcap=cap, softmax_mode=mode)
    (jo, jl), (to, tl) = _fa_pair(q, k, v, **kw)
    np.testing.assert_allclose(to, jo, atol=OP_TOL, rtol=OP_TOL)
    live = jl > -1e29
    np.testing.assert_allclose(tl[live], jl[live], atol=OP_TOL, rtol=OP_TOL)
    assert (tl[~live] <= -1e29).all()
    if form == "packed" and window[0] >= 90 - 1:
        kw["window"] = None
        _, (to2, _) = _fa_pair(q, k, v, **kw)
        np.testing.assert_array_equal(to, to2)


# --- the model paths --------------------------------------------------------

def _jit(fn, cfg):
    """A JAX model function with ``cfg`` and interpret mode bound, jitted:
    the decode steps take ``cfg`` before their cache or pool, the
    prefills last."""
    if fn.__name__.startswith("decode"):
        return jax.jit(lambda p, t, c: fn(p, t, cfg, c, interpret=True))
    return jax.jit(lambda p, *args: fn(p, *args, cfg, interpret=True))


@pytest.fixture(scope="module")
def params():
    """{"float" | "int8": (JAX params, the port's)}: the int8 tree is
    quantized by each package from the same float weights."""
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    jq = jax.jit(jllama.quantize_weights)(jp)
    return {"float": (jp, _bridge(jp)), "int8": (jq, llama.quantize_weights(_bridge(jp)))}


LOCAL_CFGS = {"window": (CFG, JCFG), "softcap": (CAP_CFG, JCAP_CFG)}


@pytest.mark.parametrize("local", list(LOCAL_CFGS))
def test_prefill_packed_and_chunk_match_jax(params, local):
    """``prefill_packed`` (prompts of 14, 9 and 3 in a row of 32, each past
    the window of 6 but the last) and ``prefill_chunk`` (two chunks of 10
    into an fp8 cache, each chunk's cache and logits) against JAX's, with
    the window and with the softcap; the option moves the logits."""
    cfg, jcfg = LOCAL_CFGS[local]
    jp, tp = params["float"]
    r = np.random.default_rng(11)
    lens = (14, 9, 3)
    toks = r.integers(0, cfg.vocab_size, (1, 32)).astype(np.int32)
    seg = np.concatenate([np.full(n, i + 1) for i, n in enumerate(lens)]
                         + [np.zeros(32 - sum(lens))]).astype(np.int32)[None]
    pos = np.concatenate([np.arange(n) for n in lens]
                         + [np.zeros(32 - sum(lens))]).astype(np.int32)[None]
    jl, _ = _jit(jllama.prefill_packed, jcfg)(jp, *(jnp.asarray(x) for x in (toks, pos, seg)))
    targs = [torch.from_numpy(x).long() for x in (toks, pos, seg)]
    tl, _ = llama.prefill_packed(tp, *targs, cfg)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
    glob, _ = llama.prefill_packed(tp, *targs, llama.LLAMA_TINY)
    assert float((tl - glob).abs().max()) > 1e-4
    jcache = jllama.make_cache(jcfg, 1, 32, mode="fp8")
    tcache = llama.make_cache(cfg, 1, 32, mode="fp8", device="cpu")
    chunk = r.integers(0, cfg.vocab_size, (1, 20)).astype(np.int32)
    jchunk = jax.jit(lambda p, t, c, s: jllama.prefill_chunk(p, t, jcfg, c, 0, s,
                                                             interpret=True))
    for start in (0, 10):
        part = chunk[:, start:start + 10]
        jl, jcache = jchunk(jp, jnp.asarray(part), jcache, jnp.int32(start))
        tl, tcache = llama.prefill_chunk(tp, torch.from_numpy(part).long(), cfg, tcache, 0,
                                         start)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
    got = bridge.kv_cache_from_jax(jax.device_get(jcache), device="cpu")
    for name in ("k", "v", "k_scale", "v_scale"):
        for mine, theirs in zip(getattr(tcache, name), getattr(got, name)):
            np.testing.assert_allclose(_np(mine), _np(theirs), atol=1e-5)


def _filled(jp, tp, jcfg, cfg, toks, capacity, mode):
    """JAX's and the port's caches holding ``toks`` [B, S] after JAX's
    prefill (the same KV on both sides, through the bridge)."""
    B, S = toks.shape
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    _, jkv = _jit(jllama.prefill_with_kv, jcfg)(jp, jnp.asarray(toks), jnp.asarray(pos))
    jcache = jllama.make_cache(jcfg, B, capacity, mode=mode)
    for i, (k, v) in enumerate(jkv):
        jcache = jcache.append(i, k, v)
    jcache = jcache.advance(S)
    return jcache, bridge.kv_cache_from_jax(jax.device_get(jcache), device="cpu")


@pytest.mark.parametrize("local,kv_mode", [("window", "int8"), ("softcap", "fp8")])
def test_decode_multi_matches_jax(params, local, kv_mode):
    """``decode_multi`` (K1c's plain version) with T = 4 after 12 cached
    tokens (the window of 6 cuts each row at its own limit) at int8
    weights: two rounds, logits and the cache against JAX's."""
    cfg, jcfg = LOCAL_CFGS[local]
    jp, tp = params["int8"]
    r = np.random.default_rng(3)
    jcache, tcache = _filled(jp, tp, jcfg, cfg, r.integers(0, 512, (2, 12)).astype(np.int32),
                             32, kv_mode)
    jmulti = _jit(jllama.decode_multi, jcfg)
    for _ in range(2):
        toks = r.integers(0, 512, (2, 4)).astype(np.int32)
        jl, jcache = jmulti(jp, jnp.asarray(toks), jcache)
        tl, tcache = llama.decode_multi(tp, torch.from_numpy(toks).long(), cfg, tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))


@pytest.mark.parametrize("local", list(LOCAL_CFGS))
def test_paged_suffix_and_decode_match_jax(params, local):
    """``prefill_suffix_paged`` (a suffix of 12 after a resident prefix of
    16, so the first rows' windows start inside the prefix) and two
    ``decode_step_paged`` steps (K8's plain version, a second slot at 3
    tokens), fp8 pages of 8, against JAX's."""
    cfg, jcfg = LOCAL_CFGS[local]
    jp, tp = params["float"]
    r = np.random.default_rng(9)
    jpool = JPool.create(cfg.num_layers, 17, 8, 2, 8, cfg.num_kv_heads, cfg.head_dim,
                         dtype=jnp.float32, mode="fp8")
    jpool = jpool.assign_pages(0, list(range(1, 9))).assign_pages(1, list(range(9, 17)))
    prefix = r.integers(0, 512, (1, 16)).astype(np.int32)
    pos = np.arange(16, dtype=np.int32)[None]
    _, jkv = _jit(jllama.prefill_with_kv, jcfg)(jp, jnp.asarray(prefix), jnp.asarray(pos))
    for layer, (k, v) in enumerate(jkv):
        jpool = jpool.append_prefill(layer, 0, k[0], v[0], 0)
        jpool = jpool.append_prefill(layer, 1, k[0, :3], v[0, :3], 0)
    jpool = jpool.set_lengths([16, 3])
    tpool = bridge.paged_pool_from_jax(jax.device_get(jpool), device="cpu")
    suffix = r.integers(0, 512, (1, 12)).astype(np.int32)
    jl, jpool = jax.jit(lambda p, t, pool: jllama.prefill_suffix_paged(
        p, t, jcfg, pool, 0, 16, interpret=True))(jp, jnp.asarray(suffix), jpool)
    tl, tpool = llama.prefill_suffix_paged(tp, torch.from_numpy(suffix).long(), cfg, tpool, 0,
                                           16)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
    jpool, tpool = jpool.set_lengths([28, 3]), tpool.set_lengths([28, 3])
    jdec = _jit(jllama.decode_step_paged, jcfg)
    toks = np.array([int(np.asarray(jl)[0, -1].argmax()), 5], np.int32)
    for _ in range(2):
        jl, jpool = jdec(jp, jnp.asarray(toks), jpool)
        tl, tpool = llama.decode_step_paged(tp, torch.from_numpy(toks).long(), cfg, tpool)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
        toks = np.asarray(jl).argmax(-1).astype(np.int32)


# --- the engines ------------------------------------------------------------

def _run(engine, requests):
    reqs = [engine.submit(p, max_tokens=n) for p, n in requests]
    engine.run()
    assert all(r.done and len(r.generated) == n for r, (_, n) in zip(reqs, requests))
    return [list(r.generated) for r in reqs]


# prompts past the window of 6 but one; their greedy continuations run
# further past it
PROMPTS = [[5, 6, 7, 8, 9, 10, 11, 12, 13], list(range(40, 60)), [300, 2, 41], list(range(90, 101))]
MAX_TOKENS = [6, 4, 7, 5]
ENGINE_CASES = {
    "packed": ("contiguous", "int8", {}),
    "chunked": ("contiguous", "fp8", {"prefill_chunk_size": 8}),
    "n-gram": ("contiguous", "none", {"spec": "ngram"}),
    "paged-prefix": ("paged", "int8", {"prefix_cache": True, "num_pages": 17}),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_tokens_equal_jax(params, case):
    """Both engines with the window of 6 at int8 weights, two slots:
    packed prefill (the default), chunks of 8, n-gram speculation (3
    drafts, the verify step on K1c's plain version) and the paged engine
    with a prefix cache (a second wave that hits the first wave's 16-token
    prefix; the suffix prefill on K8c's, the steps on K8's): every greedy
    token equals the JAX engine's."""
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


MX_CFG = dataclasses.replace(mx.MIXTRAL_TINY, sliding_window=WINDOW)
JMX_CFG = dataclasses.replace(jmx.MIXTRAL_TINY, sliding_window=WINDOW)


def test_mixtral_windowed_packed_and_decode_multi_match_jax():
    """``MIXTRAL_TINY`` with the window of 6: ``prefill_packed`` (prompts
    of 12 and 7 in a row of 20) and two ``decode_multi`` rounds of T = 3
    over the prefix's cache, logits against JAX's."""
    jp = jmx.init_params(JMX_CFG, jax.random.PRNGKey(1))
    tp = _bridge(jp)
    r = np.random.default_rng(4)
    toks = r.integers(0, 512, (1, 20)).astype(np.int32)
    seg = np.array([[1] * 12 + [2] * 7 + [0]], np.int32)
    pos = np.array([list(range(12)) + list(range(7)) + [0]], np.int32)
    jl, _ = jax.jit(lambda p, t, ps, s: jmx.prefill_packed(p, t, ps, s, JMX_CFG, interpret=True))(
        jp, *(jnp.asarray(x) for x in (toks, pos, seg)))
    tl, _ = mx.prefill_packed(tp, *(torch.from_numpy(x).long() for x in (toks, pos, seg)), MX_CFG)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
    pre = toks[:, :12]
    _, jkv = jax.jit(lambda p, t, ps: jmx.prefill_with_kv(p, t, ps, JMX_CFG, interpret=True))(
        jp, jnp.asarray(pre), jnp.asarray(pos[:, :12]))
    jcache = JKVCache.create(JMX_CFG.num_layers, 1, 32, JMX_CFG.num_kv_heads, JMX_CFG.head_dim,
                             dtype=jnp.float32)
    for i, (k, v) in enumerate(jkv):
        jcache = jcache.append(i, k, v)
    jcache = jcache.advance(12)
    tcache = bridge.kv_cache_from_jax(jax.device_get(jcache), device="cpu")
    jmulti = jax.jit(lambda p, t, c: jmx.decode_multi(p, t, JMX_CFG, c, interpret=True))
    for _ in range(2):
        t3 = r.integers(0, 512, (1, 3)).astype(np.int32)
        jl, jcache = jmulti(jp, jnp.asarray(t3), jcache)
        tl, tcache = mx.decode_multi(tp, torch.from_numpy(t3).long(), MX_CFG, tcache)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)

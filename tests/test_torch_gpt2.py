"""GPT-2 serving in the port against the JAX package, on the CPU, at
head_dim 64 (GPT-2 124M's): K4's plain version causal, shifted and with
segment ids and positions; the chunk kernel's (K1c/K8c) and K8's plain
versions; ``models/gpt2.py``'s chunked and packed prefill, paged step,
position clamp past ``max_position`` and ``greedy_decode`` in fp32 and
bf16; ``init_params``; the HF conversion against ``GPT2LMHeadModel``
built from config; and both engines token for token against JAX's
(tests/test_torch_gpt2_models.py holds ``forward``, ``prefill_with_kv``,
``prefill``, the decode step and the verify step).

Inputs are made with numpy (or JAX's init, handed over through
``bridge``) and given to both sides.  JAX runs its model functions jitted
and its Pallas kernels in interpret mode or through its plain oracles
(``mha_reference``, ``_decode_chunk_jnp``); the port runs the plain
versions of its kernels.  Each tolerance is stated with its reason.
"""

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.engine.engine import InferenceEngine as JEngine
from flash_attn_tpu.engine.engine import PagedInferenceEngine as JPagedEngine
from flash_attn_tpu.engine.engine import SpecConfig as JSpecConfig
from flash_attn_tpu.engine.paged import PagedKVPool as JPool
from flash_attn_tpu.models import gpt2 as jgpt2
from flash_attn_tpu.ops import decode as jdecode
from flash_attn_tpu.ops import quant as jquant
from flash_attn_tpu.ops.paged_decode import paged_flash_decode as j_paged_decode
from flash_attn_tpu.ops.reference import mha_reference as j_mha_reference
from flash_attn_tpu.runtime import abi as jabi
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.engine.engine import (
    InferenceEngine,
    PagedInferenceEngine,
    SpecConfig,
)
from flash_attn_tpu_torch.engine.paged import PagedKVPool
from flash_attn_tpu_torch.models import gpt2
from flash_attn_tpu_torch.ops import decode as dec
from flash_attn_tpu_torch.ops import flash_fwd as ff
from flash_attn_tpu_torch.ops import paged_decode as pd
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
# bf16 attention outputs of O(1) values: one or two bf16 ulps
BF16_TOL = 2e-2


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


@pytest.mark.parametrize("dtype", DTYPES)
def test_config_and_bridge(dtype):
    """The config's derived widths, and the bridge carries every leaf of
    JAX's params dict unchanged (float arrays of both dtypes)."""
    dtype, jp, tp, _, cfg = _params(dtype)
    assert cfg.head_dim == 64 and gpt2.GPT2_124M.head_dim == 64
    assert gpt2.GPT2_TINY.head_dim == 32 and cfg.torch_dtype == getattr(torch, dtype)
    jl, _ = jax.tree_util.tree_flatten(jp)
    tl = [tp["wte"], tp["wpe"]]
    for blk in tp["blocks"]:
        for part in ("ln_1", "attn", "ln_2", "mlp"):
            tl += jax.tree_util.tree_leaves(blk[part])
    tl += jax.tree_util.tree_leaves(tp["ln_f"])
    assert len(jl) == len(tl)
    for a, b in zip(sorted(jl, key=lambda x: (x.shape, float(jnp.sum(x.astype(jnp.float32))))),
                    sorted(tl, key=lambda x: (tuple(x.shape), float(x.float().sum())))):
        assert b.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(_np(b), _np(a))


# --- the kernels' plain versions at head_dim 64 ---------------------------

@pytest.mark.parametrize("softmax_mode", ["online", "clamped"])
@pytest.mark.parametrize("B,Sq,Sk", [(2, 70, 70), (1, 37, 101)])
def test_flash_fwd_d64_matches_reference(B, Sq, Sk, softmax_mode):
    """K4's plain version at head_dim 64, multi-head (GPT-2: H = Hk),
    causal (a square and a shifted, ragged shape), fp32: out and lse
    against JAX's exact mha_reference."""
    H = 3
    r = np.random.default_rng(Sq + Sk)
    q, k, v = (r.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, 64), (B, Sk, H, 64), (B, Sk, H, 64)))
    to, tl = ff.flash_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=True, softmax_mode=softmax_mode)
    jo, jl = j_mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                             return_lse=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("softmax_mode", ["online", "clamped"])
def test_flash_fwd_d64_segments_and_positions_match_reference(softmax_mode):
    """K4's plain version at head_dim 64 with segment ids and positions,
    as a packed prefill calls it (three prompts of 30, 21 and 9 tokens in
    a 64-token row, padding 0): against mha_reference with the segment ids
    and the positions' mask as an additive bias, on the live rows."""
    lens = (30, 21, 9)
    seg = np.zeros((1, 64), np.int32)
    pos = np.zeros((1, 64), np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[0, off:off + n] = i + 1
        pos[0, off:off + n] = np.arange(n)
        off += n
    r = np.random.default_rng(7)
    q, k, v = (r.standard_normal((1, 64, 2, 64)).astype(np.float32) for _ in range(3))
    to, tl = ff.flash_fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          q_segment_ids=torch.from_numpy(seg), kv_segment_ids=torch.from_numpy(seg),
                          q_positions=torch.from_numpy(pos), kv_positions=torch.from_numpy(pos),
                          softmax_mode=softmax_mode)
    bias = np.where(pos[:, None, :, None] >= pos[:, None, None, :], 0.0, -1e30).astype(np.float32)
    jo, jl = j_mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(bias),
                             q_segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(seg),
                             return_lse=True)
    np.testing.assert_allclose(to.numpy()[:, :off], np.asarray(jo)[:, :off], atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(tl.numpy()[..., :off], np.asarray(jl)[..., :off], atol=F32_TOL,
                               rtol=F32_TOL)


def _kv(kv, shape, seed):
    r = np.random.default_rng(seed)
    k = jnp.asarray(r.standard_normal(shape), jnp.float32)
    v = jnp.asarray(r.standard_normal(shape), jnp.float32)
    if kv == "bf16":
        return k.astype(jnp.bfloat16), v.astype(jnp.bfloat16), None, None
    kq, ks, vq, vs = jquant.quantize_kv(k, v, kv)
    return kq, vq, ks, vs


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_decode_chunk_d64_matches_jax_oracle(kv):
    """The chunk path (K1c's plain version) at head_dim 64, multi-head,
    T = 5 (GPT-2's verify step), on a BHSD cache, against JAX's jnp oracle
    ``_decode_chunk_jnp`` on the same cache in its BSHD layout; lengths
    include the chunk, one at the capacity.  bf16 q on both sides."""
    B, T, H, S = 2, 5, 2, 96
    k, v, ks, vs = _kv(kv, (B, S, H, 64), seed=11)
    q = jnp.asarray(np.random.default_rng(12).standard_normal((B, T, H, 64)), jnp.bfloat16)
    kv_length = np.array([S, 37], np.int32)
    jo, jl = jdecode._decode_chunk_jnp(q, k, v, jnp.asarray(kv_length), scale=64 ** -0.5,
                                       k_scale=ks, v_scale=vs, return_lse=True)
    bhsd = lambda x: None if x is None else to_torch(x).transpose(1, 2).contiguous()  # noqa: E731
    sc = lambda s: None if s is None else bhsd(s)[..., 0].contiguous()  # noqa: E731
    to, tl = dec.flash_decode_chunk(to_torch(q), bhsd(k), bhsd(v), k_scale=sc(ks),
                                    v_scale=sc(vs), kv_length=torch.from_numpy(kv_length),
                                    softmax_mode="online", return_lse=True)
    np.testing.assert_allclose(_np(to), _np(jo), atol=BF16_TOL, rtol=BF16_TOL)
    # lse from fp32 scores of the same bf16 q on both sides
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kv", ["none", "int8", "fp8"])
@pytest.mark.parametrize("softmax_mode", ["online", "clamped"])
def test_paged_decode_d64_matches_jax(kv, softmax_mode):
    """K8's plain version at head_dim 64 (decode mode, H = Hk = 2) over a
    shuffled table of pages of 8, lengths 19, 11 and 0, against JAX's
    paged_flash_decode in interpret mode on the same pool.  fp32 q; the
    scores, base 2, stay far below fp8's clamped ceiling on both sides."""
    page, max_pages, Hk, D, lens = 8, 3, 2, 64, [19, 11, 0]
    table = [[7, 2, 9], [1, 5, 3], [4, 6, 8]]
    r = np.random.default_rng(13)
    T, B = max(lens), len(lens)
    k = r.standard_normal((T, B, Hk, D)).astype(np.float32)
    v = r.standard_normal((T, B, Hk, D)).astype(np.float32)
    jp = JPool.create(1, 10, page, B, max_pages, Hk, D, dtype=jnp.float32, mode=kv)
    tp = PagedKVPool.create(1, 10, page, B, max_pages, Hk, D, dtype=torch.float32, mode=kv,
                            device="cpu")
    for b in range(B):
        jp = jp.assign_pages(b, table[b])
        tp.assign_pages(b, table[b])
    for t in range(T):
        jp = jp.append_token(0, jnp.asarray(k[t]), jnp.asarray(v[t])).advance(1)
        tp.append_token(0, torch.from_numpy(k[t]), torch.from_numpy(v[t]))
        tp.advance(1)
    jp, tp = jp.set_lengths(lens), tp.set_lengths(lens)
    q = r.standard_normal((B, Hk, D)).astype(np.float32)
    ks = None if jp.k_scale is None else jp.k_scale[0]
    vs = None if jp.v_scale is None else jp.v_scale[0]
    jo, jl = jax.jit(functools.partial(
        j_paged_decode, scales_permuted=jp.scales_permuted, interpret=True, return_lse=True,
        softmax_mode=softmax_mode))(jnp.asarray(q), jp.k_pages[0], jp.v_pages[0],
                                    jp.block_table, jp.length, k_scale=ks, v_scale=vs)
    tkw = {} if tp.k_scale is None else {"k_scale": tp.k_scale[0], "v_scale": tp.v_scale[0]}
    to, tl = pd.paged_flash_decode(torch.from_numpy(q), tp.k_pages[0], tp.v_pages[0],
                                   tp.block_table, tp.length, **tkw, return_lse=True,
                                   softmax_mode=softmax_mode)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], atol=F32_TOL, rtol=F32_TOL)
    assert np.all(to[2].numpy() == 0) and np.all(tl[2].numpy() <= -1e29)


# --- models/gpt2.py against flash_attn_tpu/models/gpt2.py -------------------

@pytest.mark.parametrize("dtype", ["float32"])
def test_prefill_chunk_matches_jax(dtype):
    """A 50-token prompt in chunks of 16 into slot 1 of an fp8 cache: every
    chunk's logits, then the slot's cache (values and scales)."""
    dtype, jp, tp, jcfg, cfg = _params(dtype)
    jc = jgpt2.make_cache(jcfg, 2, 64, mode="fp8")
    tc = gpt2.make_cache(cfg, 2, 64, mode="fp8", device="cpu")
    prompt = _tokens(6, (50,))
    for start in range(0, 50, 16):
        chunk = np.zeros((1, 16), np.int64)
        n = min(16, 50 - start)
        chunk[0, :n] = prompt[start:start + n]
        jl, jc = _jitted(jgpt2.prefill_chunk, jcfg)(jp, jnp.asarray(chunk), cache=jc, slot=1,
                                                   start=start)
        tl, tc = gpt2.prefill_chunk(tp, torch.from_numpy(chunk), cfg, tc, 1, start)
        np.testing.assert_allclose(tl.numpy()[0, :n], np.asarray(jl)[0, :n], atol=_tol(dtype))
    want = bridge.kv_cache_from_jax(jc, device="cpu")
    for layer in range(cfg.num_layers):
        for a, b in zip(tc.slot_kv_float(layer, 1, torch.float32),
                        want.slot_kv_float(layer, 1, torch.float32)):
            # an fp8 value whose input flipped a rounding moves one e4m3
            # step (1/8 of it); the rest agree to the logits' tolerance
            diff = np.abs(_np(a) - _np(b))[:50]
            assert np.all(diff <= np.abs(_np(b))[:50] / 8 + _tol(dtype))
        np.testing.assert_allclose(_np(tc.k_scale[layer][1]), _np(want.k_scale[layer][1]),
                                   rtol=_tol(dtype), atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_prefill_packed_matches_jax(dtype):
    """Three prompts (30, 21, 9 tokens) packed in one 64-token row: the
    logits of every real row and every layer's k, v."""
    dtype, jp, tp, jcfg, cfg = _params(dtype)
    lens = (30, 21, 9)
    toks = np.zeros((1, 64), np.int64)
    seg = np.zeros((1, 64), np.int32)
    pos = np.zeros((1, 64), np.int32)
    off = 0
    for i, n in enumerate(lens):
        toks[0, off:off + n] = _tokens(7 + i, (n,))
        seg[0, off:off + n], pos[0, off:off + n] = i + 1, np.arange(n)
        off += n
    jl, jkv = _jitted(jgpt2.prefill_packed, jcfg)(jp, jnp.asarray(toks), jnp.asarray(pos),
                                                  jnp.asarray(seg))
    tl, tkv = gpt2.prefill_packed(tp, torch.from_numpy(toks), torch.from_numpy(pos),
                                  torch.from_numpy(seg), cfg)
    np.testing.assert_allclose(tl.numpy()[0, :off], np.asarray(jl)[0, :off], atol=_tol(dtype))
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(_np(tk)[0, :off], _np(jk)[0, :off], atol=_tol(dtype))
        np.testing.assert_allclose(_np(tv)[0, :off], _np(jv)[0, :off], atol=_tol(dtype))


@pytest.mark.parametrize("dtype,kv_mode", [("float32", "int8"), ("bfloat16", "fp8")])
def test_decode_step_paged_matches_jax(dtype, kv_mode):
    """Two prompts (19 and 6 tokens) prefilled (prefill_with_kv) into a
    pool of pages of 8 over shuffled tables, then two paged decode steps
    fed JAX's greedy tokens: the logits at each step."""
    dtype, jp, tp, jcfg, cfg = _params(dtype)
    jpool = JPool.create(2, 12, 8, 2, 4, 2, 64, dtype=jnp.dtype(dtype), mode=kv_mode)
    tpool = PagedKVPool.create(2, 12, 8, 2, 4, 2, 64, dtype=getattr(torch, dtype),
                               mode=kv_mode, device="cpu")
    jlast = []
    for b, (pages, n) in enumerate((([3, 9, 1, 5], 19), ([7, 2, 11, 4], 6))):
        jpool = jpool.assign_pages(b, pages)
        tpool.assign_pages(b, pages)
        toks, pos = _tokens(9 + b, (1, n)), np.arange(n)[None]
        jl, jkv = _jitted(jgpt2.prefill_with_kv, jcfg)(jp, jnp.asarray(toks), jnp.asarray(pos))
        _, tkv = gpt2.prefill_with_kv(tp, torch.from_numpy(toks), torch.from_numpy(pos), cfg)
        for layer, ((jk, jv), (tk, tv)) in enumerate(zip(jkv, tkv)):
            jpool = jpool.append_prefill(layer, b, jk[0], jv[0], 0)
            tpool.append_prefill(layer, b, tk[0], tv[0], 0)
        jlast.append(jl[0, -1])
    jpool, tpool = jpool.set_lengths([19, 6]), tpool.set_lengths([19, 6])
    jl = jnp.stack(jlast)
    for _ in range(2):
        nxt = jnp.argmax(jl, axis=-1)
        jl, jpool = _jitted(jgpt2.decode_step_paged, jcfg)(jp, nxt, pool=jpool)
        tl, tpool = gpt2.decode_step_paged(tp, to_torch(nxt).long(), cfg, tpool)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_tol(dtype))
    assert tpool.length.tolist() == [21, 8]


@pytest.mark.parametrize("dtype", ["float32"])
def test_positions_past_max_position_clamp_as_jax(dtype):
    """A position past max_position embeds the table's last row, as JAX's
    gather clamps the index: in a cache of 192 positions, decode_step and
    decode_multi for a slot at 130 (beside one at 5), and a prefill_chunk
    whose 16 tokens run from 120 past 128, beside JAX's."""
    dtype, jp, tp, jcfg, cfg = _params(dtype)
    jc = jgpt2.make_cache(jcfg, 2, 192, mode="int8")
    tc = gpt2.make_cache(cfg, 2, 192, mode="int8", device="cpu")
    for slot, n in enumerate((cfg.max_position + 2, 5)):
        jc, tc = jc.set_length(slot, n), tc.set_length(slot, n)
    tok = np.array([17, 4])
    jl, jc = _jitted(jgpt2.decode_step, jcfg)(jp, jnp.asarray(tok), cache=jc)
    tl, tc = gpt2.decode_step(tp, torch.from_numpy(tok), cfg, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_tol(dtype))
    toks = _tokens(10, (2, 3))
    jl, jc = _jitted(jgpt2.decode_multi, jcfg)(jp, jnp.asarray(toks), cache=jc)
    tl, tc = gpt2.decode_multi(tp, torch.from_numpy(toks), cfg, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_tol(dtype))
    assert tc.length.tolist() == [cfg.max_position + 6, 9]
    chunk = _tokens(11, (1, 16))
    start = cfg.max_position - 8
    jl, _ = _jitted(jgpt2.prefill_chunk, jcfg)(jp, jnp.asarray(chunk), cache=jc, slot=1,
                                               start=start)
    tl, _ = gpt2.prefill_chunk(tp, torch.from_numpy(chunk), cfg, tc, 1, start)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_tol(dtype))


def test_greedy_decode_tiny_matches_jax():
    """GPT2_TINY (head_dim 32, as JAX's own tests run it), fp32, int8 KV:
    greedy_decode's tokens equal JAX's."""
    jp = jgpt2.init_params(jgpt2.GPT2_TINY, jax.random.PRNGKey(3))
    tp = bridge.params_from_jax(jp, device="cpu")
    prompt = _tokens(12, (2, 9))
    want = jax.jit(functools.partial(jgpt2.greedy_decode, cfg=jgpt2.GPT2_TINY, steps=4,
                                     kv_mode="int8", interpret=True))(jp, jnp.asarray(prompt))
    got = gpt2.greedy_decode(tp, torch.from_numpy(prompt), gpt2.GPT2_TINY, steps=4,
                             kv_mode="int8")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_params_shapes_and_seed():
    """init_params: JAX's shapes and scales, one draw per seed."""
    p = gpt2.init_params(CFG, seed=1, device="cpu")
    assert p["wte"].shape == (1024, 128) and p["wpe"].shape == (128, 128)
    blk = p["blocks"][1]
    assert blk["attn"]["qkv"]["w"].shape == (128, 384) and blk["mlp"]["proj"]["w"].shape == (512, 128)
    assert float(blk["ln_1"]["g"].min()) == 1.0 and float(blk["attn"]["qkv"]["b"].abs().max()) == 0
    assert abs(float(p["wte"].std()) - 0.02) < 2e-3 and abs(float(p["wpe"].std()) - 0.01) < 1e-3
    again = gpt2.init_params(CFG, seed=1, device="cpu")
    assert torch.equal(p["wte"], again["wte"])
    assert not torch.equal(p["wte"], gpt2.init_params(CFG, seed=2, device="cpu")["wte"])


# --- the HF conversion ------------------------------------------------------

def test_convert_hf_state_dict_matches_hf():
    """A HF GPT2LMHeadModel built from config (two heads of 64): numpy and
    torch state dicts convert alike; logits within 2e-3 of HF's (as the
    JAX package's test holds its own conversion) and greedy tokens equal
    HF's generate, token for token."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2)).eval()
    sd = hf.state_dict()
    params, cfg = gpt2.convert_hf_state_dict({k: v.numpy() for k, v in sd.items()},
                                             device="cpu")
    assert (cfg.num_layers, cfg.hidden, cfg.num_heads, cfg.head_dim) == (2, 128, 2, 64)
    p2, _ = gpt2.convert_hf_state_dict(sd, num_heads=2, device="cpu")
    assert torch.equal(p2["blocks"][1]["attn"]["qkv"]["w"], params["blocks"][1]["attn"]["qkv"]["w"])
    tokens = np.random.RandomState(1).randint(0, 512, size=(2, 24))
    with torch.no_grad():
        want = hf(torch.from_numpy(tokens)).logits.numpy()
    got = gpt2.forward(params, torch.from_numpy(tokens), cfg).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
    prompt = np.random.RandomState(2).randint(0, 512, size=(1, 12))
    with torch.no_grad():
        hf_out = hf.generate(torch.from_numpy(prompt), max_new_tokens=8, do_sample=False,
                             pad_token_id=0).numpy()[0, 12:]
    ours = gpt2.greedy_decode(params, torch.from_numpy(prompt), cfg, steps=8)[0].numpy()
    np.testing.assert_array_equal(ours, hf_out)


# --- both engines, token for token against JAX's -----------------------------

# (prompt, max_tokens): three requests through two slots (the third waits
# for a slot)
REQUESTS = [(_tokens(20, (40,)).tolist(), 6), (_tokens(21, (9,)).tolist(), 6),
            (_tokens(22, (17,)).tolist(), 5)]
# two requests: the 100-token one ends at 119 of 128 positions and its slot
# idles for 20 steps while the other runs on, its length past max_position
PAST = [(_tokens(23, (100,)).tolist(), 20), (_tokens(24, (9,)).tolist(), 40)]


@pytest.fixture(scope="module")
def engine_params():
    """fp32 JAX and port params at the tiny head_dim-64 config."""
    jp = jgpt2.init_params(JCFG, jax.random.PRNGKey(5))
    return jp, bridge.params_from_jax(jp, device="cpu")


@pytest.fixture(scope="module")
def jax_allocator():
    """The JAX engine's page allocator library.  make builds it in place
    at first use, and another test process may be writing it at the same
    moment, so a failed load is retried."""
    for _ in range(10):
        try:
            return jabi.load()
        except OSError:
            time.sleep(3)
    return jabi.load()


ENGINE_CASES = {
    "fp8 packed, past max_position": ("fp8", {}),
    "int8 prefill_chunk_size 16": ("int8", {"prefill_chunk_size": 16}),
    "fp8 n-gram": ("fp8", {"spec": 2}),
    "int8 decode_burst 4": ("int8", {"decode_burst": 4}),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_tokens_equal_jax(engine_params, case):
    """InferenceEngine on the GPT-2 adapter, max_batch 2, capacity 128 =
    max_position: REQUESTS, or in the "past max_position" run PAST, whose
    100-token request's slot idles for 20 steps after 119 positions, so
    its position index passes 128.  Every generated token and the
    decode-token count equal the JAX engine's; the packed runs prefill the
    first two prompts in one packed call."""
    jp, tp = engine_params
    kv_mode, kw = ENGINE_CASES[case]
    jkw, tkw = dict(kw), dict(kw)
    if "spec" in kw:
        jkw["spec"] = JSpecConfig(num_draft=kw["spec"], ngram=2)
        tkw["spec"] = SpecConfig(num_draft=kw["spec"], ngram=2)
    requests = PAST if "past" in case else REQUESTS
    jeng = JEngine(jp, jgpt2.make_adapter(JCFG, interpret=True), max_batch=2, capacity=128,
                   kv_mode=kv_mode, cache_dtype=jnp.float32, **jkw)
    teng = InferenceEngine(tp, gpt2.make_adapter(CFG), max_batch=2, capacity=128,
                           kv_mode=kv_mode, cache_dtype=torch.float32, device="cpu", **tkw)
    jreqs = [jeng.submit(p, max_tokens=n) for p, n in requests]
    treqs = [teng.submit(p, max_tokens=n) for p, n in requests]
    jeng.run()
    teng.run()
    for jr, tr, (_, n) in zip(jreqs, treqs, requests):
        assert tr.done and len(tr.generated) == n
        assert tr.generated == jr.generated
    assert teng.metrics.decode_tokens == jeng.metrics.decode_tokens
    if "chunk" not in case:
        assert teng.packed_prefills == 1
    if "past" in case:
        assert int(teng.cache.length.max()) > CFG.max_position


def test_paged_engine_tokens_equal_jax(engine_params, jax_allocator):
    """PagedInferenceEngine on the GPT-2 adapter without a prefix cache,
    int8 KV, pages of 16: REQUESTS through two slots, token for token
    against JAX's, the pages all free after."""
    jp, tp = engine_params
    requests = REQUESTS
    kw = dict(max_batch=2, capacity=128, page_size=16, num_pages=12, kv_mode="int8")
    jeng = JPagedEngine(jp, jgpt2.make_adapter(JCFG, interpret=True), cache_dtype=jnp.float32,
                        **kw)
    teng = PagedInferenceEngine(tp, gpt2.make_adapter(CFG), cache_dtype=torch.float32,
                                device="cpu", **kw)
    jreqs = [jeng.submit(p, max_tokens=n) for p, n in requests]
    treqs = [teng.submit(p, max_tokens=n) for p, n in requests]
    jeng.run()
    teng.run()
    for jr, tr, (_, n) in zip(jreqs, treqs, requests):
        assert tr.done and len(tr.generated) == n
        assert tr.generated == jr.generated
    assert teng.alloc.free_count == jeng.alloc.free_count == 11


def test_paged_engine_prefix_cache_needs_suffix_prefill(engine_params):
    """The GPT-2 adapter has no prefill_suffix_paged, so a paged engine
    with a prefix cache raises, as JAX's does."""
    jp, tp = engine_params
    with pytest.raises(ValueError):
        JPagedEngine(jp, jgpt2.make_adapter(JCFG, interpret=True), prefix_cache=True)
    with pytest.raises(ValueError):
        PagedInferenceEngine(tp, gpt2.make_adapter(CFG), prefix_cache=True, device="cpu")

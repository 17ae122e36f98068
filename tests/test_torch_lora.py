"""The port's multi-adapter LoRA (models/lora.py, the Llama paths' lora
arguments, InferenceEngine(lora_bank=...)) against the JAX package at
LLAMA_TINY, on the CPU.

Adapters are drawn with numpy from a seed and carried to both packages
(``bridge.lora_from_jax``), so both compute with the same values.  JAX's
LoRA functions are plain jnp and serve as the oracle directly; JAX's model
calls run jitted in interpret mode.  LLAMA_TINY is an fp32 model, so the
two sides differ by summation order only, except where stated.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.engine.engine import InferenceEngine as JEngine
from flash_attn_tpu.engine.engine import SpecConfig as JSpec
from flash_attn_tpu.models import llama as jllama
from flash_attn_tpu.models import lora as jlora
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.engine.engine import InferenceEngine, SpecConfig
from flash_attn_tpu_torch.models import llama, lora

CFG = llama.LLAMA_TINY
JCFG = jllama.LLAMA_TINY
RANK, ALPHA = 4, 8.0
# fp32 summation order moves the logits ~1e-6 (the adapters' deltas, B ~
# N(0, 0.05^2) as JAX's tests/test_lora.py draws it, outweigh the base
# projections, so the logits move far more than this between adapters)
LOGIT_TOL = 2e-3
PROMPT = [3, 17, 101, 7, 64, 250, 9, 33, 5]


def _params(tree):
    return bridge.params_from_jax(jax.device_get(tree), device="cpu")


def _np_lora(seed, blocks, zero_b=False):
    """A JAX LoRA tree over ``blocks``' unfused shapes, from numpy: A ~
    N(0, 1/r) as init_lora draws it, B ~ N(0, 0.05^2) (or 0)."""
    rng = np.random.default_rng(seed)
    out = []
    for blk in blocks:
        entry = {}
        for name in lora.LORA_TARGETS:
            K, N = jlora.weight_kn(blk[name])
            A = (rng.standard_normal((K, RANK)) * RANK ** -0.5).astype(np.float32)
            B = np.zeros((RANK, N), np.float32) if zero_b else (
                rng.standard_normal((RANK, N)) * 0.05).astype(np.float32)
            entry[name] = (jnp.asarray(A), jnp.asarray(B))
        out.append(entry)
    return {"blocks": out, "scaling": ALPHA / RANK}


@pytest.fixture(scope="module")
def setup():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    jl0, jl1 = _np_lora(1, jp["blocks"]), _np_lora(2, jp["blocks"])
    jbank = jlora.stack_adapters([jl0, jl1])
    jq = jllama.quantize_weights(jp)  # int8 weights, per-column scales
    weights = {"float": (jp, _params(jp)),
               "int8 fused": (jllama.fuse_projections(jq), _params(jllama.fuse_projections(jq)))}
    tl0, tl1 = (bridge.lora_from_jax(t, device="cpu") for t in (jl0, jl1))
    return dict(weights=weights, jq=jq, jlora=(jl0, jl1), jbank=jbank,
                tlora=(tl0, tl1), tbank=lora.stack_adapters([tl0, tl1]))


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def test_bridge_and_stack_adapters_match_jax(setup):
    """The port's bank stacked from the bridged adapters equals JAX's bank
    bridged, leaf for leaf."""
    want = bridge.lora_from_jax(setup["jbank"], device="cpu")
    got = setup["tbank"]
    assert got["scaling"] == want["scaling"] == ALPHA / RANK
    for gb, wb in zip(got["blocks"], want["blocks"], strict=True):
        assert sorted(gb) == sorted(wb) == sorted(lora.LORA_TARGETS)  # JAX sorts dict keys
        for name in gb:
            for g, w in zip(gb[name], wb[name]):
                assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
                assert torch.equal(g, w)


# form -> (bank?, ids); x is [2, 5, 128] (the bank-ids form gathers a slot each)
FORMS = {"single": (False, None), "bank id": (True, 1), "bank ids": (True, [1, 0])}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", list(FORMS))
def test_lora_delta_forms_match_jax(setup, form, dtype):
    """lora_delta's three forms on fp32 leaves, x in fp32 or bf16 (A and B
    cast to x's dtype before the products).  fp32: 1e-5; bf16: the
    [*, r] product rounds to bf16 on both sides, summation order may move
    it one bf16 ulp (2^-8 relative), so 2^-6 of the output's max."""
    bank, ids = FORMS[form]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, CFG.hidden)).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    tx = bridge.to_torch(np.asarray(jx), "cpu")
    if bank:
        jab, tab = setup["jbank"]["blocks"][1]["w_up"], setup["tbank"]["blocks"][1]["w_up"]
    else:
        jab, tab = setup["jlora"][0]["blocks"][1]["w_up"], setup["tlora"][0]["blocks"][1]["w_up"]
    jids = None if ids is None else jnp.asarray(ids) if isinstance(ids, list) else ids
    tids = None if ids is None else torch.tensor(ids) if isinstance(ids, list) else ids
    want = np.asarray(jlora.lora_delta(jx, jab, jids, 2.0).astype(jnp.float32))
    got = lora.lora_delta(tx, tab, tids, 2.0)
    assert got.dtype == tx.dtype and tuple(got.shape) == (2, 5, CFG.intermediate)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6 * float(np.abs(want).max())
    _close(got.float(), want, atol=tol)


def test_weight_kn_every_kind(setup):
    """weight_kn on float, int8, Int4Weight, W8A8, W4A8 and the legacy
    w8a8 tuple equals JAX's on the same weights; on a BiasedWeight it is
    its inner weight's (JAX's weight_kn has no case for the biased
    weight)."""
    from flash_attn_tpu_torch.ops.matmul import BiasedWeight

    jp = setup["weights"]["float"][0]
    blk = jp["blocks"][0]
    kinds = {"float": blk, "int8": setup["jq"]["blocks"][0]}
    # one weight of each shape: [hidden, q_dim], [hidden, kv_dim], [intermediate, hidden]
    two = {"blocks": [{name: blk[name] for name in ("wq", "wk", "w_down")}],
           "tok_emb": jp["tok_emb"], "lm_head": jp["lm_head"]}
    for mode, g in (("int4", 32), ("w8a8", 128), ("w4a8", 32)):
        kinds[mode] = jllama.quantize_weights(two, mode, group_size=g)["blocks"][0]
    seen = set()
    for kind, jblk in kinds.items():
        tblk = _params(jblk)
        for name in (n for n in lora.LORA_TARGETS if n in jblk):
            want = tuple(jlora.weight_kn(jblk[name]))
            assert lora.weight_kn(tblk[name]) == want, (kind, name)
            assert lora.weight_kn(BiasedWeight(tblk[name], torch.zeros(want[1]))) == want
            seen.add(type(tblk[name]).__name__)
    legacy = ("w8a8", *setup["weights"]["int8 fused"][1]["blocks"][0]["wo"])
    assert lora.weight_kn(legacy) == (CFG.num_heads * CFG.head_dim, CFG.hidden)
    assert seen == {"Tensor", "tuple", "Int4Weight", "W8A8Weight", "W4A8Weight"}


def test_init_lora_shapes_dtypes_and_scaling(setup):
    """init_lora against JAX's on the same params: each leaf's shape and
    dtype (the weight's own; fp32 for a quantized weight; ``dtype`` when
    given), B exactly 0, A ~ N(0, 1/r) (its std within 15 % of r^-0.5 on
    both sides), scaling alpha / r (1 without alpha)."""
    jp, tp = setup["weights"]["float"]
    jq = setup["jq"]
    tq = _params(jq)
    tb = dict(tp, blocks=[{k: v.to(torch.bfloat16) if k in lora.LORA_TARGETS else v
                           for k, v in blk.items()} for blk in tp["blocks"]])
    jb = dict(jp, blocks=[{k: v.astype(jnp.bfloat16) if k in lora.LORA_TARGETS else v
                           for k, v in blk.items()} for blk in jp["blocks"]])
    cases = ((jp, tp, {}), (jq, tq, {}), (jb, tb, {}), (jq, tq, {"dtype": "bfloat16"}))
    for jparams, tparams, kw in cases:
        jt = jlora.init_lora(jparams, RANK, jax.random.PRNGKey(5), alpha=ALPHA,
                             dtype=kw.get("dtype"))
        gen = torch.Generator().manual_seed(5)
        tt = lora.init_lora(tparams, RANK, gen, alpha=ALPHA,
                            dtype=getattr(torch, kw["dtype"]) if kw else None)
        assert tt["scaling"] == jt["scaling"] == ALPHA / RANK
        for jblk, tblk in zip(jt["blocks"], tt["blocks"], strict=True):
            assert list(tblk) == list(jblk)
            for name in tblk:
                (jA, jB), (tA, tB) = jblk[name], tblk[name]
                assert tuple(tA.shape) == jA.shape and tuple(tB.shape) == jB.shape
                assert str(tA.dtype).split(".")[1] == jA.dtype.name == jB.dtype.name
                assert tB.dtype == tA.dtype and not tB.any()
                for a in (np.asarray(jA, np.float32), tA.float().numpy()):
                    assert abs(a.std() * RANK ** 0.5 - 1) < 0.15
    assert lora.init_lora(tp, RANK, torch.Generator())["scaling"] == 1.0
    assert jlora.init_lora(jp, RANK, jax.random.PRNGKey(0))["scaling"] == 1.0


def test_refusals_match_jax(setup):
    """stack_adapters, lora_delta and merge_lora refuse what JAX's refuse,
    with JAX's messages (a structure mismatch: ValueError on both); the
    Llama paths refuse LoRA with a custom MLP."""
    (jl0, _), (tl0, _) = setup["jlora"], setup["tlora"]
    tq = _params(setup["jq"])
    other = _np_lora(9, setup["weights"]["float"][0]["blocks"])
    other["blocks"][0]["wq"] = tuple(t[..., :2] if t.shape[-1] == RANK else t[:2]
                                     for t in other["blocks"][0]["wq"])
    cases = (
        ("need at least one adapter", lambda m: m.stack_adapters([]), None),
        ("adapters disagree on scaling",
         lambda m: m.stack_adapters([jl0, dict(jl0, scaling=99.0)]),
         lambda m: m.stack_adapters([tl0, dict(tl0, scaling=99.0)])),
        (None, lambda m: m.stack_adapters([jl0, other]),
         lambda m: m.stack_adapters([tl0, bridge.lora_from_jax(other, device="cpu")])),
        ("stacked LoRA bank needs adapter ids",
         lambda m: m.lora_delta(jnp.ones((2, 1, CFG.hidden)),
                                setup["jbank"]["blocks"][0]["wq"], None, 1.0),
         lambda m: m.lora_delta(torch.ones((2, 1, CFG.hidden)),
                                setup["tbank"]["blocks"][0]["wq"], None, 1.0)),
        ("merge_lora needs float base weights",
         lambda m: m.merge_lora(setup["jq"], jl0), lambda m: m.merge_lora(tq, tl0)),
    )
    for msg, jcall, tcall in cases:
        for mod, call in ((jlora, jcall), (lora, tcall or jcall)):
            with pytest.raises(ValueError, match=msg):
                call(mod)
    # the port's own: LoRA takes the dense MLP only (JAX's Mixtral has none)
    with pytest.raises(ValueError, match="dense MLP"):
        llama.prefill_with_kv(tq, torch.ones((1, 4), dtype=torch.long),
                              torch.arange(4)[None], CFG, mlp=lambda x, blk, cfg: x, lora=tl0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_lora_matches_jax(setup, dtype):
    """merge_lora on a float base equals JAX's leaf for leaf: fp32 to 1e-6;
    bf16 (the sum in fp32, rounded once) to one bf16 ulp."""
    jp = setup["weights"]["float"][0]
    jp = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)), jp)
    tp = _params(jp)
    jm = jlora.merge_lora(jp, setup["jlora"][1])
    tm = lora.merge_lora(tp, setup["tlora"][1])
    for jblk, tblk in zip(jm["blocks"], tm["blocks"], strict=True):
        for name in lora.LORA_TARGETS:
            want = np.asarray(jblk[name].astype(jnp.float32))
            assert str(tblk[name].dtype).split(".")[1] == dtype
            atol = 1e-6 if dtype == "float32" else 2.0 ** -8 * np.abs(want).max()
            _close(tblk[name].float(), want, atol=atol)
    assert tm["tok_emb"] is tp["tok_emb"]


def _cache_to_jax(jcache, tcache):
    """JAX's float cache holding a copy of the port's KV (both fp32), so
    both decode steps start from the same cache.  A copy: JAX may alias a
    numpy buffer, and its calls run asynchronously while the port's
    decode step writes its cache in place."""
    from flash_attn_tpu.engine.kv_cache import KVCache as JKVCache

    def copy(t):
        return jnp.asarray(t.numpy().copy())

    return JKVCache(tuple(map(copy, tcache.k)), tuple(map(copy, tcache.v)), None, None,
                    copy(tcache.length), jcache.mode, jcache.scale_perm_chunk)


def _jit_prefill():
    return jax.jit(lambda p, t, pos, lr, i: jllama.prefill_with_kv(
        p, t, pos, JCFG, interpret=True, lora=lr, lora_id=i))


@pytest.mark.parametrize("weights", ["float", "int8 fused"])
def test_prefill_and_decode_with_lora_match_jax(setup, weights):
    """prefill_with_kv with one adapter's tree, and with the bank and
    lora_id 1; then two slots (adapters 0 and 1) through three decode
    steps with lora_ids [0, 1], on float weights and on int8 fused weights
    (the deltas on wqkv's and w_gate_up's split outputs): logits and KV
    against JAX's."""
    jp, tp = setup["weights"][weights]
    assert ("wqkv" in tp["blocks"][0]) == (weights == "int8 fused")
    S = len(PROMPT)
    toks = np.asarray([PROMPT], np.int32)
    pos = np.arange(S, dtype=np.int32)[None]
    ttoks, tpos = torch.from_numpy(toks).long(), torch.from_numpy(pos)
    jtoks, jpos = jnp.asarray(toks), jnp.asarray(pos)

    jl, jkv = _jit_prefill()(jp, jtoks, jpos, setup["jlora"][0], None)
    tl, tkv = llama.prefill_with_kv(tp, ttoks, tpos, CFG, lora=setup["tlora"][0])
    _close(tl, jl, LOGIT_TOL)
    base, _ = llama.prefill_with_kv(tp, ttoks, tpos, CFG)
    assert float((tl - base).abs().max()) > 50 * LOGIT_TOL  # the delta shows

    jcache = jllama.make_cache(JCFG, 2, 32)
    tcache = llama.make_cache(CFG, 2, 32, device="cpu")
    jprefill = _jit_prefill()
    for slot in (0, 1):
        jl, jkv = jprefill(jp, jtoks, jpos, setup["jbank"], jnp.int32(slot))
        tl, tkv = llama.prefill_with_kv(tp, ttoks, tpos, CFG, lora=setup["tbank"],
                                        lora_id=slot)
        _close(tl, jl, LOGIT_TOL)
        for layer, ((jk, jv), (tk, tv)) in enumerate(zip(jkv, tkv)):
            _close(tk, jk, 1e-4)
            _close(tv, jv, 1e-4)
            tcache.insert_prompt(layer, slot, tk[0], tv[0])
        tcache.set_length(slot, S)
    jcache = _cache_to_jax(jcache, tcache)
    jstep = jax.jit(lambda p, t, c, b, ids: jllama.decode_step(
        p, t, JCFG, c, interpret=True, lora=b, lora_ids=ids))
    ids = np.asarray([0, 1], np.int32)
    tok = np.asarray([3, 7], np.int32)
    for _ in range(3):
        jl, jcache = jstep(jp, jnp.asarray(tok), jcache, setup["jbank"], jnp.asarray(ids))
        tl, tcache = llama.decode_step(tp, torch.from_numpy(tok).long(), CFG, tcache,
                                       lora=setup["tbank"], lora_ids=torch.from_numpy(ids))
        _close(tl, jl, LOGIT_TOL)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))


ENGINE_PROMPTS = ([1, 2, 3, 4, 5], [9, 8, 7], list(range(40, 61)))
ENGINE_ADAPTERS = (0, 1, 1)


def _tengine(tp, bank, **kw):
    return InferenceEngine(tp, llama.make_adapter(CFG), max_batch=2, capacity=64,
                           cache_dtype=torch.float32, device="cpu", lora_bank=bank, **kw)


def test_engine_two_adapters_equal_jax(setup):
    """Three requests through two slots (the third reuses a slot under
    another adapter), adapters 0, 1, 1 in flight together: greedy tokens
    equal the JAX engine's token for token; the first two are admitted in
    one step but prefilled one a call (no packed prefill with a bank)."""
    jp, tp = setup["weights"]["float"]
    jeng = JEngine(jp, jllama.make_adapter(JCFG, interpret=True), max_batch=2, capacity=64,
                   cache_dtype=jnp.float32, lora_bank=setup["jbank"])
    teng = _tengine(tp, setup["tbank"])
    jreqs = [jeng.submit(p, max_tokens=5, adapter=a)
             for p, a in zip(ENGINE_PROMPTS, ENGINE_ADAPTERS)]
    treqs = [teng.submit(p, max_tokens=5, adapter=a)
             for p, a in zip(ENGINE_PROMPTS, ENGINE_ADAPTERS)]
    jeng.run()
    teng.run()
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and len(tr.generated) == 5
        assert tr.generated == jr.generated
    assert teng.packed_prefills == 0
    assert teng._decode_lora_jit.calls > 0 and teng._decode_jit.calls == 0
    assert teng.adapter_ids.tolist() == list(np.asarray(jeng.adapter_ids))


def test_engine_zero_b_adapter_equals_no_bank(setup):
    """Adapter 0 of a bank with B = 0 (init_lora's start) serves exactly
    the base model's tokens while adapter 1 (B != 0) shares its decode
    steps; adapter 1's tokens differ from the base's."""
    jp, tp = setup["weights"]["int8 fused"]
    gen = torch.Generator().manual_seed(0)
    zero = lora.init_lora(_params(setup["jq"]), RANK, gen, alpha=ALPHA)
    bank = lora.stack_adapters([zero, setup["tlora"][1]])
    eng = _tengine(tp, bank)
    reqs = [eng.submit(p, max_tokens=6, adapter=a) for p, a in ((PROMPT, 0), (PROMPT, 1))]
    eng.run()
    base = InferenceEngine(tp, llama.make_adapter(CFG), max_batch=2, capacity=64,
                           cache_dtype=torch.float32, device="cpu")
    want = base.submit(PROMPT, max_tokens=6)
    base.run()
    assert reqs[0].generated == want.generated
    assert reqs[1].generated != want.generated


def test_engine_lora_refusals_match_jax(setup):
    """The bank's refusals, with JAX's messages: speculation, chunked
    prefill (JAX refuses it at construction, so its chunked prefill never
    runs with a bank), decode bursts, an adapter without the LoRA paths.
    The port also refuses an adapter outside the bank at submit, and a
    bank on the default device (the card) without one."""
    jp, tp = setup["weights"]["float"]
    jad = jllama.make_adapter(JCFG, interpret=True)
    tad = llama.make_adapter(CFG)
    cases = (
        ("lora_bank does not compose with speculative decoding or chunked prefill yet",
         {"spec": JSpec()}, {"spec": SpecConfig()}),
        ("lora_bank does not compose with speculative decoding or chunked prefill yet",
         {"prefill_chunk_size": 16}, {"prefill_chunk_size": 16}),
        ("decode_burst does not compose with speculative decoding or LoRA banks",
         {"decode_burst": 4}, {"decode_burst": 4}),
        ("lora_bank needs the adapter's lora paths",
         {"adapter": dataclasses.replace(jad, decode_step_lora=None)},
         {"adapter": dataclasses.replace(tad, prefill_with_kv_lora=None)}),
    )
    for msg, jkw, tkw in cases:
        with pytest.raises(ValueError, match=msg):
            JEngine(jp, jkw.pop("adapter", jad), max_batch=2, capacity=64,
                    cache_dtype=jnp.float32, lora_bank=setup["jbank"], **jkw)
        with pytest.raises(ValueError, match=msg):
            InferenceEngine(tp, tkw.pop("adapter", tad), max_batch=2, capacity=64,
                            cache_dtype=torch.float32, device="cpu",
                            lora_bank=setup["tbank"], **tkw)
    with pytest.raises(ValueError, match="not in the bank of 2"):
        _tengine(tp, setup["tbank"]).submit(PROMPT, adapter=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            InferenceEngine(tp, tad, max_batch=2, capacity=64, lora_bank=setup["tbank"])


def test_engine_casts_the_bank_once_and_follows_in_place_changes(setup):
    """A bf16 model over an fp32 bank: the working bank is cast to bf16
    once (the same tensors at every call), cast anew after an in-place
    change of the bank, and the decode body's watch key changes with it
    (on the card: a new capture)."""
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    tp = llama.init_params(cfg, seed=0, device="cpu")
    bank = lora.stack_adapters([lora.cast_lora(t, torch.float32) for t in setup["tlora"]])
    eng = InferenceEngine(tp, llama.make_adapter(cfg), max_batch=2, capacity=64,
                          device="cpu", lora_bank=bank)
    first = eng._working_bank()
    assert first["blocks"][0]["wq"][0].dtype == torch.bfloat16
    assert eng._working_bank() is first
    key = eng._decode_lora_jit.watch()
    bank["blocks"][1]["w_down"][1].mul_(2.0)
    assert eng._decode_lora_jit.watch() != key
    again = eng._working_bank()
    assert again is not first
    torch.testing.assert_close(again["blocks"][1]["w_down"][1],
                               bank["blocks"][1]["w_down"][1].to(torch.bfloat16))
    req = eng.submit(PROMPT, max_tokens=3, adapter=1)
    eng.run()
    assert req.done and len(req.generated) == 3

"""The port's Mixtral engines against the JAX package at MIXTRAL_TINY, on
the CPU: both engines token for token against JAX's, and the HF
conversion (tests/test_torch_mixtral.py holds the router, the MoE layer,
the model paths and the quantization).

Inputs are made with numpy from a seed and handed to both sides; the
params go through the bridge.  JAX runs its Pallas kernels in interpret
mode; the port runs the plain versions of its kernels.  The model is fp32
on both sides, so the two differ only in the order of fp32 sums, except
where a router's top-2 is a near tie: the tests' seeds leave every
token's expert set equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.engine.engine import InferenceEngine as JEngine
from flash_attn_tpu.engine.engine import PagedInferenceEngine as JPagedEngine
from flash_attn_tpu.engine.engine import SpecConfig as JSpecConfig
from flash_attn_tpu.models import mixtral as jmx
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.engine.engine import (
    InferenceEngine,
    PagedInferenceEngine,
    SpecConfig,
)
from flash_attn_tpu_torch.models import mixtral as mx
from _torch_threads import one_torch_thread  # noqa: F401

CFG = mx.MIXTRAL_TINY
JCFG = jmx.MIXTRAL_TINY


def _bridge(tree):
    return bridge.params_from_jax(jax.device_get(tree), device="cpu")


@pytest.fixture(scope="module")
def params():
    """{"float" | "int8": (JAX params, the port's)}: each package
    quantizes the same float weights."""
    jp = jmx.init_params(JCFG, jax.random.PRNGKey(0))
    tp = _bridge(jp)
    out = {"float": (jp, tp)}
    for mode, g in (("int8", 128),):
        # jitted: eagerly, each projection's quantization compiles its ops
        jq = jax.jit(functools.partial(jmx.quantize_weights, mode=mode, group_size=g))(jp)
        out[mode] = (jq, mx.quantize_weights(tp, mode, group_size=g))
    return out


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


REQUESTS = [([5, 6, 7, 8, 9, 10, 11], 6), ([300, 2, 41], 4), (list(range(40, 75)), 5), ([9], 7)]


@pytest.mark.parametrize("case", ["packed", "n-gram", "paged"])
def test_engine_tokens_equal_jax(params, case):
    """Both engines at int8 experts, two slots, four requests: the
    contiguous engine with packed prefill (the default; int8 KV) and with
    n-gram speculation (K = 3), and the paged engine without a prefix cache
    (fp8 KV): every greedy token equals the JAX engine's."""
    jp, tp = params["int8"]
    jadapter = jmx.make_adapter(JCFG, interpret=True)
    kw = dict(max_batch=2, capacity=64)
    if case == "paged":
        jeng = JPagedEngine(jp, jadapter, page_size=8, kv_mode="fp8", cache_dtype=jnp.float32,
                            **kw)
        teng = PagedInferenceEngine(tp, mx.make_adapter(CFG), page_size=8, kv_mode="fp8",
                                    cache_dtype=torch.float32, device="cpu", **kw)
    else:
        jspec = tspec = None
        if case == "n-gram":
            jspec, tspec = JSpecConfig(num_draft=3, ngram=2), SpecConfig(num_draft=3, ngram=2)
        jeng = JEngine(jp, jadapter, kv_mode="int8", cache_dtype=jnp.float32, spec=jspec, **kw)
        teng = InferenceEngine(tp, mx.make_adapter(CFG), kv_mode="int8",
                               cache_dtype=torch.float32, spec=tspec, device="cpu", **kw)
    jreqs = [jeng.submit(p, max_tokens=n) for p, n in REQUESTS]
    treqs = [teng.submit(p, max_tokens=n) for p, n in REQUESTS]
    jeng.run()
    teng.run()
    for jr, tr, (_, n) in zip(jreqs, treqs, REQUESTS):
        assert tr.done and len(tr.generated) == n
        assert tr.generated == jr.generated
    if case == "packed":
        assert teng.packed_prefills >= 1
    if case == "n-gram":
        assert teng.metrics.spec_steps == jeng.metrics.spec_steps > 0


def test_paged_engine_refuses_a_prefix_cache():
    """The adapter has no suffix prefill, as JAX's: the paged engine serves
    Mixtral without prefix caching."""
    adapter = mx.make_adapter(CFG)
    assert adapter.prefill_chunk is None and adapter.prefill_suffix_paged is None
    with pytest.raises(ValueError, match="prefix_cache"):
        PagedInferenceEngine({}, adapter, max_batch=1, capacity=32, page_size=8,
                             prefix_cache=True, device="cpu")


def test_convert_hf_model_matches_hf():
    """convert_hf_model of a HF MixtralForCausalLM built from config: the
    config and params equal JAX's conversion, the logits HF's (fp32 on
    both: 2e-4 on logits of ~1) and the greedy tokens HF's."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(5)
    hf_cfg = transformers.MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
        num_experts_per_tok=2, max_position_embeddings=128, rope_theta=10000.0,
        rms_norm_eps=1e-5)
    model = transformers.MixtralForCausalLM(hf_cfg).eval()
    params, cfg = mx.convert_hf_model(model, dtype="float32", device="cpu")
    jparams, jcfg = jmx.convert_hf_model(model, dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.num_experts, cfg.top_k) == (4, 2)
    mine, theirs = _leaves(params), _leaves(_bridge(jparams))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert torch.equal(a, b)
    toks = torch.from_numpy(np.random.RandomState(6).randint(0, 256, size=(1, 16))).long()
    with torch.no_grad():
        want = model(toks).logits
    got = mx.forward(params, toks, cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)
    cache = mx.make_cache(cfg, 1, 32, device="cpu")
    logits, kvs = mx.prefill_with_kv(params, toks, torch.arange(16)[None], cfg)
    for i, (k, v) in enumerate(kvs):
        cache.insert_prompt(i, 0, k[0], v[0])
    cache.set_length(0, 16)
    seq, greedy = toks, [int(logits[0, -1].argmax())]
    for _ in range(4):
        step, cache = mx.decode_step(params, torch.tensor(greedy[-1:]), cfg, cache)
        greedy.append(int(step[0].argmax()))
    with torch.no_grad():
        for _ in range(5):
            seq = torch.cat([seq, model(seq).logits[0, -1].argmax().view(1, 1)], dim=1)
    assert greedy == seq[0, 16:].tolist()

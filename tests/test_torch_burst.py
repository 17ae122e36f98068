"""Decode bursts in the port's engines against the JAX engines at
LLAMA_TINY with int8 weights, on the CPU, and the pieces around them:
the body wrapper (engine/_graph.py) as a plain call off the card, and
utils/profiling against the JAX package's.

Greedy tokens must equal the JAX engine's token for token, at the same
burst.  Both engines run their default paths (the prompts admitted in
one step go through one packed prefill); the JAX ones run their kernels in
interpret mode.
"""

import json
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.engine.engine import InferenceEngine as JEngine
from flash_attn_tpu.engine.engine import PagedInferenceEngine as JPagedEngine
from flash_attn_tpu.engine.engine import SpecConfig as JSpecConfig
from flash_attn_tpu.models import llama as jllama
from flash_attn_tpu.runtime import abi as jabi
from flash_attn_tpu.utils import profiling as jprof
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.engine import _graph
from flash_attn_tpu_torch.engine.engine import (
    InferenceEngine,
    PagedInferenceEngine,
    SpecConfig,
)
from flash_attn_tpu_torch.models import llama
from flash_attn_tpu_torch.utils import profiling
from _torch_threads import one_torch_thread  # noqa: F401

CFG = llama.LLAMA_TINY
# three waves of (prompt, max_tokens) through two slots: more requests than
# slots (plain steps until the queue drains, then bursts), slot reuse and
# budgets that end mid-burst
WAVES = [
    [([5, 6, 7, 8, 9, 10, 11], 9), ([300, 2, 41], 6), (list(range(40, 75)), 11)],
    [([9], 7), (list(range(100, 120)), 5)],
    [([17, 3, 250, 4], 10), ([77] * 5, 8), ([1, 2, 3], 4)],
]
# two waves through the paged engine with prefix caching: misses that
# donate the 16-token prefix (two pages of 8), then hits.  The first
# request's 19 + 5 tokens fill three pages, its budget rounded up to whole
# bursts of 3 needs a fourth
_SHARED = list(range(1, 17))
PAGED_WAVES = [
    [(_SHARED + [21, 22, 23], 5), (_SHARED + [31], 5), (list(range(60, 90)), 4)],
    [(_SHARED + [41, 42, 43], 8), (_SHARED + list(range(70, 80)), 3)],
]
PAGE = 8


@pytest.fixture(scope="module")
def both_params():
    jp = jllama.quantize_weights(jllama.init_params(jllama.LLAMA_TINY, jax.random.PRNGKey(0)))
    return jp, bridge.params_from_jax(jax.device_get(jp), device="cpu")


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


def _jax_adapter(eos=None):
    return jllama.make_adapter(jllama.LLAMA_TINY, interpret=True, eos_token=eos)


def _run_waves(eng, waves):
    reqs = []
    for wave in waves:
        reqs.append([eng.submit(p, max_tokens=n) for p, n in wave])
        eng.run()
    return reqs


def _eos_mid_burst(tp, kv_mode, burst):
    """A token that the port's burst run without an EOS generates third in
    a request of wave 1 (the middle of its first burst) and not before: as
    the EOS it ends that request mid-burst."""
    eng = InferenceEngine(tp, llama.make_adapter(CFG), max_batch=2, capacity=64,
                          kv_mode=kv_mode, cache_dtype=torch.float32, device="cpu",
                          decode_burst=burst)
    for req in _run_waves(eng, WAVES)[0]:
        if req.generated[2] not in req.generated[:2]:
            return req.generated[2]
    pytest.fail("no request of wave 1 has a fresh third token")


@pytest.mark.parametrize("kv_mode", ["fp8", "int8"])
def test_engine_burst_tokens_equal_jax(both_params, kv_mode):
    """decode_burst=4 over three waves through two slots, with an EOS that
    one request hits mid-burst: every token, the decode-token count and the
    completed requests equal the JAX engine's at the same burst."""
    jp, tp = both_params
    burst = 4
    eos = _eos_mid_burst(tp, kv_mode, burst)
    jeng = JEngine(jp, _jax_adapter(eos), max_batch=2, capacity=64, kv_mode=kv_mode,
                   cache_dtype=jnp.float32, decode_burst=burst)
    teng = InferenceEngine(tp, llama.make_adapter(CFG, eos_token=eos), max_batch=2,
                           capacity=64, kv_mode=kv_mode, cache_dtype=torch.float32,
                           device="cpu", decode_burst=burst)
    jreqs, treqs = _run_waves(jeng, WAVES), _run_waves(teng, WAVES)
    for jwave, twave, wave in zip(jreqs, treqs, WAVES):
        for jr, tr, (_, n) in zip(jwave, twave, wave):
            assert tr.done and 1 <= len(tr.generated) <= n
            assert tr.generated == jr.generated
    ended = [r for wave in treqs for r in wave if r.generated[-1] == eos]
    assert any(len(r.generated) < r.max_tokens for r in ended)
    assert teng.metrics.decode_tokens == jeng.metrics.decode_tokens
    assert teng.metrics.completed_requests == jeng.metrics.completed_requests == 8
    assert teng.metrics.steps == jeng.metrics.steps
    np.testing.assert_array_equal(teng._host_lens, jeng._host_lens)
    assert teng._inflight is None or not teng.sched.active
    assert teng.packed_prefills >= 1


def test_paged_engine_burst_matches_jax(jax_allocator, both_params):
    """decode_burst=3 with prefix caching over two waves, stepped in
    lockstep with the JAX engine: after every step the slots' page
    capacities and the allocator's free count equal JAX's, every
    request's page need (rounded up to whole bursts) too, and the tokens
    at the end."""
    jp, tp = both_params
    kw = dict(max_batch=2, capacity=48, num_pages=11, prefix_cache=True, decode_burst=3)
    jeng = JPagedEngine(jp, _jax_adapter(), page_size=PAGE, kv_mode="fp8",
                        cache_dtype=jnp.float32, **kw)
    teng = PagedInferenceEngine(tp, llama.make_adapter(CFG), page_size=PAGE, kv_mode="fp8",
                                cache_dtype=torch.float32, device="cpu", **kw)
    for wave in PAGED_WAVES:
        jreqs = [jeng.submit(p, max_tokens=n) for p, n in wave]
        treqs = [teng.submit(p, max_tokens=n) for p, n in wave]
        for jr, tr in zip(jreqs, treqs):
            assert teng._pages_needed(tr) == jeng._pages_needed(jr)
        steps = 0
        while teng.sched.has_work or jeng.sched.has_work:
            jeng.run(max_steps=1)
            teng.run(max_steps=1)
            np.testing.assert_array_equal(teng._slot_cap, jeng._slot_cap)
            np.testing.assert_array_equal(teng._host_lens, jeng._host_lens)
            assert teng.alloc.free_count == jeng.alloc.free_count
            steps += 1
            assert steps < 100
        for jr, tr, (_, n) in zip(jreqs, treqs, wave):
            assert tr.done and len(tr.generated) == n
            assert tr.generated == jr.generated
    assert teng.prefix.hits == jeng.prefix.hits > 0
    assert teng.alloc.free_count == kw["num_pages"] - 1 - teng.prefix.resident_pages
    assert teng.metrics.decode_tokens == jeng.metrics.decode_tokens


def test_decode_burst_with_spec_raises(both_params):
    jp, tp = both_params
    with pytest.raises(ValueError):
        JEngine(jp, _jax_adapter(), max_batch=1, capacity=32, spec=JSpecConfig(),
                decode_burst=4)
    with pytest.raises(ValueError):
        InferenceEngine(tp, llama.make_adapter(CFG), max_batch=1, capacity=32, device="cpu",
                        spec=SpecConfig(), decode_burst=4)


def test_engine_bodies_are_plain_calls_on_the_cpu(both_params):
    """A CPU engine never captures: its bodies run as plain calls."""
    _, tp = both_params
    eng = InferenceEngine(tp, llama.make_adapter(CFG), max_batch=2, capacity=64,
                          kv_mode="fp8", cache_dtype=torch.float32, device="cpu",
                          decode_burst=2)
    reqs = [eng.submit(p, max_tokens=n) for p, n in WAVES[0]]
    eng.run()
    assert all(r.done for r in reqs)
    for body in (eng._decode_jit, eng._burst_jit):
        assert body.graph is None and body._calls == 0
    assert eng._burst_jit.calls > 0


class _Input:
    """A stand-in for a host tensor: records where a body sends it."""

    def __init__(self):
        self.sent = []

    def to(self, device, non_blocking=False):
        self.sent.append(str(device))
        return self


def test_disable_graphs_makes_a_card_body_a_plain_call():
    """Inside disable_graphs() a body for the card runs its function on
    every call: no warm-up count, no capture, no buffer or watch read."""
    calls = []
    body = _graph.GraphBody(lambda x: calls.append(x) or len(calls), "cuda",
                            buffers=lambda: pytest.fail("buffers read"),
                            watch=lambda: pytest.fail("watch read"))
    x = _Input()
    with _graph.disable_graphs():
        assert [body(x) for _ in range(4)] == [1, 2, 3, 4]
        with _graph.disable_graphs():
            pass
        assert not _graph._enabled
    assert _graph._enabled
    assert calls == [x] * 4 and x.sent == ["cuda"] * 4
    assert body.graph is None and body._calls == 0 and body.calls == 4


def test_tensor_versions_follow_in_place_updates():
    params = {"lm_head": torch.zeros(2, 3), "blocks": [torch.zeros(1)], "n": 3}
    key = _graph.tensor_versions(params, None)
    params["blocks"][0].add_(1)
    assert _graph.tensor_versions(params, None) == key  # only the top level
    params["lm_head"].add_(1)
    assert _graph.tensor_versions(params, None) != key


@pytest.mark.parametrize("kw", [
    dict(batch=1, sq=2048, sk=2048, heads=32, head_dim=128, causal=True, kv_heads=8),
    dict(batch=4, sq=128, sk=4096, heads=64, head_dim=128, dtype_bytes=1, lse=False),
    dict(batch=2, sq=1, sk=77, heads=4, head_dim=32),
])
def test_attention_cost_matches_jax(kw):
    _same_roofline(profiling.attention_fwd_cost(**kw), jprof.attention_fwd_cost(**kw))


@pytest.mark.parametrize("kw", [
    dict(batch=8, sk=4096, heads=32, kv_heads=8, head_dim=128, kv_bytes=1, scale_bytes=4),
    dict(batch=1, sk=640, heads=64, kv_heads=8, head_dim=128),
])
def test_decode_cost_matches_jax(kw):
    _same_roofline(profiling.decode_cost(**kw), jprof.decode_cost(**kw))


def test_roofline_matches_jax():
    for flops, nbytes in ((1e12, 1e9), (1e6, 1e10), (0.0, 5.0)):
        _same_roofline(profiling.Roofline(flops, nbytes), jprof.Roofline(flops, nbytes))
    assert profiling.chip_kind() == jprof.chip_kind() == "cpu"
    assert profiling.CHIP_PEAKS["cpu"] == jprof.CHIP_PEAKS["cpu"]


def _same_roofline(mine, theirs):
    assert mine.chip == theirs.chip == "cpu"
    assert (mine.flops, mine.bytes) == (theirs.flops, theirs.bytes)
    assert mine.ideal_seconds == theirs.ideal_seconds
    assert mine.compute_bound == theirs.compute_bound
    for secs in (1e-6, 2.5e-3):
        assert mine.report(secs) == theirs.report(secs)


def _event(start, end, device=True):
    dtype = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=f"k{start}", device_type=dtype,
                           time_range=SimpleNamespace(start=start, end=end))


def test_device_busy_is_the_union_of_device_intervals():
    """Overlapping and nested device intervals count once, host events not
    at all, and a window clips them."""
    events = [_event(0, 10), _event(5, 12), _event(6, 7), _event(20, 25),
              _event(0, 100, device=False), _event(30, 30)]
    prof = SimpleNamespace(events=lambda: events)
    assert profiling.device_busy(prof) == (17.0, 25.0)
    assert profiling.device_busy(prof, (8.0, 40.0)) == (9.0, 32.0)
    top = profiling.top_kernels(prof, 2)
    assert [name for name, _, _ in top] == ["k0", "k5"]
    assert top[0][1] == pytest.approx(0.010)


def test_trace_exports_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path) as prof:
        torch.ones(4).sum()
    assert prof.events() is not None
    assert "traceEvents" in json.loads((tmp_path / "trace.json").read_text())
    secs = profiling.benchmark(lambda: torch.ones(8).sum(), iters=3, warmup=1)
    assert secs >= 0.0

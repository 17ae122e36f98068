"""The port's paged serving path against the JAX package on the CPU: the
page allocator and prefix cache, the paged Llama steps
(``prefill_suffix_paged``, ``decode_step_paged``), and
PagedInferenceEngine token for token (tests/test_torch_paged.py holds the
paged pool and the paged decode kernel's plain version).

Inputs are made with numpy from a seed; JAX pools, params and engines
are carried over by the bridge.  The port runs the plain PyTorch versions
of its kernels (CPU tensors).  Each tolerance is stated with its reason.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.engine.engine import PagedInferenceEngine as JPagedEngine
from flash_attn_tpu.engine.paged import PagedKVPool as JPool
from flash_attn_tpu.engine.prefix_cache import PrefixCache as JPrefixCache
from flash_attn_tpu.models import llama as jllama
from flash_attn_tpu.ops.paged_decode import paged_flash_decode as j_paged_decode
from flash_attn_tpu.runtime import abi as jabi
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.engine.engine import PagedInferenceEngine
from flash_attn_tpu_torch.engine.prefix_cache import PrefixCache
from flash_attn_tpu_torch.models import llama
from flash_attn_tpu_torch.ops.paged_decode import paged_flash_decode
from flash_attn_tpu_torch.runtime.abi import PagePool
from _torch_threads import one_torch_thread  # noqa: F401

CFG = llama.LLAMA_TINY
PAGE, MAXP = 8, 4  # pages of 8, up to 4 a sequence


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


def pool_from_jax(jpool):
    return bridge.paged_pool_from_jax(jax.device_get(jpool), device="cpu")


def _owned(alloc, slot):
    """The pages of a 12-page pool that ``slot`` owns, in id order."""
    return [p for p in range(1, 12) if alloc.owner(p) == slot]


def test_page_pool_and_prefix_cache_match_jax(jax_allocator):
    """One scripted sequence of allocator and prefix-cache operations on
    both sides: the same page ids, owners, free counts, hits, misses,
    refcounts and evictions."""
    jalloc, talloc = jabi.PagePool(12), PagePool(12)
    jcache, tcache = JPrefixCache(page_size=4), PrefixCache(page_size=4)
    a = list(range(1, 14))          # 3 full pages + 1 token
    b = a[:8] + [50, 51, 52, 53, 54]  # shares 2 pages with a
    c = [7] * 9
    log = []

    def both(fn):
        j, t = fn(jalloc, jcache), fn(talloc, tcache)
        assert j == t, (j, t)
        log.append(t)

    both(lambda al, pc: al.free_count)
    both(lambda al, pc: al.acquire(0, 4))
    both(lambda al, pc: al.acquire(1, 9))  # too many: nothing taken
    both(lambda al, pc: al.acquire(1, 3))
    both(lambda al, pc: pc.lookup(a))
    both(lambda al, pc: pc.insert(a, _owned(al, 0)[:3], al, 2))
    both(lambda al, pc: [al.owner(p) for p in range(12)])
    both(lambda al, pc: al.release_slot(0))
    both(lambda al, pc: (al.free_count, pc.resident_pages))
    both(lambda al, pc: pc.lookup(b))
    both(lambda al, pc: pc.ref(b, 2))
    both(lambda al, pc: pc.lookup(a))
    both(lambda al, pc: pc.lookup(a[:12]))  # never the last page of a prompt
    both(lambda al, pc: pc.evict(5, al))  # two entries are referenced
    both(lambda al, pc: pc.unref(b, 2))
    both(lambda al, pc: pc.lookup(c))
    both(lambda al, pc: pc.evict(1, al))
    both(lambda al, pc: (pc.hits, pc.misses, pc.resident_pages, al.free_count))
    both(lambda al, pc: al.acquire(3, al.free_count))
    both(lambda al, pc: al.release_pages([1, 2, 99, 0]))
    both(lambda al, pc: al.transfer([5, 6], 4))
    both(lambda al, pc: [al.owner(p) for p in range(12)])
    assert log[1] is not None and log[2] is None


@pytest.fixture(scope="module")
def both_params():
    jp = jllama.quantize_weights(jllama.init_params(jllama.LLAMA_TINY, jax.random.PRNGKey(0)))
    return jp, bridge.params_from_jax(jax.device_get(jp), device="cpu")


@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_paged_steps_match_jax(both_params, mode):
    """A 16-token prompt prefilled into slot 0, then prefill_suffix_paged
    of 20 tokens from position 16 (two sub-chunks of 16, against the
    shuffled pages of the prefix), then three decode_step_paged steps for
    both slots: logits equal JAX's, and the pools stay equal."""
    jp, tp = both_params
    B, mp, page = 2, 8, 8
    jpool = JPool.create(CFG.num_layers, 24, page, B, mp, CFG.num_kv_heads,
                         CFG.head_dim, dtype=jnp.float32, mode=mode)
    rng = np.random.default_rng(7)
    order = rng.permutation(np.arange(1, 24))
    for b in range(B):
        jpool = jpool.assign_pages(b, order[b * mp:(b + 1) * mp].tolist())
    prompt = rng.integers(0, CFG.vocab_size, (1, 16)).astype(np.int32)
    _, kvs = jax.jit(lambda p, t, q: jllama.prefill_with_kv(
        p, t, q, jllama.LLAMA_TINY, interpret=True))(jp, jnp.asarray(prompt), jnp.arange(16)[None])
    for layer, (k, v) in enumerate(kvs):
        jpool = jpool.append_prefill(layer, 0, k[0], v[0], 0)
    jpool = jpool.set_lengths([16, 3])
    tpool = pool_from_jax(jpool)

    # jitted, as the JAX engine runs them (eager interpret mode is slow)
    j_suffix = jax.jit(lambda p, t, pool: jllama.prefill_suffix_paged(
        p, t, jllama.LLAMA_TINY, pool, 0, 16, interpret=True, sub_chunk=16))
    j_decode = jax.jit(lambda p, t, pool: jllama.decode_step_paged(
        p, t, jllama.LLAMA_TINY, pool, interpret=True))
    suffix = rng.integers(0, CFG.vocab_size, (1, 20)).astype(np.int32)
    jl, jpool = j_suffix(jp, jnp.asarray(suffix), jpool)
    tl, tpool = llama.prefill_suffix_paged(tp, torch.from_numpy(suffix).long(), CFG,
                                           tpool, 0, 16, sub_chunk=16)
    # fp32 model on both sides: fp32 sums in another order, carried
    # through two layers and the int8 weight products
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4, rtol=2e-4)
    jpool, tpool = jpool.set_lengths([36, 3]), tpool.set_lengths([36, 3])
    tok = np.asarray(jl)[0, -1].argmax()
    toks = np.array([tok, 5], np.int32)
    for _ in range(3):
        jl, jpool = j_decode(jp, jnp.asarray(toks), jpool)
        tl, tpool = llama.decode_step_paged(tp, torch.from_numpy(toks).long(), CFG, tpool)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-4, rtol=2e-4)
        toks = np.asarray(jl).argmax(-1).astype(np.int32)
    np.testing.assert_array_equal(tpool.length.numpy(), np.asarray(jpool.length))
    for layer in range(CFG.num_layers):
        for j, t in zip(jpool.gather_slot(layer, 0), tpool.gather_slot(layer, 0)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5, rtol=1e-5)


# Engine scenarios: (kv mode, engine kwargs, waves of (prompt, max_tokens)).
_SHARED = list(range(1, 17))  # two full pages of 8
ENGINE_CASES = {
    # one sequence's pages for two slots: the second request waits for the
    # first to finish (deferred admission), and slot 1 stays idle through
    # more than 32 decode steps, its length past the table's reach
    "none-deferred-idle-past-capacity": (
        "none", dict(max_batch=2, capacity=32, num_pages=5),
        [[(list(range(1, 11)), 22), (list(range(4, 14)), 22), ([9, 8, 7], 4)]]),
    # prefix cache on: a hit against a donated prefix, then a prompt that
    # needs every page, which evicts the unreferenced entries (LRU)
    "int8-prefix-hit-then-eviction": (
        "int8", dict(max_batch=1, capacity=32, num_pages=5, prefix_cache=True),
        [[(_SHARED + [21, 22, 23, 24], 3)], [(_SHARED + [31, 32], 3)],
         [(list(range(40, 65)), 6)]]),
    # prefix cache on, more requests than slots and than the pool holds
    # at once: a wave of misses (one admission round, so nothing is cached
    # yet), then a wave of hits against the donated pages
    "fp8-prefix-waves": (
        "fp8", dict(max_batch=2, capacity=48, num_pages=11, prefix_cache=True),
        [[(_SHARED + [21, 22, 23, 24, 25], 4), (_SHARED + [31], 5),
          (list(range(60, 90)), 3)],
         [(_SHARED + [41, 42, 43], 4), (_SHARED + list(range(70, 80)), 3)]]),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_paged_engine_matches_jax(jax_allocator, both_params, case):
    """Greedy tokens equal the JAX engine's token for token, wave by wave,
    with the same prefix hits, misses and resident pages, and the same
    allocator free count after each wave."""
    kv_mode, kw, waves = ENGINE_CASES[case]
    jp, tp = both_params
    jeng = JPagedEngine(jp, jllama.make_adapter(jllama.LLAMA_TINY, interpret=True),
                        page_size=PAGE, kv_mode=kv_mode, cache_dtype=jnp.float32, **kw)
    teng = PagedInferenceEngine(tp, llama.make_adapter(CFG), page_size=PAGE,
                                kv_mode=kv_mode, cache_dtype=torch.float32,
                                device="cpu", **kw)
    for wave in waves:
        jreqs = [jeng.submit(p, max_tokens=n) for p, n in wave]
        treqs = [teng.submit(p, max_tokens=n) for p, n in wave]
        jeng.run()
        teng.run()
        for jr, tr, (_, n) in zip(jreqs, treqs, wave):
            assert tr.done and len(tr.generated) == n
            assert tr.generated == jr.generated
        assert teng.alloc.free_count == jeng.alloc.free_count
        if teng.prefix is not None:
            assert (teng.prefix.hits, teng.prefix.misses, teng.prefix.resident_pages) == (
                jeng.prefix.hits, jeng.prefix.misses, jeng.prefix.resident_pages)
            assert teng.alloc.free_count == kw["num_pages"] - 1 - teng.prefix.resident_pages
        else:
            assert teng.alloc.free_count == kw["num_pages"] - 1
    assert teng.metrics.decode_tokens == jeng.metrics.decode_tokens
    if case.startswith("none"):
        assert int(teng.pool.length[1]) > MAXP * PAGE  # the idle slot ran past
    else:
        assert teng.prefix.hits > 0


def test_paged_engine_rejects_unported_options():
    """The window and the softcap, once refused, run: paged decode with
    each (and a bad value of each raising as in JAX) against JAX's kernel
    in interpret mode, fp32 (3e-4: the order of fp32 sums)."""
    r = np.random.default_rng(8)
    q = r.standard_normal((1, 2, 32)).astype(np.float32)
    pages = r.standard_normal((4, 1, 8, 32)).astype(np.float32)
    table = np.array([[2, 1]], np.int32)
    lens = np.array([13], np.int32)
    for kw in ({"window": 4}, {"logit_softcap": 3.0}):
        want = j_paged_decode(*(jnp.asarray(x) for x in (q, pages, pages, table, lens)), **kw,
                              interpret=True)
        got = paged_flash_decode(*(torch.from_numpy(x) for x in (q, pages, pages, table, lens)),
                                 **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-4, rtol=3e-4)
    t = torch.from_numpy(q)
    with pytest.raises(ValueError, match="window"):
        paged_flash_decode(t, torch.from_numpy(pages), torch.from_numpy(pages),
                           torch.from_numpy(table), torch.from_numpy(lens), window=0)

"""The port's paged KV path against the JAX package on the CPU: the paged
pool, and paged decode in decode and chunk mode (K8's plain version
against the JAX kernel in interpret mode) with its live split rule
(tests/test_torch_paged_engine.py holds the page allocator and prefix
cache, the paged Llama steps and PagedInferenceEngine).

Inputs are made with numpy from a seed; JAX pools, params and engines
are carried over by the bridge.  The port runs the plain PyTorch versions
of its kernels (CPU tensors).  Each tolerance is stated with its reason.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.engine.paged import PagedKVPool as JPool
from flash_attn_tpu.ops import quant as jquant
from flash_attn_tpu.ops.paged_decode import paged_flash_decode as j_paged_decode
from flash_attn_tpu.ops.paged_decode import paged_flash_decode_chunk as j_paged_chunk
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.engine.paged import PagedKVPool
from flash_attn_tpu_torch.ops.decode import flash_decode, flash_decode_chunk
from flash_attn_tpu_torch.ops import decode as tdec
from flash_attn_tpu_torch.ops import paged_decode as tpd
from flash_attn_tpu_torch.ops.paged_decode import (
    paged_flash_decode,
    paged_flash_decode_chunk,
)
from _torch_threads import one_torch_thread  # noqa: F401

# fp32 queries and caches on both sides: the two differ only in the order
# of fp32 sums (and the port's split-KV merge), well below 3e-4
# (tests/test_engine.py uses the same bound for the JAX kernel's own modes)
TOL = 3e-4
# a pool of 16 pages of 8 for 3 sequences of up to 4 pages, handed out in
# an order that is not 1..n, as an allocator hands them out after releases
PAGE, NPAGES, MAXP, HK, D = 8, 16, 4, 2, 32
TABLE = [[9, 3, 14, 6], [1, 12, 5, 10], [15, 2, 8, 11]]


def pool_from_jax(jpool):
    return bridge.paged_pool_from_jax(jax.device_get(jpool), device="cpu")


def to_torch(x):
    return bridge.to_torch(x, device="cpu")


def _filled_pools(mode, lens, seed=0, L=1, page=PAGE):
    """The same tokens appended to a JAX pool and to the port's (pages of
    ``page``): slot 0 by one prefill append, the others token by token;
    then the lengths.  Returns (jax pool, port pool, k, v) with k, v
    [T, B, Hk, D]."""
    r = np.random.default_rng(seed)
    B, T = len(lens), max(lens)
    k = r.standard_normal((T, B, HK, D)).astype(np.float32)
    v = r.standard_normal((T, B, HK, D)).astype(np.float32)
    jp = JPool.create(L, NPAGES, page, B, MAXP, HK, D, dtype=jnp.float32, mode=mode)
    tp = PagedKVPool.create(L, NPAGES, page, B, MAXP, HK, D, dtype=torch.float32,
                            mode=mode, device="cpu")
    for b in range(B):
        jp = jp.assign_pages(b, TABLE[b])
        tp.assign_pages(b, TABLE[b])
    for layer in range(L):
        jp = jp.append_prefill(layer, 0, jnp.asarray(k[:, 0]), jnp.asarray(v[:, 0]), 0)
        tp.append_prefill(layer, 0, torch.from_numpy(k[:, 0]), torch.from_numpy(v[:, 0]), 0)
    for t in range(T):
        for layer in range(L):
            jp = jp.append_token(layer, jnp.asarray(k[t]), jnp.asarray(v[t]))
            tp.append_token(layer, torch.from_numpy(k[t]), torch.from_numpy(v[t]))
        jp, tp = jp.advance(1), tp.advance(1)
    return jp.set_lengths(lens), tp.set_lengths(lens), k, v


@pytest.mark.parametrize("mode", ["none", "int8", "fp8"])
def test_paged_pool_matches_jax(mode):
    """append_prefill, append_token and the gather oracles equal JAX's,
    and the bridge's copy of the JAX pool equals the port's pool (the
    JAX fp8 scales, stored evens-then-odds per page, come back in natural
    order).  The raw fp8 scale buffers differ in order by design, so the
    comparison goes through the gathers."""
    jp, tp, _, _ = _filled_pools(mode, [20, 13, 32], seed=1)
    got = pool_from_jax(jp)
    np.testing.assert_array_equal(tp.block_table.numpy(), got.block_table.numpy())
    np.testing.assert_array_equal(tp.length.numpy(), got.length.numpy())
    jg, tg = jp.gather_layer(0), tp.gather_layer(0)
    for j, t in zip(jg[:2], tg[:2]):
        # identical quantization arithmetic on identical fp32 inputs
        np.testing.assert_array_equal(t.float().numpy(), to_torch(j).float().numpy())
    for mine, theirs in ((tp.k_pages[0], got.k_pages[0]), (tp.v_pages[0], got.v_pages[0])):
        np.testing.assert_array_equal(mine.float().numpy(), theirs.float().numpy())
    if mode != "none":
        # XLA may turn amax / qmax into amax * (1 / qmax): 1 ulp on a scale
        for j, t in zip(jg[2:], tg[2:]):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2.4e-7)
        np.testing.assert_allclose(tp.k_scale[0].numpy(), got.k_scale[0].numpy(), rtol=2.4e-7)
        np.testing.assert_allclose(tp.v_scale[0].numpy(), got.v_scale[0].numpy(), rtol=2.4e-7)
    for slot in range(3):
        for j, t in zip(jp.gather_slot(0, slot), tp.gather_slot(0, slot)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2.4e-7, atol=0)


def test_append_token_past_capacity_lands_on_the_last_table_entry():
    """An idle slot (table row all zeros) whose length has run past the
    table's reach writes onto the null page, as JAX's clamped gather does;
    a page index must not raise."""
    jp = JPool.create(1, NPAGES, PAGE, 2, MAXP, HK, D, dtype=jnp.float32, mode="int8")
    tp = PagedKVPool.create(1, NPAGES, PAGE, 2, MAXP, HK, D, dtype=torch.float32,
                            mode="int8", device="cpu")
    jp, tp = jp.assign_pages(0, TABLE[0]), tp.assign_pages(0, TABLE[0])
    lens = [5, MAXP * PAGE + 11]
    jp, tp = jp.set_lengths(lens), tp.set_lengths(lens)
    k = np.random.default_rng(2).standard_normal((2, HK, D)).astype(np.float32)
    jp = jp.append_token(0, jnp.asarray(k), jnp.asarray(-k))
    tp.append_token(0, torch.from_numpy(k), torch.from_numpy(-k))
    got = pool_from_jax(jp)
    np.testing.assert_array_equal(tp.k_pages[0].numpy(), got.k_pages[0].numpy())
    np.testing.assert_array_equal(tp.v_pages[0].numpy(), got.v_pages[0].numpy())
    assert tp.k_pages[0][0].abs().sum() > 0  # the null page took the write


def _decode_inputs(mode, lens, seed, H=4, page=PAGE):
    jp, tp, _, _ = _filled_pools(mode, lens, seed=seed, page=page)
    q = np.random.default_rng(seed + 100).standard_normal((len(lens), H, D)).astype(np.float32)
    ks = None if jp.k_scale is None else jp.k_scale[0]
    vs = None if jp.v_scale is None else jp.v_scale[0]
    jargs = (jnp.asarray(q), jp.k_pages[0], jp.v_pages[0], jp.block_table, jp.length)
    targs = (torch.from_numpy(q), tp.k_pages[0], tp.v_pages[0], tp.block_table, tp.length)
    tkw = {} if tp.k_scale is None else {"k_scale": tp.k_scale[0], "v_scale": tp.v_scale[0]}
    return jargs, dict(k_scale=ks, v_scale=vs, scales_permuted=jp.scales_permuted), targs, tkw


@pytest.mark.parametrize("mode", ["none", "int8", "fp8"])
@pytest.mark.parametrize("softmax_mode", ["online", "clamped"])
def test_paged_decode_matches_jax(mode, softmax_mode):
    """Decode mode over a shuffled table, a partial last page (19, 11) and
    an empty sequence (0).  In interpret mode JAX's fp8 clamped ceiling is
    80 where the port's is 40 (the TPU's packed path); these scores, base 2,
    stay far below 40, so the two agree."""
    jargs, jkw, targs, tkw = _decode_inputs(mode, [19, 11, 0], seed=3)
    jo, jl = j_paged_decode(*jargs, **jkw, interpret=True, return_lse=True,
                            softmax_mode=softmax_mode)
    to, tl = paged_flash_decode(*targs, **tkw, return_lse=True, softmax_mode=softmax_mode)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tl[:2].numpy(), np.asarray(jl)[:2], atol=TOL, rtol=TOL)
    assert np.all(to[2].numpy() == 0) and np.all(tl[2].numpy() <= -1e29)


@pytest.mark.parametrize("mode,softmax_mode,T,lens,page", [
    pytest.param("none", None, 4, [22, 13], PAGE, id="none"),
    pytest.param("int8", None, 4, [22, 13], PAGE, id="int8"),
    pytest.param("fp8", None, 4, [22, 13], PAGE, id="fp8"),
    pytest.param("int8", "clamped", 4, [22, 13], PAGE, id="int8-clamped"),
    pytest.param("fp8", "online", 4, [22, 13], PAGE, id="fp8-online"),
    pytest.param("int8", None, 36, [50, 40], 16, id="int8-T36"),
    pytest.param("fp8", None, 36, [50, 40], 16, id="fp8-T36"),
])
def test_paged_chunk_matches_jax(mode, softmax_mode, T, lens, page):
    """Chunk mode (K8c's plain version): T query tokens per sequence,
    causal within the chunk (the suffix-prefill primitive), lengths
    including the chunk, in both softmax modes (fp8 defaults to clamped).
    At T = 36 the 72 rows per KV head cross one 64-row warpgroup, in a pool
    of pages of 16 whose reach (64) holds the chunk.  The scores, base 2,
    stay far below fp8's clamped ceiling (80 in JAX's interpret mode, 40 in
    the port)."""
    jargs, jkw, targs, tkw = _decode_inputs(mode, lens, seed=4, page=page)
    q = np.random.default_rng(5).standard_normal((2, T, 4, D)).astype(np.float32)
    jo, jl = j_paged_chunk(jnp.asarray(q), *jargs[1:], **jkw, interpret=True, return_lse=True,
                           softmax_mode=softmax_mode)
    to, tl = paged_flash_decode_chunk(torch.from_numpy(q), *targs[1:], **tkw, return_lse=True,
                                      softmax_mode=softmax_mode)
    assert to.shape == (2, T, 4, D) and tl.shape == (2, T, 4)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_paged_decode_matches_contiguous_decode(mode, num_splits):
    """The port's paged decode against the port's flash_decode on the same
    content, copied into a contiguous [B, Hk, S, D] cache, with the same
    split boundaries: the paged walk adds no arithmetic of its own."""
    _, _, targs, tkw = _decode_inputs(mode, [32, 9, 1], seed=6, H=8)
    q, kp, vp, table, lens = targs
    pool = PagedKVPool([kp], [vp], [tkw["k_scale"]], [tkw["v_scale"]], table, lens, mode)
    k, v, ks, vs = pool.gather_layer(0)
    want = flash_decode(q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
                        k_scale=ks[..., 0].transpose(1, 2).contiguous(),
                        v_scale=vs[..., 0].transpose(1, 2).contiguous(),
                        kv_length=lens, num_splits=num_splits, kv_layout="bhsd")
    got = paged_flash_decode(q, kp, vp, table, lens, **tkw, num_splits=num_splits)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("T,H", [pytest.param(3, 4, id="chunk"),
                                 pytest.param(1, 2 * HK * 17, id="decode-G34")])
def test_paged_chunk_splits_agree(T, H):
    """K8c's split rule (plain version): ceil(n / nsplit) of a sequence's n
    live tiles a split, so 1, 3 and 7 splits partition the same keys, also
    for a sequence far below the table's reach (5 of 32) and for a decode
    call with more than 16 heads per KV head (K8c's too).  fp32 q and int8
    pages compute in fp32, so the merged results differ only by summation
    order."""
    _, _, targs, tkw = _decode_inputs("int8", [30, 5], seed=7, H=H)
    q, kp, vp, table, lens = targs
    qc = torch.from_numpy(np.random.default_rng(8).standard_normal((2, T, H, D))).float()

    def run(n):
        if T == 1:
            return paged_flash_decode(q, kp, vp, table, lens, **tkw, num_splits=n,
                                      return_lse=True)
        return paged_flash_decode_chunk(qc, kp, vp, table, lens, **tkw, return_lse=True,
                                        num_splits=n)

    want, want_lse = run(1)
    for n in (3, 7):
        got, got_lse = run(n)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(got_lse.numpy(), want_lse.numpy(), atol=1e-6, rtol=1e-6)


# K8's decode mode at a reach of 16 key tiles: pages of 128 (two tiles
# each, K8's smallest ratio of page to tile but one) in a shuffled table of
# 8 pages; lengths 0, 1, 63, 64, 65 (around the first tile), a page
# boundary, the reach and past it
LIVE_PAGE, LIVE_MAXP, LIVE_LENS = 128, 8, [0, 1, 63, 64, 65, 256, 1024, 1100]


@functools.lru_cache(maxsize=None)
def _live_case(kv, softmax_mode):
    """(JAX out, JAX lse, port args, port kwargs) of one decode-mode call
    over a pool whose pages hold random values, quantized by JAX's
    quantize_kv for int8/fp8 (bf16 pages as they are); q fp32."""
    r = np.random.default_rng(11)
    P, Hk, H = LIVE_MAXP * len(LIVE_LENS) + 1, HK, 2 * HK
    k = r.standard_normal((P, Hk, LIVE_PAGE, D)).astype(np.float32)
    v = r.standard_normal((P, Hk, LIVE_PAGE, D)).astype(np.float32)
    q = r.standard_normal((len(LIVE_LENS), H, D)).astype(np.float32)
    table = (1 + r.permutation(P - 1)).reshape(len(LIVE_LENS), LIVE_MAXP).astype(np.int32)
    lens = np.array(LIVE_LENS, np.int32)
    if kv == "bf16":
        jk, jv = jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)
        jks = jvs = None
    else:  # scales [P, Hk, page, 1]
        jk, jks, jv, jvs = jquant.quantize_kv(jnp.asarray(k), jnp.asarray(v), kv)
    jkw = {} if jks is None else dict(k_scale=jnp.swapaxes(jks, -1, -2),
                                      v_scale=jnp.swapaxes(jvs, -1, -2), scales_permuted=False)
    jo, jl = j_paged_decode(jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lens),
                            **jkw, interpret=True, return_lse=True, softmax_mode=softmax_mode)
    targs = (torch.from_numpy(q), to_torch(jk), to_torch(jv), torch.from_numpy(table),
             torch.from_numpy(lens))
    tkw = {} if jks is None else dict(k_scale=to_torch(jks)[..., 0].contiguous(),
                                      v_scale=to_torch(jvs)[..., 0].contiguous())
    return np.asarray(jo), np.asarray(jl), targs, tkw


@pytest.mark.parametrize("num_splits", [1, 3, 13])
@pytest.mark.parametrize("softmax_mode", ["online", "clamped"])
@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
def test_paged_decode_live_splits_match_jax(kv, softmax_mode, num_splits):
    """Decode mode (K8's plain version) now cuts each sequence's live walk
    into the splits, as K8 does on the card: 1, 3 and 13 splits of a
    16-tile reach against JAX's paged decode in interpret mode, at lengths
    0, 1, 63, 64, 65, a page boundary (256), the reach (1024) and past it
    (1100, seen as the reach).  fp32 q on both sides; the scores, base 2,
    stay far below fp8's clamped ceiling (80 in JAX's interpret mode, 40 in
    the port).  The two differ by fp32 sums in another order and the
    merge, well inside TOL; the empty sequence is out 0, lse <= -1e29."""
    jo, jl, targs, tkw = _live_case(kv, softmax_mode)
    to, tl = paged_flash_decode(*targs, **tkw, return_lse=True, softmax_mode=softmax_mode,
                                num_splits=num_splits)
    np.testing.assert_allclose(to.numpy(), jo, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(tl[1:].numpy(), jl[1:], atol=TOL, rtol=TOL)
    assert np.all(to[0].numpy() == 0) and np.all(tl[0].numpy() <= -1e29)


@pytest.mark.parametrize("chunk,rows", [pytest.param(1, 4, id="decode-G4"),
                                        pytest.param(1, 16, id="decode-G16"),
                                        pytest.param(1, 17, id="decode-G17"),
                                        pytest.param(5, 20, id="chunk-T5"),
                                        pytest.param(128, 512, id="chunk-T128")])
@pytest.mark.parametrize("num_splits", [None, 3])
def test_paged_decode_plans_live_splits(monkeypatch, chunk, rows, num_splits):
    """The routing: a decode-mode call with at most 16 query rows per KV
    head (K8) plans the live splits (split_len None) at K8's block target;
    more rows, and chunk mode, go to K8c and plan as before
    (ops/decode.py _chunk_splits).  The plan reaches the plain version as
    planned."""
    B, Hk, page, mp = 8, 8, 128, 32
    nsplit, split_len = tpd._plan(B, Hk, rows, chunk, mp * page, num_splits)
    assert split_len is None
    if chunk == 1 and rows <= tpd._MAX_GROUP:
        want = num_splits or -(-tpd._TARGET_BLOCKS // (B * Hk))
        assert nsplit == min(want, mp * page // tpd.TILE)
    else:
        assert nsplit == tdec._chunk_splits(B, Hk, rows, mp * page, num_splits)
    real, seen = tpd.paged_flash_decode_plain, []

    def spy(*args):
        seen.append(args[-2:])  # (nsplit, split_len)
        return real(*args)

    monkeypatch.setattr(tpd, "paged_flash_decode_plain", spy)
    Hk, D2, H = 2, 32, 2 * rows // chunk
    kp = torch.randn((5, Hk, page, D2))
    table = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lens = torch.tensor([200, 70], dtype=torch.int32)
    if chunk == 1:
        paged_flash_decode(torch.randn((2, H, D2)), kp, kp, table, lens, num_splits=num_splits)
    else:
        paged_flash_decode_chunk(torch.randn((2, chunk, H, D2)), kp, kp, table, lens + chunk,
                                 num_splits=num_splits)
    assert len(seen) == 1 and seen[0] == tpd._plan(2, Hk, rows, chunk, 2 * page, num_splits)


@pytest.mark.parametrize("num_splits", [1, 3])
@pytest.mark.parametrize("mode", ["int8", "fp8"])
def test_paged_chunk_matches_contiguous_chunk(mode, num_splits):
    """K8c's plain version against K1c's on the same content, copied into a
    contiguous [B, Hk, S, D] cache (S = the table's reach), with the same
    splits: the paged walk adds no arithmetic of its own in chunk mode."""
    _, _, targs, tkw = _decode_inputs(mode, [29, 6], seed=9, H=8)
    _, kp, vp, table, lens = targs
    q = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 5, 8, D))).float()
    pool = PagedKVPool([kp], [vp], [tkw["k_scale"]], [tkw["v_scale"]], table, lens, mode)
    k, v, ks, vs = pool.gather_layer(0)
    want = flash_decode_chunk(q, k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous(),
                              k_scale=ks[..., 0].transpose(1, 2).contiguous(),
                              v_scale=vs[..., 0].transpose(1, 2).contiguous(),
                              kv_length=lens, num_splits=num_splits)
    got = paged_flash_decode_chunk(q, kp, vp, table, lens, **tkw, num_splits=num_splits)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)

"""The port's prefill paths against the JAX package, on the CPU: the varlen
helpers, K4's plain version with segment ids and positions, the tile test
K4 runs before it walks a block's key tiles (``chip_smoke.tile_test``, the
reference for the kernel's own counts on the card) and the wrapper's tile
metadata, ``flash_attention_varlen``,
``KVCache.insert_at`` / ``slot_kv_float``, ``llama.prefill_chunk`` and
``llama.prefill_packed``, and the engine with ``prefill_chunk_size``.

Inputs are made with numpy from a seed and handed to both sides.  JAX runs
its Pallas kernels in interpret mode (or, where it has one, through its
plain oracle ``mha_reference``); the port runs the plain versions of its
kernels.  Each tolerance is stated with its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from flash_attn_tpu.engine.engine import InferenceEngine as JEngine
from flash_attn_tpu.engine.engine import SpecConfig as JSpecConfig
from flash_attn_tpu.engine.kv_cache import KVCache as JKVCache
from flash_attn_tpu.models import llama as jllama
from flash_attn_tpu.ops import varlen as jvarlen
from flash_attn_tpu.ops.attention import flash_attention as j_flash_attention
from flash_attn_tpu.ops.attention import flash_attention_varlen as j_varlen
from flash_attn_tpu.ops.reference import mha_reference as j_mha_reference
from flash_attn_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from flash_attn_tpu_torch import bridge, flash_attention, flash_attention_varlen
from flash_attn_tpu_torch.engine.engine import InferenceEngine, SpecConfig
from flash_attn_tpu_torch.engine.kv_cache import KVCache
from flash_attn_tpu_torch.models import llama
from flash_attn_tpu_torch.ops import flash_fwd as ff
from flash_attn_tpu_torch.ops import varlen
from _torch_threads import one_torch_thread  # noqa: F401

CFG = llama.LLAMA_TINY
# fp32: the two sides differ by summation order (and exp2 against exp in
# the oracle): ~1e-6 on O(1) outputs
F32_TOL = 1e-5
# bf16 outputs: a bf16 rounding of an O(1) value is 2^-8 ~ 4e-3, and the
# sides round p to bf16 against different maxima (as test_torch_ops allows)
BF16_TOL = 2e-2
# LLAMA_TINY logits are O(0.1); fp32 summation order moves them ~1e-6, a
# flipped int8/fp8 KV rounding by up to ~1e-3 (as test_torch_llama allows)
LOGIT_TOL = 2e-3


def to_torch(x):
    return bridge.to_torch(x, device="cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


@pytest.fixture(scope="module")
def both_params():
    jp = jllama.quantize_weights(jllama.init_params(jllama.LLAMA_TINY, jax.random.PRNGKey(0)))
    return jp, bridge.params_from_jax(jax.device_get(jp), device="cpu")


# --- ops/varlen.py ---------------------------------------------------------

@pytest.mark.parametrize("lens,total", [([5, 3, 9], 20), ([4], 4), ([1, 1, 1, 1], 6), ([], 3)])
def test_varlen_helpers_match_jax(lens, total):
    """The four helpers, exact: cu_seqlens, segment ids (padding included)
    and positions within each run of equal ids."""
    cu_t = varlen.seqlens_to_cu_seqlens(torch.tensor(lens, dtype=torch.int32))
    cu_j = jvarlen.seqlens_to_cu_seqlens(jnp.asarray(lens, jnp.int32))
    np.testing.assert_array_equal(cu_t.numpy(), np.asarray(cu_j))
    seg_t = varlen.cu_seqlens_to_segment_ids(cu_t, total)
    seg_j = jvarlen.cu_seqlens_to_segment_ids(cu_j, total)
    np.testing.assert_array_equal(seg_t.numpy(), np.asarray(seg_j))
    np.testing.assert_array_equal(varlen.segment_ids_to_positions(seg_t).numpy(),
                                  np.asarray(jvarlen.segment_ids_to_positions(seg_j)))
    seqs = [np.arange(n * 2, dtype=np.float32).reshape(n, 2) + i for i, n in enumerate(lens)]
    if seqs:
        tp, tcu, tseg = varlen.pack_sequences(seqs, total, (2,))
        jp, jcu, jseg = jvarlen.pack_sequences(seqs, total, (2,))
        for mine, theirs in ((tp, jp), (tcu, jcu), (tseg, jseg)):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_segment_ids_to_positions_restart_on_every_change():
    """Unsorted ids: a position restarts wherever the id changes, also when
    an id comes back."""
    ids = np.array([2, 2, 0, 0, 0, 2, 1, 1, 3, 3, 3, 3], np.int32)
    np.testing.assert_array_equal(
        varlen.segment_ids_to_positions(torch.from_numpy(ids)).numpy(),
        np.asarray(jvarlen.segment_ids_to_positions(jnp.asarray(ids))))


# --- K4's plain version with masks -----------------------------------------

B, SQ, SK, H, HK, D = 2, 40, 56, 4, 2, 32


def _mask_inputs(kind, seed):
    """(q_seg, kv_seg, q_pos, kv_pos, causal, Sq, Sk) for a mask kind, as
    numpy int32 [B, S] arrays or None.  Segment cases use Sq = Sk and one
    set of sorted ids for both sides (each id present on both)."""
    r = np.random.default_rng(seed)
    segs = "seg" in kind
    sq, sk = (48, 48) if segs else (SQ, SK)
    qs = ks = qp = kp = None
    if segs:
        qs = np.sort(r.integers(1, 4, (B, sq)), axis=1).astype(np.int32)
        ks = qs.copy()
    if "pos" in kind:
        if segs:  # positions restarting a segment, as the packed prefill's
            qp = np.stack([np.asarray(jvarlen.segment_ids_to_positions(jnp.asarray(row)))
                           for row in qs]).astype(np.int32)
            kp = qp.copy()
        else:  # a chunk at start 9 over a cache of sk, and random ones
            # (queries at positions below 5 see no key)
            qp = np.stack([9 + np.arange(sq), r.integers(0, sk, sq)]).astype(np.int32)
            kp = np.stack([np.arange(sk), r.integers(5, sk + 5, sk)]).astype(np.int32)
    return qs, ks, qp, kp, "causal" in kind, sq, sk


def _qkv(seed, sq, sk, dtype):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, sq, H, D)).astype(np.float32)
    k = r.standard_normal((B, sk, HK, D)).astype(np.float32)
    v = r.standard_normal((B, sk, HK, D)).astype(np.float32)
    return [jnp.asarray(x, dtype) for x in (q, k, v)]


@pytest.mark.parametrize("softmax_mode", ["clamped", "online"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["pos", "seg_pos", "pos_causal"])
def test_flash_fwd_positions_match_jax(kind, dtype, softmax_mode):
    """Positions (a chunk over a cache, random ones with rows that see no
    key), with segment ids (the packed prefill's), and with the causal
    flag, q rotated in the kernel: out and lse against JAX's flash_fwd
    (through its flash_attention, forward only) in interpret mode.  A row
    with no live key gives 0 and lse -1e30 on both sides."""
    qs, ks, qp, kp, causal, sq, sk = _mask_inputs(kind, 1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k, v = _qkv(2, sq, sk, jdt)
    jc, js = j_rope_cos_sin(jnp.asarray(qp), D, 10000.0)
    jm = {name: None if x is None else jnp.asarray(x) for name, x in zip(
        ("q_segment_ids", "kv_segment_ids", "q_positions", "kv_positions"), (qs, ks, qp, kp))}
    jo, jl = j_flash_attention(q, k, v, causal=causal, rope_cos=jc, rope_sin=js,
                               softmax_mode=softmax_mode, return_lse=True, interpret=True,
                               **jm)
    masks = ff.Masks(*(None if x is None else torch.from_numpy(x) for x in (qs, ks, qp, kp)))
    to, tl = ff.flash_fwd_plain(to_torch(q), to_torch(k), to_torch(v), causal, D ** -0.5,
                                to_torch(jc), to_torch(js), softmax_mode == "clamped", masks)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(to), _np(jo), atol=tol, rtol=tol)
    jl = np.asarray(jl)
    live = jl > -1e29
    np.testing.assert_allclose(tl.numpy()[live], jl[live], atol=1e-4, rtol=1e-4)
    assert (tl.numpy()[~live] == ff.NEG_INF).all()
    if kind == "pos":
        assert (~live).any()  # the random positions leave rows with no key


@pytest.mark.parametrize("softmax_mode", ["clamped", "online"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["seg", "seg_causal"])
def test_flash_fwd_segments_match_reference(kind, dtype, softmax_mode):
    """Segment ids alone and with the causal flag, against JAX's exact
    mha_reference on the same (bf16-rounded) inputs."""
    qs, ks, _, _, causal, sq, sk = _mask_inputs(kind, 3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k, v = _qkv(4, sq, sk, jdt)
    jo, jl = j_mha_reference(q.astype(jnp.float32), k.astype(jnp.float32),
                             v.astype(jnp.float32), causal=causal,
                             q_segment_ids=jnp.asarray(qs), kv_segment_ids=jnp.asarray(ks),
                             return_lse=True)
    masks = ff.Masks(torch.from_numpy(qs), torch.from_numpy(ks), None, None)
    to, tl = ff.flash_fwd_plain(to_torch(q), to_torch(k), to_torch(v), causal, D ** -0.5,
                                None, None, softmax_mode == "clamped", masks)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=tol, rtol=tol)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4 if dtype == "float32"
                               else 1e-2)


def test_flash_fwd_mask_arguments():
    q = torch.zeros(1, 8, 2, 32)
    ids = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="without kv_segment_ids"):
        ff.flash_fwd(q, q, q, q_segment_ids=ids)
    with pytest.raises(ValueError, match="without q_positions"):
        ff.flash_fwd(q, q, q, kv_positions=ids)
    with pytest.raises(ValueError, match="must be"):
        ff.flash_fwd(q, q, q, q_positions=ids, kv_positions=ids[:, :4])
    # positions are differentiable (K9/K10 take them); return_lse is not
    assert flash_attention(q.clone().requires_grad_(True), q, q, q_positions=ids,
                           kv_positions=ids).requires_grad
    with pytest.raises(NotImplementedError, match="forward-only"):
        flash_attention(q.requires_grad_(True), q, q, q_positions=ids, kv_positions=ids,
                        return_lse=True)


# --- K4's tile test ----------------------------------------------------------

@pytest.mark.parametrize("case", range(6))
def test_tile_test_never_skips_a_live_pair(case):
    """The test K4 runs on each (q tile, k tile) pair before its walk
    (``chip_smoke.tile_test``, the reference the card holds the kernel's
    own tile counts to), against every (query, key) pair: a live pair's
    tiles are always
    listed, and a tile listed as needing no mask has every in-range pair
    live.  Sorted and unsorted ids, padding ids, ragged shapes, positions
    that restart or jump, with and without the causal flag."""
    r = np.random.default_rng(case)
    Bc, sq, sk = 2, int(r.integers(1, 300)), int(r.integers(1, 300))
    causal = bool(case % 2)
    if case < 2:  # packed: sorted ids with padding, positions restarting
        qs = np.sort(r.integers(0, 5, (Bc, sq)), axis=1)
        ks = np.sort(r.integers(0, 5, (Bc, sk)), axis=1)
    else:
        qs, ks = r.integers(0, 3, (Bc, sq)), r.integers(0, 3, (Bc, sk))
    qp = r.integers(0, 400, (Bc, sq)) if case != 4 else None
    kp = r.integers(0, 400, (Bc, sk)) if case != 4 else None
    if case == 5:
        qs = ks = None
    masks = ff.Masks(*(None if x is None else torch.from_numpy(x.astype(np.int32))
                       for x in (qs, ks, qp, kp)))
    _, qr = ff.tile_meta(masks.q_segment_ids, masks.q_positions, Bc, sq)
    _, kr = ff.tile_meta(masks.kv_segment_ids, masks.kv_positions, Bc, sk)
    live_t, full_t = chip_smoke.tile_test(qr, kr, causal, sq, sk)
    pairs = ff.live_pairs(masks, causal, sq, sk, "cpu").expand(Bc, sq, sk)
    nq, nk = live_t.shape[1:]
    pad = torch.zeros((Bc, nq * ff.TILE, nk * ff.TILE), dtype=torch.bool)
    pad[:, :sq, :sk] = pairs
    any_live = pad.view(Bc, nq, ff.TILE, nk, ff.TILE).any(dim=(2, 4))
    assert not (any_live & ~live_t).any()
    no_causal = ff.live_pairs(masks, False, sq, sk, "cpu").expand(Bc, sq, sk)
    in_range = torch.zeros_like(pad)
    in_range[:, :sq, :sk] = True
    pad[:, :sq, :sk] = no_causal
    all_live = (pad | ~in_range).view(Bc, nq, ff.TILE, nk, ff.TILE).all(dim=4).all(dim=2)
    assert not (full_t & ~all_live).any()


def test_tile_test_skips_at_the_packed_shape():
    """Phase 4's eight prompts packed in the 4096 bucket (646 padding
    tokens): 576 of the 4096 (q tile, k tile) pairs stay live."""
    lens = (891, 699, 586, 369, 404, 164, 195, 142)
    seg = np.zeros((1, 4096), np.int32)
    pos = np.zeros((1, 4096), np.int32)
    off = 0
    for i, n in enumerate(lens):
        seg[0, off:off + n], pos[0, off:off + n] = i + 1, np.arange(n)
        off += n
    _, r = ff.tile_meta(torch.from_numpy(seg), torch.from_numpy(pos), 1, 4096)
    live_t, full_t = chip_smoke.tile_test(r, r, False, 4096, 4096)
    assert int(live_t.sum()) == 576 and int(full_t.sum()) == 285


def test_tile_metadata_is_made_once_for_the_same_masks():
    """K4's wrapper makes the tile metadata once for the mask tensors a
    prefill's layers share: the same tensors give the same metadata
    objects, an in-place change or other tensors give new ones equal to
    ``tile_meta``'s, and inference tensors (no version) are never held."""
    seg = torch.tensor([[1] * 70 + [2] * 50 + [0] * 8], dtype=torch.int32)
    pos = varlen.segment_ids_to_positions(seg[0])[None].to(torch.int32)
    masks = ff.Masks(seg, seg, pos, pos)
    first = ff._tiles(masks, 1, 128, 128)
    assert ff._tiles(ff.Masks(seg, seg, pos, pos), 1, 128, 128) is first
    pos[0, 5] = 60
    again = ff._tiles(masks, 1, 128, 128)
    assert again is not first
    qmeta, qranges = ff.tile_meta(seg, pos, 1, 128)
    assert torch.equal(again[0], qmeta) and torch.equal(again[2], qranges)
    other = ff._tiles(ff.Masks(None, None, pos.clone(), pos), 1, 128, 128)
    assert other is not again
    assert torch.equal(other[0], ff.tile_meta(None, pos, 1, 128)[0])
    with torch.inference_mode():
        iseg = seg.clone()
    made = ff._tiles(ff.Masks(iseg, iseg, None, None), 1, 128, 128)
    assert ff._tiles.last is None
    assert torch.equal(made[3], ff.tile_meta(iseg, None, 1, 128)[1])


# --- flash_attention_varlen -------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_varlen_matches_jax(causal):
    """Three sequences with Sq != Sk per sequence and padding on both
    sides, fp32, against JAX's flash_attention_varlen in interpret mode
    (causal: bottom-right per sequence pair, through positions): out and
    lse, and with ``return_softmax`` the probabilities [H, total_q,
    total_k] too."""
    r = np.random.default_rng(7)
    cu_q, cu_k = np.array([0, 5, 12, 20], np.int32), np.array([0, 9, 15, 30], np.int32)
    q = jnp.asarray(r.standard_normal((24, H, D)), jnp.float32)
    k = jnp.asarray(r.standard_normal((32, HK, D)), jnp.float32)
    v = jnp.asarray(r.standard_normal((32, HK, D)), jnp.float32)
    jo, jl, jp = j_varlen(q, k, v, jnp.asarray(cu_q), jnp.asarray(cu_k), causal=causal,
                          return_softmax=True, interpret=True)
    to, tl = flash_attention_varlen(to_torch(q), to_torch(k), to_torch(v),
                                    torch.from_numpy(cu_q), torch.from_numpy(cu_k),
                                    causal=causal, return_lse=True)
    assert to.shape == (24, H, D) and tl.shape == (H, 24)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    so, sl, sp = flash_attention_varlen(to_torch(q), to_torch(k), to_torch(v),
                                        torch.from_numpy(cu_q), torch.from_numpy(cu_k),
                                        causal=causal, return_softmax=True)
    assert sp.shape == (H, 24, 32)
    assert torch.equal(so, to) and torch.equal(sl, tl)
    np.testing.assert_allclose(sp.numpy(), np.asarray(jp), atol=F32_TOL)


# --- KVCache.insert_at / slot_kv_float --------------------------------------

@pytest.mark.parametrize("mode", ["none", "int8", "fp8"])
def test_insert_at_and_slot_kv_float_match_jax(mode):
    """Chunks written at 0, 12 and 24 of slot 1 of a 32-position cache; the
    last one (12 rows at 24) does not fit: its values land at 20, as
    dynamic_update_slice clamps the start, and its scales at 24-31, the
    rest dropped (reproduced on purpose).  The buffers and the dequantized
    slot equal JAX's."""
    L, Bc, S, Hk, Dk = 2, 2, 32, 2, 16
    r = np.random.default_rng(11)
    jc = JKVCache.create(L, Bc, S, Hk, Dk, dtype=jnp.float32, mode=mode)
    tc = KVCache.create(L, Bc, S, Hk, Dk, dtype=torch.float32, mode=mode, device="cpu")
    for start in (0, 12, 24):
        for layer in range(L):
            k = r.standard_normal((12, Hk, Dk)).astype(np.float32)
            v = r.standard_normal((12, Hk, Dk)).astype(np.float32)
            jc = jc.insert_at(layer, 1, jnp.asarray(k), jnp.asarray(v), start)
            tc.insert_at(layer, 1, torch.from_numpy(k), torch.from_numpy(v), start)
    got = bridge.kv_cache_from_jax(jax.device_get(jc), device="cpu")
    for layer in range(L):
        for mine, theirs in ((tc.k, got.k), (tc.v, got.v)):
            np.testing.assert_array_equal(mine[layer].float().numpy(),
                                          theirs[layer].float().numpy())
        if mode != "none":
            # XLA may form amax / qmax as a multiply: 1 ulp on a scale
            np.testing.assert_allclose(tc.k_scale[layer].numpy(), got.k_scale[layer].numpy(),
                                       rtol=2.4e-7)
        for dt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
            jk, jv = jc.slot_kv_float(layer, 1, dtype=dt)
            tk, tv = tc.slot_kv_float(layer, 1, dtype=tdt)
            assert tk.shape == (1, S, Hk, Dk) and tk.is_contiguous()
            rtol = 2.4e-7 if dt == jnp.float32 else 2 ** -8
            np.testing.assert_allclose(_np(tk), _np(jk), rtol=rtol)
            np.testing.assert_allclose(_np(tv), _np(jv), rtol=rtol)


# --- llama.prefill_chunk / prefill_packed -----------------------------------

@pytest.mark.parametrize("kv_mode", ["none", "fp8"])
def test_prefill_chunk_matches_jax(both_params, kv_mode):
    """A 40-token prompt in chunks of 16 (the last one padded) into slot 1
    of a 64-position cache: every chunk's real logits and the cache equal
    JAX's prefill_chunk."""
    jp, tp = both_params
    prompt = np.random.default_rng(5).integers(0, CFG.vocab_size, 40)
    jcache = jllama.make_cache(jllama.LLAMA_TINY, 2, 64, mode=kv_mode)
    tcache = llama.make_cache(CFG, 2, 64, mode=kv_mode, device="cpu")
    # one trace for the three chunks, as the JAX engine jits it
    jchunk = jax.jit(lambda p, t, c, start: jllama.prefill_chunk(
        p, t, jllama.LLAMA_TINY, c, 1, start, interpret=True))
    for start in range(0, 40, 16):
        chunk = prompt[start:start + 16]
        toks = np.zeros((1, 16), np.int32)
        toks[0, :len(chunk)] = chunk
        jl, jcache = jchunk(jp, jnp.asarray(toks), jcache, jnp.int32(start))
        tl, tcache = llama.prefill_chunk(tp, torch.from_numpy(toks).long(), CFG, tcache, 1,
                                         start)
        assert tl.shape == (1, 16, CFG.vocab_size)
        np.testing.assert_allclose(tl.numpy()[:, :len(chunk)], np.asarray(jl)[:, :len(chunk)],
                                   atol=LOGIT_TOL)
    got = bridge.kv_cache_from_jax(jax.device_get(jcache), device="cpu")
    for layer in range(CFG.num_layers):
        for mine, theirs in ((tcache.k, got.k), (tcache.v, got.v)):
            a, b = mine[layer].float().numpy(), theirs[layer].float().numpy()
            if kv_mode == "none":
                np.testing.assert_allclose(a, b, atol=1e-5)
            else:
                # a value summed in another order can round to the
                # neighbouring e4m3 code: at most one step apart
                step = _e4m3_step(np.maximum(np.abs(a), np.abs(b)))
                assert (np.abs(a - b) <= step).all(), float((np.abs(a - b) / step).max())
        if kv_mode != "none":
            for mine, theirs in ((tcache.k_scale, got.k_scale), (tcache.v_scale, got.v_scale)):
                np.testing.assert_allclose(mine[layer].numpy(), theirs[layer].numpy(),
                                           rtol=1e-5)


def _e4m3_step(x):
    """The gap between adjacent float8_e4m3 codes in |x|'s binade: 2^(e-3)
    for |x| in [2^e, 2^(e+1)), 2^-9 among the subnormals (|x| < 2^-6)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0 ** -6))) - 3)


def test_prefill_packed_matches_jax(both_params):
    """Three prompts (10 + 7 + 9 tokens, 6 padding) in one [1, 32] row:
    the real rows' logits and every layer's K/V equal JAX's
    prefill_packed."""
    jp, tp = both_params
    r = np.random.default_rng(6)
    lens = (10, 7, 9)
    toks = np.zeros((1, 32), np.int32)
    seg = np.zeros((1, 32), np.int32)
    pos = np.zeros((1, 32), np.int32)
    off = 0
    for i, n in enumerate(lens):
        toks[0, off:off + n] = r.integers(0, CFG.vocab_size, n)
        seg[0, off:off + n] = i + 1
        pos[0, off:off + n] = np.arange(n)
        off += n
    jl, jkv = jax.jit(lambda p, *a: jllama.prefill_packed(p, *a, jllama.LLAMA_TINY,
                                                          interpret=True))(
        jp, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(seg))
    tl, tkv = llama.prefill_packed(tp, torch.from_numpy(toks).long(), torch.from_numpy(pos),
                                   torch.from_numpy(seg), CFG)
    np.testing.assert_allclose(tl.numpy()[:, :off], np.asarray(jl)[:, :off], atol=1e-4)
    for (jk, jv), (tk, tv) in zip(jkv, tkv):
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    # each prompt alone through the one-prompt prefill gives its rows
    off = 0
    for n in lens:
        one, _ = llama.prefill_with_kv(tp, torch.from_numpy(toks[:, off:off + n]).long(),
                                       torch.arange(n)[None], CFG)
        np.testing.assert_allclose(tl.numpy()[:, off:off + n], one.numpy(), atol=1e-4)
        off += n


# --- the engine with prefill_chunk_size -------------------------------------

REQUESTS = [(list(range(3, 43)), 5), ([7, 8, 9], 6), (list(range(100, 123)), 4), ([1, 2], 3)]


@pytest.mark.parametrize("case", ["int8", "fp8", "none", "fp8 burst 4", "int8 n-gram"])
def test_engine_chunked_prefill_tokens_equal_jax(both_params, case):
    """prefill_chunk_size=16 at capacity 64, four requests through two
    slots: the 40- and 23-token prompts go in chunks with decode steps for
    the other slot between them (at decode_burst 4 no burst starts while a
    slot is mid-way; with n-gram speculation the verify rounds run in
    between).  Every greedy token and the decode-token count equal the
    JAX engine's; the chunks ran and the packed path did not."""
    jp, tp = both_params
    kv_mode = case.split()[0]
    kw = {}
    jkw = {}
    if "burst" in case:
        kw = jkw = {"decode_burst": 4}
    if "n-gram" in case:
        kw = {"spec": SpecConfig(num_draft=3, ngram=2)}
        jkw = {"spec": JSpecConfig(num_draft=3, ngram=2)}
    jeng = JEngine(jp, jllama.make_adapter(jllama.LLAMA_TINY, interpret=True), max_batch=2,
                   capacity=64, kv_mode=kv_mode, cache_dtype=jnp.float32,
                   prefill_chunk_size=16, **jkw)
    chunks = []
    adapter = llama.make_adapter(CFG)
    chunk_fn = adapter.prefill_chunk
    adapter.prefill_chunk = lambda *a: chunks.append(a[4]) or chunk_fn(*a)
    teng = InferenceEngine(tp, adapter, max_batch=2, capacity=64, kv_mode=kv_mode,
                           cache_dtype=torch.float32, device="cpu", prefill_chunk_size=16, **kw)
    jreqs = [jeng.submit(p, max_tokens=n) for p, n in REQUESTS]
    treqs = [teng.submit(p, max_tokens=n) for p, n in REQUESTS]
    jeng.run()
    teng.run()
    for jr, tr, (_, n) in zip(jreqs, treqs, REQUESTS):
        assert tr.done and len(tr.generated) == n
        assert tr.generated == jr.generated
    assert chunks == [0, 16, 32, 0, 16]
    assert teng.packed_prefills == 0 and not teng._prefilling
    assert teng.metrics.decode_tokens == jeng.metrics.decode_tokens
    np.testing.assert_array_equal(teng._host_lens, jeng._host_lens)


def test_engine_prefill_chunk_size_needs_the_adapter(both_params):
    """As JAX: prefill_chunk_size is None unless the adapter has
    prefill_chunk; the packed path then runs."""
    _, tp = both_params
    adapter = llama.make_adapter(CFG)
    adapter.prefill_chunk = None
    eng = InferenceEngine(tp, adapter, max_batch=2, capacity=64, device="cpu",
                          prefill_chunk_size=16)
    assert eng.prefill_chunk_size is None
    reqs = [eng.submit(p, max_tokens=n) for p, n in REQUESTS]
    eng.run()
    assert all(r.done for r in reqs) and eng.packed_prefills >= 1

"""The PyTorch port's ops (flash_attn_tpu_torch.ops) against the JAX
package on the same inputs, on the CPU.

Inputs are made with numpy from a seed and handed to both sides.  The JAX
side runs its Pallas kernels in interpret mode, as its own tests do; the
port runs the plain PyTorch versions of its CUDA kernels (CPU tensors).
Each tolerance is stated with its reason.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from flash_attn_tpu.ops import quant as jquant
from flash_attn_tpu.ops.attention import flash_attention as j_flash_attention
from flash_attn_tpu.ops.decode import flash_decode as j_flash_decode
from flash_attn_tpu.ops.kv_append import kv_append_token as j_kv_append
from flash_attn_tpu.ops.lse import lse_merge as j_lse_merge
from flash_attn_tpu.ops.matmul import matmul_int8 as j_matmul_int8
from flash_attn_tpu.ops.reference import mha_reference as j_mha_reference
from flash_attn_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from flash_attn_tpu.ops.rope import rope_rotate as j_rope_rotate
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.ops import quant as tquant
from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.ops.decode import TILE, flash_decode, flash_decode_chunk, split_bounds
from flash_attn_tpu_torch.ops.flash_fwd import FlashConfig
from flash_attn_tpu_torch.ops.kv_append import kv_append_token
from flash_attn_tpu_torch.ops.lse import lse_merge
from flash_attn_tpu_torch.ops.matmul import matmul_int8, quantized_matmul
from flash_attn_tpu_torch.ops.reference import mha_reference
from flash_attn_tpu_torch.ops.rope import rope_cos_sin, rope_rotate
from _torch_threads import one_torch_thread  # noqa: F401

# bf16 outputs: one bf16 rounding of a value of size ~1 is 2^-8 ~ 4e-3;
# the two sides also round p (or p * v_scale) to bf16 relative to different
# running maxima, so allow a few roundings.
BF16_TOL = 2e-2


def to_torch(x):
    """The bridge onto the CPU, where these tests run the plain versions."""
    return bridge.to_torch(x, device="cpu")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_quantize_matches_jax(kind):
    x = _rng(1).standard_normal((4, 3, 64)).astype(np.float32) * 3
    x[0, 0] = 0.0  # absmax 0 -> scale 1
    jf = jquant.quantize_int8 if kind == "int8" else jquant.quantize_fp8
    tf = tquant.quantize_int8 if kind == "int8" else tquant.quantize_fp8
    jv, js = jf(jnp.asarray(x))
    tv, ts = tf(torch.from_numpy(x))
    # same arithmetic (x / scale, half-to-even / native fp8 cast): bit-exact
    np.testing.assert_array_equal(_np(to_torch(jv)), _np(tv))
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    deq = tquant.dequantize(tv, ts)
    np.testing.assert_allclose(deq.numpy(), np.asarray(jquant.dequantize(jv, js)), rtol=0, atol=0)


def test_quantize_kv_matches_jax():
    k = _rng(2).standard_normal((2, 5, 2, 16)).astype(np.float32)
    v = _rng(3).standard_normal((2, 5, 2, 16)).astype(np.float32)
    for mode in ("int8", "fp8"):
        jk, jks, jv, jvs = jquant.quantize_kv(jnp.asarray(k), jnp.asarray(v), mode)
        tk, tks, tv, tvs = tquant.quantize_kv(torch.from_numpy(k), torch.from_numpy(v), mode)
        np.testing.assert_array_equal(_np(to_torch(jk)), _np(tk))
        np.testing.assert_array_equal(_np(to_torch(jv)), _np(tv))
        np.testing.assert_array_equal(np.asarray(jks), tks.numpy())
        np.testing.assert_array_equal(np.asarray(jvs), tvs.numpy())


def test_rope_matches_jax():
    pos = np.arange(40, dtype=np.int32).reshape(2, 20) * 3
    x = _rng(4).standard_normal((2, 20, 3, 32)).astype(np.float32)
    jc, js = j_rope_cos_sin(jnp.asarray(pos), 32, 10000.0)
    tc, ts = rope_cos_sin(torch.from_numpy(pos), 32, 10000.0)
    # fp32 transcendentals of the same angles; libraries differ by ulps
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)
    jr = j_rope_rotate(jnp.asarray(x), jc, js)
    tr = rope_rotate(torch.from_numpy(x), tc, ts)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5)


def test_lse_merge_matches_jax():
    r = _rng(5)
    outs = r.standard_normal((3, 2, 4, 8)).astype(np.float32)
    lses = r.standard_normal((3, 2, 4)).astype(np.float32)
    lses[1, 0, 0] = -np.inf  # a fully masked partial weighs 0
    lses[:, 1, 1] = -np.inf  # all partials masked -> out 0, lse -inf
    jo, jl = j_lse_merge(jnp.asarray(outs), jnp.asarray(lses), axis=0)
    to, tl = lse_merge(torch.from_numpy(outs), torch.from_numpy(lses), axis=0)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)


def _merge_partials(case):
    """Split-KV partials (out [n, B, rows, D] fp32, lse [n, B, rows]) from
    the plain versions of the decode kernels at small shapes: "k1" and
    "bf16" from K1 (B=3, Hk=2, 4 heads per KV head, S=256 in 4 splits;
    lengths 256, 0 (an idle slot) and 70, so 2 of the last sequence's splits
    and all of the idle one's are at -1e30), "k8" from K8 (pages of 64,
    the same lengths), "single" from K1 in one split."""
    from flash_attn_tpu_torch.ops.decode import flash_decode_plain
    from flash_attn_tpu_torch.ops.paged_decode import paged_flash_decode_plain

    r = _rng(21)
    B, Hk, G, S, D = 3, 2, 4, 256, 32
    q = torch.from_numpy(r.standard_normal((B, Hk * G, D)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(r.standard_normal((B, Hk, S, D)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(r.standard_normal((B, Hk, S, D)).astype(np.float32)).bfloat16()
    lens = torch.tensor([256, 0, 70], dtype=torch.int32)
    nsplit, split_len = (1, 256) if case == "single" else (4, 64)
    if case != "k8":
        return flash_decode_plain(q, k, v, None, None, lens, D ** -0.5, False, 80.0,
                                  nsplit, split_len)
    page = 64
    pages = torch.cat([torch.zeros((1, Hk, page, D), dtype=torch.bfloat16),
                       k.reshape(B, Hk, S // page, page, D).transpose(1, 2)
                       .reshape(-1, Hk, page, D)])
    vpages = torch.cat([torch.zeros((1, Hk, page, D), dtype=torch.bfloat16),
                        v.reshape(B, Hk, S // page, page, D).transpose(1, 2)
                        .reshape(-1, Hk, page, D)])
    table = (1 + torch.arange(B * S // page, dtype=torch.int32)).reshape(B, S // page)
    return paged_flash_decode_plain(q, pages, vpages, None, None, table, lens, D ** -0.5,
                                    False, 80.0, 1, nsplit, split_len)


@pytest.mark.parametrize("case", ["k1", "k8", "single", "bf16"])
def test_merge_splits_matches_jax(case):
    """merge_splits (K1m's plain version on the CPU) against JAX's
    lse_merge on the decode kernels' partials: splits at -1e30, an idle
    slot whose partials are all -1e30 (out 0), one split, a bf16 output.
    Both sides merge in fp32: exp and sums in another order (1e-6); the
    bf16 output is that rounded once."""
    from flash_attn_tpu_torch.ops.decode import merge_splits

    outs, lses = _merge_partials(case)
    if case != "single":
        assert (lses[2:, 2] == -1e30).all() and (lses[:, 1] == -1e30).all()
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    to, tl = merge_splits(outs, lses, dtype)
    jo, jl = j_lse_merge(jnp.asarray(outs.numpy()), jnp.asarray(lses.numpy()), axis=0)
    assert to.dtype == dtype and to.shape == outs.shape[1:] and tl.shape == lses.shape[1:]
    want = torch.from_numpy(np.array(jo)).to(dtype)
    np.testing.assert_allclose(_np(to), _np(want), atol=1e-6 if case != "bf16" else 2e-2,
                               rtol=0 if case != "bf16" else 2.0 ** -8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6)
    assert (to[1] == 0).all() and (tl[1] <= -1e29).all()


def test_lse_merge_cuda_refuses_what_it_does_not_take():
    """K1m's wrapper checks its inputs before it builds or launches: CPU
    tensors, fp16 partials and an fp16 output raise and launch nothing."""
    from flash_attn_tpu_torch.ops.lse import lse_merge_cuda

    outs, lses = torch.zeros(3, 4, 8), torch.zeros(3, 4)
    before = lse_merge_cuda.launches
    for args in ((outs, lses, torch.bfloat16), (outs.half(), lses, torch.bfloat16),
                 (outs, lses, torch.float16), (outs, lses[:, :2], torch.float32)):
        with pytest.raises(ValueError):
            lse_merge_cuda(*args)
    assert lse_merge_cuda.launches == before


def test_mha_reference_matches_jax():
    r = _rng(6)
    q = r.standard_normal((2, 12, 4, 16)).astype(np.float32)
    k = r.standard_normal((2, 20, 2, 16)).astype(np.float32)
    v = r.standard_normal((2, 20, 2, 16)).astype(np.float32)
    jo, jl = j_mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, return_lse=True)
    to, tl = mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=True, return_lse=True)
    # fp32 einsum/softmax in both frameworks: summation-order differences
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)


def _kv_inputs(mode, B=3, Hk=2, S=64, D=32, seed=7):
    r = _rng(seed)
    store = {"none": np.float32, "int8": np.int8, "fp8": np.float32}[mode]
    kc = (r.standard_normal((B, Hk, S, D)) * 2).astype(store)
    vc = (r.standard_normal((B, Hk, S, D)) * 2).astype(store)
    ks = r.uniform(0.5, 2.0, (B, Hk, S)).astype(np.float32)
    vs = r.uniform(0.5, 2.0, (B, Hk, S)).astype(np.float32)
    nk = (r.standard_normal((B, Hk, D)) * 3).astype(np.float32)
    nv = (r.standard_normal((B, Hk, D)) * 3).astype(np.float32)
    return kc, vc, ks, vs, nk, nv


@pytest.mark.parametrize("mode", ["none", "int8", "fp8"])
def test_kv_append_matches_jax(mode):
    kc, vc, ks, vs, nk, nv = _kv_inputs(mode)
    length = np.array([0, 17, 63], np.int32)
    jdt = {"none": jnp.bfloat16, "int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[mode]
    jkc, jvc = jnp.asarray(kc).astype(jdt), jnp.asarray(vc).astype(jdt)
    jks = None if mode == "none" else jnp.asarray(ks)[:, :, None, :]
    jvs = None if mode == "none" else jnp.asarray(vs)[:, :, None, :]
    jnk = jnp.asarray(nk).astype(jnp.bfloat16)
    jnv = jnp.asarray(nv).astype(jnp.bfloat16)
    out = j_kv_append(jkc, jvc, jks, jvs, jnk, jnv, jnp.asarray(length),
                      mode=mode, interpret=True)
    tkc, tvc = to_torch(jkc), to_torch(jvc)
    tks = None if mode == "none" else torch.from_numpy(ks.copy())
    tvs = None if mode == "none" else torch.from_numpy(vs.copy())
    kv_append_token(tkc, tvc, tks, tvs, to_torch(jnk), to_torch(jnv),
                    torch.from_numpy(length), mode=mode)
    # identical arithmetic on identical bf16 inputs: bit-exact caches
    np.testing.assert_array_equal(_np(tkc), _np(to_torch(out[0])))
    np.testing.assert_array_equal(_np(tvc), _np(to_torch(out[1])))
    if mode != "none":
        # XLA may turn amax / qmax into amax * (1 / qmax): 1 ulp on a scale
        np.testing.assert_allclose(tks.numpy(), np.asarray(out[2])[:, :, 0], rtol=2.4e-7)
        np.testing.assert_allclose(tvs.numpy(), np.asarray(out[3])[:, :, 0], rtol=2.4e-7)


@pytest.mark.parametrize("mode", ["none", "int8", "fp8"])
def test_kv_append_past_capacity_writes_nothing(mode):
    """Idle engine slots keep advancing past the capacity: K2 must skip
    them and still write the live ones."""
    kc, vc, ks, vs, nk, nv = _kv_inputs(mode, S=32)
    dt = {"none": torch.bfloat16, "int8": torch.int8, "fp8": torch.float8_e4m3fn}[mode]
    tkc, tvc = torch.from_numpy(kc).to(dt), torch.from_numpy(vc).to(dt)
    before_k, before_v = tkc.clone(), tvc.clone()
    tks = None if mode == "none" else torch.from_numpy(ks.copy())
    tvs = None if mode == "none" else torch.from_numpy(vs.copy())
    length = torch.tensor([32, 45, 5], dtype=torch.int32)
    kv_append_token(tkc, tvc, tks, tvs, torch.from_numpy(nk).bfloat16(),
                    torch.from_numpy(nv).bfloat16(), length, mode=mode)
    np.testing.assert_array_equal(_np(tkc[:2]), _np(before_k[:2]))
    np.testing.assert_array_equal(_np(tvc[:2]), _np(before_v[:2]))
    if mode != "none":
        np.testing.assert_array_equal(tks[:2].numpy(), ks[:2])
    changed = (_np(tkc[2]) != _np(before_k[2])).any(axis=-1)  # [Hk, S]
    assert changed[:, 5].all() and not changed[:, :5].any() and not changed[:, 6:].any()


def _edge_rows(mode, S=64, seed=9):
    """K2's edge cases, one sequence each: an all-zero row (scale 1), rows
    whose absmax is exactly 127 and exactly 448 (bf16-exact, so 127 and 448
    reach the quantizer as they are), a random row, and the two lengths
    JAX's kernel does not take: negative and == S."""
    kc, vc, ks, vs, nk, nv = _kv_inputs(mode, B=6, S=S, seed=seed)
    for x in (nk, nv):
        x[0] = 0.0
        x[1] = np.clip(x[1], -100, 100)
        x[1, :, 3] = 127.0
        x[2] = np.clip(x[2], -400, 400)
        x[2, :, 5] = -448.0
    return kc, vc, ks, vs, nk, nv, np.array([3, 10, 63, 0, -1, S], np.int32)


@pytest.mark.parametrize("mode", ["none", "int8", "fp8"])
def test_kv_append_edge_cases_match_jax(mode):
    """K2's plain version (bitwise K2 on the card) against JAX's
    kv_append_token on the edge cases of _edge_rows.  Rows in range: caches
    bit-exact (identical arithmetic on identical bf16 inputs; the zero row
    keeps scale 1, the 127 and 448 rows scale 1 in their own mode), scales
    within 1 ulp (XLA may turn amax / qmax into a reciprocal multiply).
    JAX's kernel takes only lengths in [0, S) (its block index clamps, so it
    writes elsewhere); the port writes nothing there, as K2 does for the
    engine's idle slots: those sequences keep their cache and scales."""
    kc, vc, ks, vs, nk, nv, length = _edge_rows(mode)
    jdt = {"none": jnp.bfloat16, "int8": jnp.int8, "fp8": jnp.float8_e4m3fn}[mode]
    jkc, jvc = jnp.asarray(kc).astype(jdt), jnp.asarray(vc).astype(jdt)
    jks = None if mode == "none" else jnp.asarray(ks)[:, :, None, :]
    jvs = None if mode == "none" else jnp.asarray(vs)[:, :, None, :]
    jnk = jnp.asarray(nk).astype(jnp.bfloat16)
    jnv = jnp.asarray(nv).astype(jnp.bfloat16)
    out = j_kv_append(jkc, jvc, jks, jvs, jnk, jnv, jnp.asarray(length), mode=mode,
                      interpret=True)
    tkc, tvc = to_torch(jkc), to_torch(jvc)
    before = [_np(tkc), _np(tvc)]
    tks = None if mode == "none" else torch.from_numpy(ks.copy())
    tvs = None if mode == "none" else torch.from_numpy(vs.copy())
    kv_append_token(tkc, tvc, tks, tvs, to_torch(jnk), to_torch(jnv),
                    torch.from_numpy(length), mode=mode)
    live = slice(0, 4)
    np.testing.assert_array_equal(_np(tkc)[live], _np(to_torch(out[0]))[live])
    np.testing.assert_array_equal(_np(tvc)[live], _np(to_torch(out[1]))[live])
    np.testing.assert_array_equal(_np(tkc)[4:], before[0][4:])
    np.testing.assert_array_equal(_np(tvc)[4:], before[1][4:])
    if mode != "none":
        for mine, theirs, orig in ((tks, out[2], ks), (tvs, out[3], vs)):
            np.testing.assert_allclose(mine.numpy()[live], np.asarray(theirs)[live, :, 0],
                                       rtol=2.4e-7)
            np.testing.assert_array_equal(mine.numpy()[4:], orig[4:])
        qmax = 127.0 if mode == "int8" else 448.0
        pos = length[:3]
        got = tks.numpy()[np.arange(3), :, pos]  # [3, Hk]
        np.testing.assert_array_equal(got[0], 1.0)  # the all-zero row
        np.testing.assert_array_equal(got[1], np.float32(127.0) / np.float32(qmax))
        np.testing.assert_array_equal(got[2], np.float32(448.0) / np.float32(qmax))


@settings(max_examples=200, deadline=None, database=None)
@given(nsplit=st.integers(1, 40), tiles=st.integers(1, 64),
       lens=st.lists(st.integers(-70, 64 * 64 + 100), min_size=1, max_size=8))
def test_split_bounds_cover_each_live_tile_once(nsplit, tiles, lens):
    """split_bounds(nsplit, None, S, kv_length), the live split rule of K8,
    K8c, K1c and their plain versions: for every sequence the splits' key
    ranges, cut to the live walk min(kv_length, S) rounded up to whole
    tiles, are disjoint and cover each live tile exactly once, whatever the
    lengths (negative, 0, past S) and the split count."""
    S = tiles * TILE
    kv_length = torch.tensor(lens, dtype=torch.int32)
    bounds = split_bounds(nsplit, None, S, kv_length)
    assert len(bounds) == nsplit
    for b, n in enumerate(lens):
        n_live = -(-min(max(n, 0), S) // TILE)
        count = np.zeros(n_live, np.int64)
        for lo, hi in bounds:
            lo, hi = int(lo[b]), int(hi[b])
            assert lo % TILE == 0 and hi % TILE == 0 and lo <= hi
            for t in range(lo // TILE, min(hi // TILE, n_live)):
                count[t] += 1
        np.testing.assert_array_equal(count, 1)


def _decode_case(kv, seed=8, B=2, H=8, Hk=2, S=256, D=64):
    r = _rng(seed)
    q = r.standard_normal((B, H, D)).astype(np.float32)
    k = r.standard_normal((B, Hk, S, D)).astype(np.float32)
    v = r.standard_normal((B, Hk, S, D)).astype(np.float32)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    if kv == "bf16":
        jk, jv = jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16)
        jks = jvs = None
    else:
        jk, jks, jv, jvs = jquant.quantize_kv(jnp.asarray(k), jnp.asarray(v), kv)
    return jq, jk, jv, jks, jvs


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("softmax_mode", ["online", "clamped"])
@pytest.mark.parametrize("num_splits", [1, 3])
def test_flash_decode_matches_jax(kv, softmax_mode, num_splits):
    jq, jk, jv, jks, jvs = _decode_case(kv)
    kv_length = np.array([200, 37], np.int32)
    jo, jl = j_flash_decode(
        jq, jk, jv, k_scale=jks, v_scale=jvs, kv_length=jnp.asarray(kv_length),
        kv_layout="bhsd", softmax_mode=softmax_mode, return_lse=True,
        interpret=True)
    ks = None if jks is None else to_torch(jks)[..., 0].contiguous()
    vs = None if jvs is None else to_torch(jvs)[..., 0].contiguous()
    to, tl = flash_decode(
        to_torch(jq), to_torch(jk), to_torch(jv), k_scale=ks, v_scale=vs,
        kv_length=torch.from_numpy(kv_length), kv_layout="bhsd",
        softmax_mode=softmax_mode, num_splits=num_splits, return_lse=True)
    assert to.dtype == torch.bfloat16 and to.shape == (2, 8, 64)
    np.testing.assert_allclose(_np(to), _np(to_torch(jo)), atol=BF16_TOL, rtol=BF16_TOL)
    # lse sums fp32 p in both; only the bf16 q pre-scale is shared rounding
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


def test_flash_decode_default_mode_follows_kv_dtype():
    from flash_attn_tpu_torch.ops.decode import _default_softmax_mode

    assert _default_softmax_mode(torch.float8_e4m3fn) == "clamped"
    assert _default_softmax_mode(torch.int8) == "online"
    assert _default_softmax_mode(torch.bfloat16) == "online"
    assert _default_softmax_mode(torch.float8_e4m3fn, logit_softcap=50.0) == "online"


def test_flash_decode_matches_oracle_fp32():
    """fp32 query and cache: the plain K1 equals exact attention."""
    r = _rng(9)
    q = torch.from_numpy(r.standard_normal((3, 4, 32)).astype(np.float32))
    k = torch.from_numpy(r.standard_normal((3, 2, 96, 32)).astype(np.float32))
    v = torch.from_numpy(r.standard_normal((3, 2, 96, 32)).astype(np.float32))
    kv_length = torch.tensor([96, 1, 50], dtype=torch.int32)
    out = flash_decode(q, k, v, kv_length=kv_length, kv_layout="bhsd")
    for b in range(3):
        n = int(kv_length[b])
        want = mha_reference(q[b:b + 1, None], k[b:b + 1, :, :n].transpose(1, 2),
                             v[b:b + 1, :, :n].transpose(1, 2))[0, 0]
        np.testing.assert_allclose(out[b].numpy(), want.numpy(), atol=1e-5)


def test_flash_decode_rejects_unported_options():
    """Window and softcap run over a BHSD cache, in decode mode and in
    chunk mode (a chunk of one token is the decode step, window and
    softcap included); the BSHD layout still raises on them."""
    q = torch.zeros(1, 2, 32)
    k = torch.zeros(1, 1, 64, 32)
    with pytest.raises(NotImplementedError):
        flash_decode(q, k.transpose(1, 2), k.transpose(1, 2), window=16, kv_layout="bshd")
    with pytest.raises(NotImplementedError):
        flash_decode(q, k.transpose(1, 2), k.transpose(1, 2), logit_softcap=30.0,
                     kv_layout="bshd")
    r = _rng(12)
    qr = torch.from_numpy(r.standard_normal((2, 2, 32)).astype(np.float32))
    kr, vr = (torch.from_numpy(r.standard_normal((2, 1, 64, 32)).astype(np.float32))
              for _ in range(2))
    lens = torch.tensor([64, 21], dtype=torch.int32)
    got = flash_decode_chunk(qr[:, None], kr, vr, kv_length=lens, window=16, logit_softcap=3.0)
    want = flash_decode(qr, kr, vr, kv_length=lens, window=16, logit_softcap=3.0,
                        kv_layout="bhsd")
    np.testing.assert_allclose(got[:, 0].numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("M", [5, 40])
def test_matmul_int8_matches_jax(M):
    r = _rng(10)
    x = r.standard_normal((M, 256)).astype(np.float32)
    w = r.standard_normal((256, 384)).astype(np.float32) * 0.02
    jw, js = jquant.quantize_int8(jnp.asarray(w), axes=(0,))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jo = j_matmul_int8(jx, jw, js[0], interpret=True)
    to = matmul_int8(to_torch(jx), to_torch(jw), to_torch(js[0]))
    assert to.dtype == torch.bfloat16 and to.shape == (M, 384)
    # fp32 accumulation of identical products; the bf16 output rounding
    # (2^-8 relative) is the only visible difference
    np.testing.assert_allclose(_np(to), _np(to_torch(jo)), rtol=1e-2, atol=1e-3)
    # the tuple dispatch reaches the same function
    np.testing.assert_array_equal(
        _np(quantized_matmul(to_torch(jx), (to_torch(jw), to_torch(js[0])))), _np(to))


def test_quantized_matmul_float_weight():
    r = _rng(11)
    x = torch.from_numpy(r.standard_normal((3, 64)).astype(np.float32))
    w = torch.from_numpy(r.standard_normal((64, 32)).astype(np.float32)).bfloat16()
    out = quantized_matmul(x, w)
    assert out.dtype == torch.float32  # x.dtype, as jnp.dot(...).astype(x.dtype)
    np.testing.assert_allclose(out.numpy(), (x @ w.float()).numpy(), atol=1e-5)


@pytest.mark.parametrize("softmax_mode", ["clamped", "online"])
def test_flash_fwd_matches_jax(softmax_mode):
    r = _rng(12)
    B, S, H, Hk, D = 1, 96, 4, 2, 64
    q = jnp.asarray(r.standard_normal((B, S, H, D)), jnp.bfloat16)
    k = jnp.asarray(r.standard_normal((B, S, Hk, D)), jnp.bfloat16)
    v = jnp.asarray(r.standard_normal((B, S, Hk, D)), jnp.bfloat16)
    pos = np.arange(S, dtype=np.int32)[None]
    jc, js = j_rope_cos_sin(jnp.asarray(pos), D, 10000.0)
    jo, jl = j_flash_attention(q, k, v, causal=True, rope_cos=jc, rope_sin=js,
                               softmax_mode=softmax_mode, return_lse=True,
                               interpret=True)
    to, tl = flash_attention(to_torch(q), to_torch(k), to_torch(v), causal=True,
                             rope_cos=to_torch(jc), rope_sin=to_torch(js),
                             softmax_mode=softmax_mode, return_lse=True)
    assert to.dtype == torch.bfloat16 and to.shape == (B, S, H, D)
    np.testing.assert_allclose(_np(to), _np(to_torch(jo)), atol=BF16_TOL, rtol=BF16_TOL)
    # fp32 softmax sums; only summation order differs
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    # and against the port's own oracle on the rotated q (fp32, exact
    # softmax): bf16 rounding of q, p and out
    qr = rope_rotate(to_torch(q).float(), to_torch(jc), to_torch(js))
    want = mha_reference(qr, to_torch(k).float(), to_torch(v).float(), causal=True)
    np.testing.assert_allclose(_np(to), want.numpy(), atol=3e-2, rtol=3e-2)


# Shapes for K4's plain version at Llama-3's head_dim: (B, Sq, Sk, H, Hk,
# causal, per-batch rope): ragged Sq = Sk = 77, a shifted causal 50 / 130,
# G = 3, and two sequences with their own rope tables.
FWD_CASES = {
    "ragged77": (1, 77, 77, 4, 2, True, False),
    "shifted50x130": (1, 50, 130, 4, 2, True, False),
    "g3": (1, 64, 64, 6, 2, True, False),
    "b2_rope_per_batch": (2, 40, 40, 4, 2, True, True),
}


@pytest.mark.parametrize("softmax_mode", ["clamped", "online"])
@pytest.mark.parametrize("case", list(FWD_CASES))
def test_flash_fwd_plain_matches_reference(case, softmax_mode):
    """The plain version that K4 is held against, at D=128, against JAX's
    exact fp32 mha_reference on the same q rotated in fp32: the plain
    version rounds the scaled q, the rotated q, p and out to bf16 (a few
    bf16 ulps of O(1) values, as test_flash_fwd_matches_jax allows), and
    its LSE moves by the scores' rounding (measured below 4e-3; output
    errors at most 1.6e-2)."""
    from flash_attn_tpu_torch.ops.flash_fwd import flash_fwd_plain

    B, Sq, Sk, H, Hk, causal, per_batch = FWD_CASES[case]
    D = 128
    r = _rng(31)
    q = r.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = r.standard_normal((B, Sk, Hk, D)).astype(np.float32)
    v = r.standard_normal((B, Sk, Hk, D)).astype(np.float32)
    pos = (np.arange(Sq, dtype=np.int32)[None] + 7 * np.arange(B, dtype=np.int32)[:, None]
           if per_batch else np.arange(Sq, dtype=np.int32)[None])
    jc, js = j_rope_cos_sin(jnp.asarray(pos), D, 500000.0)
    tq, tk, tv = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    cos, sin = to_torch(jc), to_torch(js)
    to, tl = flash_fwd_plain(tq, tk, tv, causal, D ** -0.5, cos, sin,
                             softmax_mode == "clamped")
    jq = j_rope_rotate(jnp.asarray(tq.float().numpy()), jc, js)
    jo, jl = j_mha_reference(jq, jnp.asarray(tk.float().numpy()),
                             jnp.asarray(tv.float().numpy()), causal=causal,
                             return_lse=True)
    assert to.dtype == torch.bfloat16 and to.shape == (B, Sq, H, D) and tl.shape == (B, H, Sq)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=3e-2, rtol=3e-2)
    live = np.isfinite(np.asarray(jl))
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], atol=1e-2)
    # rows with nothing to attend: out 0, lse -1e30 (the reference's -inf)
    assert (tl.numpy()[~live] == -1e30).all()


def test_flash_attention_rejects_unported_options():
    """A window with a mask or dropout; ALiBi with a window or a softcap;
    softmax_dtype "bf16".  The mask and dropout alone run
    (tests/test_torch_fa2_options.py), and so do ALiBi, return_softmax, a
    mask that needs a gradient (tests/test_torch_fa2_surface.py) and a
    window with positions (positions 0..7 give the causal window)."""
    q = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    assert flash_attention(q, q, q, alibi_slopes=torch.ones(2)).shape == q.shape
    assert flash_attention(q, q, q, return_softmax=True)[2].shape == (1, 2, 8, 8)
    m = torch.zeros(8, 8, requires_grad=True)
    flash_attention(q, q, q, mask=m).float().sum().backward()
    assert m.grad.shape == (8, 8)
    qr = torch.from_numpy(_rng(13).standard_normal((1, 8, 2, 32)).astype(np.float32))
    pos = torch.arange(8, dtype=torch.int32)[None]
    assert torch.equal(flash_attention(qr, qr, qr, window=(4, 0), q_positions=pos,
                                       kv_positions=pos),
                       flash_attention(qr, qr, qr, window=(4, 0), causal=True))
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, window=(4, 0), mask=torch.zeros(8, 8))
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, logit_softcap=30.0, dropout_rate=0.1)
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, alibi_slopes=torch.ones(2), window=(4, -1))
    with pytest.raises(NotImplementedError):
        flash_attention(q, q, q, alibi_slopes=torch.ones(2), logit_softcap=30.0)
    with pytest.raises(NotImplementedError, match="bf16"):
        flash_attention(q, q, q, config=FlashConfig(softmax_dtype="bf16"))

"""The rest of the FA2 surface against the JAX package on the CPU:
``alibi_slopes``, ALiBi in the forward and the backward, dbias (each
broadcast shape of the bias, with dropout, through the ring), varlen
``return_softmax`` and its mask's gradient, ``clamped_verify`` and
``auto``, ``FlashConfig``, the ported oracle (``attention_bias``,
``mha_reference`` with every option, ``mha_reference_vjp``) and the
combinations still refused.

Inputs come from numpy seeds and reach both sides through numpy.  JAX
runs its jnp oracles (``mha_reference``, ``mha_reference_vjp``,
``_jnp_backward``), and its Pallas kernels in interpret mode only for
``return_softmax``, the ``clamped_verify`` flags, ``auto`` and dbias with
dropout; the port runs its plain versions.  Tolerances: fp32 forward 1e-5
of O(1) outputs, gradients and dbias 2e-6 of the largest (summation order
only), flags exactly equal, bf16 1e-2 relative (a rounding of the output
or of an element of P).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.ops import flash_fwd as jff
from flash_attn_tpu.ops import reference as jref
from flash_attn_tpu.ops.alibi import alibi_slopes as j_alibi_slopes
from flash_attn_tpu.ops.attention import _jnp_backward
from flash_attn_tpu.ops.attention import flash_attention_varlen as j_varlen
from flash_attn_tpu.ops.flash_bwd import flash_bwd as j_flash_bwd
from flash_attn_tpu_torch import FlashConfig, alibi_slopes, bridge
from flash_attn_tpu_torch.ops import flash_bwd as fb
from flash_attn_tpu_torch.ops import flash_fwd as ff
from flash_attn_tpu_torch.ops import reference as ref
from flash_attn_tpu_torch.ops.attention import flash_attention, flash_attention_varlen
from flash_attn_tpu_torch.parallel.mesh import host_local_mesh
from flash_attn_tpu_torch.parallel.ring import make_ring_attention, stripe_sequence
from _torch_threads import one_torch_thread  # noqa: F401

B, SQ, SK, HK, D = 2, 40, 56, 2, 32
FWD_TOL = 1e-5
GRAD_TOL = 2e-6
HALF_TOL = 1e-2


def T(x):
    """A JAX or numpy array -> a CPU tensor (bf16 kept)."""
    return bridge.to_torch(jax.device_get(x), device="cpu")


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    g = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


def inputs(seed, h=6, sq=SQ, sk=SK, dtype="float32", b=B, hk=HK):
    """q, k, v, dout as JAX arrays."""
    rng = np.random.default_rng(seed)
    arr = lambda *s: jnp.asarray(rng.standard_normal(s), jnp.float32).astype(dtype)  # noqa: E731
    return arr(b, sq, h, D), arr(b, sk, hk, D), arr(b, sk, hk, D), arr(b, sq, h, D)


def bias_of(seed, shape):
    """A random bias (scale 2), -inf on every 7th entry."""
    b = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 2
    b.reshape(-1)[::7] = -np.inf
    return b


# --- alibi_slopes and FlashConfig ---------------------------------------------

@pytest.mark.parametrize("h", [1, 6, 8, 12])
def test_alibi_slopes_exact(h):
    """The schedule, also where it interleaves (6 and GPT-2's 12 heads),
    bit for bit JAX's."""
    got = alibi_slopes(h)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, j_alibi_slopes(h))


def test_flash_config_fields_are_jax():
    """FlashConfig's field names and defaults are JAX's."""
    mine = [(f.name, f.default) for f in dataclasses.fields(FlashConfig)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jff.FlashConfig)]
    assert mine == theirs


# --- ALiBi ---------------------------------------------------------------------

ALIBI_CASES = [("causal", True, SQ, SK), ("not causal", False, SQ, SK),
               ("causal square", True, SK, SK)]


@pytest.mark.parametrize("name,causal,sq,sk", ALIBI_CASES, ids=[c[0] for c in ALIBI_CASES])
@pytest.mark.parametrize("mode", ["online", "clamped"])
def test_alibi_forward_matches_jax(name, causal, sq, sk, mode):
    """K4's plain version with ALiBi (6 heads over 2: the interleaved
    schedule, GQA 3) against JAX's mha_reference, bottom-right: out to
    1e-5, lse to 1e-5."""
    q, k, v, _ = inputs(1, sq=sq, sk=sk)
    sl = alibi_slopes(6)
    want, wlse = jref.mha_reference(q, k, v, causal=causal, alibi_slopes=sl, return_lse=True)
    out, lse = ff.flash_fwd(T(q), T(k), T(v), causal=causal, alibi_slopes=sl, softmax_mode=mode)
    assert rel_err(out, want) < FWD_TOL
    np.testing.assert_allclose(lse.numpy(), np.asarray(wlse), atol=FWD_TOL, rtol=FWD_TOL)


def test_alibi_forward_bf16_matches_jax():
    """bf16 inputs with ALiBi, causal, against the oracle on the same
    values: 1e-2 relative."""
    q, k, v, _ = inputs(2, dtype="bfloat16")
    sl = alibi_slopes(6)
    want = jref.mha_reference(*(x.astype(jnp.float32) for x in (q, k, v)), causal=True,
                              alibi_slopes=sl)
    out, _ = ff.flash_fwd(T(q), T(k), T(v), causal=True, alibi_slopes=sl)
    assert out.dtype == torch.bfloat16 and rel_err(out, want) < HALF_TOL


@pytest.mark.parametrize("name,causal,sq,sk", ALIBI_CASES, ids=[c[0] for c in ALIBI_CASES])
def test_alibi_grads_match_jax(name, causal, sq, sk):
    """The autograd flash_attention with ALiBi (K4 + K9 + K10's plain
    versions) against JAX's _jnp_backward on the oracle's out and lse:
    dq, dk, dv to 2e-6 of the largest; the slopes get zeros."""
    q, k, v, dout = inputs(3, sq=sq, sk=sk)
    sl = alibi_slopes(6)
    jout, jlse = jref.mha_reference(q, k, v, causal=causal, alibi_slopes=sl, return_lse=True)
    want = _jnp_backward(q, k, v, jout, jlse, dout, bias=None, segs=None, causal=causal,
                         scale=None, window=None, want_dbias=False, alibi_slopes=sl)[:3]
    tq, tk, tv = (T(x).requires_grad_(True) for x in (q, k, v))
    tsl = torch.from_numpy(sl).requires_grad_(True)
    out = flash_attention(tq, tk, tv, causal=causal, alibi_slopes=tsl)
    out.backward(T(dout))
    for g, w, n in zip((tq.grad, tk.grad, tv.grad), want, ("dq", "dk", "dv")):
        assert rel_err(g, w) < GRAD_TOL, n
    assert torch.equal(tsl.grad, torch.zeros(6))


# --- dbias ---------------------------------------------------------------------

BIAS_SHAPES = [(SQ, SK), (B, 1, SQ, SK), (1, 6, SQ, SK), (B, 6, SQ, SK), (SK,)]


@pytest.mark.parametrize("shape", BIAS_SHAPES, ids=["SS", "B1SS", "1HSS", "BHSS", "S"])
def test_dbias_matches_jax(shape):
    """flash_bwd(want_dbias=True) (K9's dS, reduced to the bias's shape)
    against _jnp_backward's dbias on the oracle's out and lse, causal with
    ALiBi beside the bias: dq, dk, dv and dbias to 2e-6 of the largest;
    the autograd flash_attention gives the mask the same gradient."""
    q, k, v, dout = inputs(4)
    sl = alibi_slopes(6)
    bias = bias_of(5, shape)
    jb = jnp.asarray(bias)
    jout, jlse = jref.mha_reference(q, k, v, causal=True, mask=jb, alibi_slopes=sl,
                                    return_lse=True)
    want = _jnp_backward(q, k, v, jout, jlse, dout, bias=jb, segs=None, causal=True,
                         scale=None, window=None, want_dbias=True, alibi_slopes=sl)
    got = fb.flash_bwd(T(q), T(k), T(v), T(jout), T(jlse), T(dout), bias=torch.from_numpy(bias),
                       causal=True, alibi_slopes=sl, want_dbias=True)
    assert got[3].shape == shape and got[3].dtype == torch.float32
    for g, w, n in zip(got, want, ("dq", "dk", "dv", "dbias")):
        assert rel_err(g, w) < GRAD_TOL, n
    tq, tk, tv = (T(x).requires_grad_(True) for x in (q, k, v))
    tb = torch.from_numpy(bias).requires_grad_(True)
    flash_attention(tq, tk, tv, causal=True, mask=tb, alibi_slopes=sl).backward(T(dout))
    assert rel_err(tb.grad, want[3]) < GRAD_TOL


def test_dbias_with_dropout_matches_jax():
    """dbias with dropout 0.25 (the replayed mask's dP) against JAX's
    flash_bwd in interpret mode on the same out and lse: to 2e-6 of the
    largest; a [B, 1, Sq, Sk] bias summed over the heads."""
    q, k, v, dout = inputs(6, h=4)
    bias = bias_of(7, (B, 1, SQ, SK))
    kw = dict(causal=True, dropout_rate=0.25, dropout_seed=11)
    jout, jlse = jff.flash_fwd(q, k, v, bias=jnp.asarray(bias), interpret=True, **kw)
    want = j_flash_bwd(q, k, v, jout, jlse, dout, bias=jnp.asarray(bias), want_dbias=True,
                       interpret=True, **kw)
    got = fb.flash_bwd(T(q), T(k), T(v), T(jout), T(jlse), T(dout), bias=torch.from_numpy(bias),
                       want_dbias=True, **kw)
    for g, w, n in zip(got, want, ("dq", "dk", "dv", "dbias")):
        assert rel_err(g, w) < GRAD_TOL, n


# --- varlen --------------------------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_varlen_return_softmax_and_mask_grad(causal, monkeypatch):
    """flash_attention_varlen(return_softmax=True) against JAX's in
    interpret mode (out, lse, probs [H, total_q, total_k]), and the
    gradient of a [total_q, total_k] mask through the [None, None] view
    against jax.grad of JAX's varlen call with its jnp backward
    (FATPU_JNP_BWD=1)."""
    monkeypatch.setenv("FATPU_JNP_BWD", "1")
    cu_q, cu_k = np.array([0, 5, 12, 20], np.int32), np.array([0, 9, 15, 30], np.int32)
    rng = np.random.default_rng(8)
    q = jnp.asarray(rng.standard_normal((20, 4, D)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((30, HK, D)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((30, HK, D)), jnp.float32)
    w = jnp.asarray(rng.standard_normal((20, 4, D)), jnp.float32)
    mask = bias_of(9, (20, 30))
    jcu = (jnp.asarray(cu_q), jnp.asarray(cu_k))
    jo, jl, jp = j_varlen(q, k, v, *jcu, causal=causal, mask=jnp.asarray(mask),
                          return_softmax=True, interpret=True)
    tcu = (torch.from_numpy(cu_q), torch.from_numpy(cu_k))
    to, tl, tp = flash_attention_varlen(T(q), T(k), T(v), *tcu, causal=causal,
                                        mask=torch.from_numpy(mask), return_softmax=True)
    assert tp.shape == (4, 20, 30)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=FWD_TOL)

    def jloss(m):
        return jnp.sum(j_varlen(q, k, v, *jcu, causal=causal, mask=m, interpret=True) * w)

    want = jax.grad(jloss)(jnp.asarray(mask))
    tm = torch.from_numpy(mask).requires_grad_(True)
    (flash_attention_varlen(T(q), T(k), T(v), *tcu, causal=causal, mask=tm) * T(w)).sum(
        ).backward()
    assert rel_err(tm.grad, want) < GRAD_TOL


# --- return_softmax, clamped_verify, auto -------------------------------------

@pytest.mark.parametrize("mode", ["online", "clamped"])
@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_return_softmax_matches_jax(mode, dropout):
    """flash_fwd(return_softmax=True) (K4's tiles and running maxima,
    renormalised outside) against JAX's kernel path in interpret mode, with
    a bias and ALiBi, causal, shifted: the post-dropout probabilities to
    1e-5, dead entries exactly 0; without dropout each live row sums to 1."""
    q, k, v, _ = inputs(10, h=4)
    sl = alibi_slopes(4)
    bias = bias_of(11, (SQ, SK))
    kw = dict(causal=True, dropout_rate=dropout, dropout_seed=3)
    cfg = jff.FlashConfig(softmax_mode=mode)
    jo, jl, jp = jff.flash_fwd(q, k, v, bias=jnp.asarray(bias), alibi_slopes=sl, config=cfg,
                               return_softmax=True, interpret=True, **kw)
    to, tl, tp = ff.flash_fwd(T(q), T(k), T(v), bias=torch.from_numpy(bias), alibi_slopes=sl,
                              config=FlashConfig(softmax_mode=mode), return_softmax=True, **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=FWD_TOL)
    dead = ~np.isfinite(np.broadcast_to(bias, tp.shape)) | (
        np.arange(SK)[None, :] > np.arange(SQ)[:, None] + SK - SQ)
    assert (tp.numpy()[dead] == 0).all()
    if dropout == 0.0:
        live = tl.numpy() > -1e29
        np.testing.assert_allclose(tp.sum(-1).numpy()[live], 1.0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_clamped_verify_in_range(causal):
    """softmax_mode="clamped_verify" on normal-scale scores: every row
    flagged exact, as JAX's flags (interpret), with a bias whose dead row
    counts exact; out as the oracle's."""
    q, k, v, _ = inputs(12, h=4)
    bias = bias_of(13, (SQ, SK))
    bias[5] = -np.inf
    _, _, jval = jff.flash_fwd(q, k, v, causal=causal, bias=jnp.asarray(bias), interpret=True,
                               config=jff.FlashConfig(softmax_mode="clamped_verify"))
    out, lse, val = ff.flash_fwd(T(q), T(k), T(v), causal=causal, bias=torch.from_numpy(bias),
                                 softmax_mode="clamped_verify")
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    assert (val.numpy() == 1.0).all()
    want = jref.mha_reference(q, k, v, causal=causal, mask=jnp.asarray(bias))
    assert rel_err(out, want) < FWD_TOL


def test_clamped_verify_flags_out_of_range():
    """Scores past the clamp (q, k x 100) flag their rows 0, exactly the
    rows JAX's kernel flags."""
    q, k, v, _ = inputs(14, h=4)
    q, k = q * 100.0, k * 100.0
    _, _, jval = jff.flash_fwd(q, k, v, interpret=True,
                               config=jff.FlashConfig(softmax_mode="clamped_verify"))
    _, _, val = ff.flash_fwd(T(q), T(k), T(v), softmax_mode="clamped_verify")
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    assert val.numpy().min() == 0.0


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("with_bias", [False, True])
def test_auto_mode_exact_both_regimes(big, with_bias):
    """softmax_mode="auto" equals the online call in both regimes (in
    range: the clamped call itself; past the clamp: the online rerun), as
    JAX's auto in interpret mode; with a bias the clamped_verify flags
    decide, without one clamped_lse_valid."""
    q, k, v, _ = inputs(15, h=4)
    if big:
        q, k = q * 100.0, k * 100.0
    bias = bias_of(16, (SQ, SK)) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    tb = None if bias is None else torch.from_numpy(bias)
    jo, jl = jff.flash_fwd(q, k, v, causal=True, bias=jb, interpret=True,
                           config=jff.FlashConfig(softmax_mode="auto"))
    args = (T(q), T(k), T(v))
    oa, la = ff.flash_fwd(*args, causal=True, bias=tb, softmax_mode="auto")
    oo, lo = ff.flash_fwd(*args, causal=True, bias=tb, softmax_mode="online")
    oc, lc = ff.flash_fwd(*args, causal=True, bias=tb, softmax_mode="clamped")
    np.testing.assert_allclose(oa.numpy(), np.asarray(jo), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(la.numpy(), np.asarray(jl), atol=1e-3, rtol=1e-3)
    taken = (oo, lo) if big else (oc, lc)
    assert torch.equal(oa, taken[0]) and torch.equal(la, taken[1])


def test_clamped_lse_valid_matches_jax():
    """clamped_lse_valid on the clamped lse: true in range (also with the
    dead leading rows of Sk < Sq causal), false once a row clamps, as
    JAX's on the same lse; a window's dead rows count exact."""
    q, k, v, _ = inputs(17, h=4)
    for qm, sk, window in ((1.0, SK, None), (100.0, SK, None), (1.0, 24, None),
                           (1.0, SK, (3, 0))):
        _, lse = ff.flash_fwd(T(q) * qm, T(k)[:, :sk] * qm, T(v)[:, :sk], causal=True,
                              window=window, softmax_mode="clamped")
        got = bool(ff.clamped_lse_valid(lse, SQ, sk, causal=True, window=window))
        want = bool(jff.clamped_lse_valid(jnp.asarray(lse.numpy()), SQ, sk, causal=True,
                                          window=window))
        assert got == want == (qm == 1.0)


# --- the oracle ----------------------------------------------------------------

def test_attention_bias_matches_jax():
    """attention_bias with causal, a window, segment ids and a mask."""
    rng = np.random.default_rng(18)
    qs = np.sort(rng.integers(1, 4, (B, SQ)), axis=1).astype(np.int32)
    ks = np.sort(rng.integers(1, 4, (B, SK)), axis=1).astype(np.int32)
    mask = bias_of(19, (SQ, SK))
    kw = dict(seqlen_q=SQ, seqlen_k=SK, causal=True, window=(9, 2))
    want = jref.attention_bias(mask=jnp.asarray(mask), q_segment_ids=jnp.asarray(qs),
                               kv_segment_ids=jnp.asarray(ks), **kw)
    got = ref.attention_bias(mask=torch.from_numpy(mask), q_segment_ids=torch.from_numpy(qs),
                             kv_segment_ids=torch.from_numpy(ks), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ref.attention_bias(seqlen_q=SQ, seqlen_k=SK) is None


def test_mha_reference_options_match_jax():
    """The ported oracle with a mask, segment ids, a window, the softcap
    and ALiBi, returning lse and the probabilities, against JAX's."""
    q, k, v, _ = inputs(20, h=4)
    rng = np.random.default_rng(21)
    qs = np.sort(rng.integers(1, 3, (B, SQ)), axis=1).astype(np.int32)
    ks = np.sort(rng.integers(1, 3, (B, SK)), axis=1).astype(np.int32)
    mask = bias_of(22, (B, 1, SQ, SK))
    kw = dict(causal=True, window=(20, -1), logit_softcap=5.0, alibi_slopes=alibi_slopes(4),
              return_lse=True, return_softmax=True)
    want = jref.mha_reference(q, k, v, mask=jnp.asarray(mask), q_segment_ids=jnp.asarray(qs),
                              kv_segment_ids=jnp.asarray(ks), **kw)
    got = ref.mha_reference(T(q), T(k), T(v), mask=torch.from_numpy(mask),
                            q_segment_ids=torch.from_numpy(qs),
                            kv_segment_ids=torch.from_numpy(ks), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FWD_TOL, rtol=FWD_TOL)


def test_mha_reference_vjp_matches_jax():
    """mha_reference_vjp (torch.autograd.grad) against JAX's (jax.grad),
    with a mask and segment ids, non-causal: to 2e-6 of the largest."""
    q, k, v, dout = inputs(23, h=4)
    rng = np.random.default_rng(24)
    qs = np.sort(rng.integers(1, 3, (B, SQ)), axis=1).astype(np.int32)
    ks = np.sort(rng.integers(1, 3, (B, SK)), axis=1).astype(np.int32)
    mask = bias_of(25, (SQ, SK))
    want = jref.mha_reference_vjp(q, k, v, dout, mask=jnp.asarray(mask),
                                  q_segment_ids=jnp.asarray(qs), kv_segment_ids=jnp.asarray(ks))
    got = ref.mha_reference_vjp(T(q), T(k), T(v), T(dout), mask=torch.from_numpy(mask),
                                q_segment_ids=torch.from_numpy(qs),
                                kv_segment_ids=torch.from_numpy(ks))
    for g, w in zip(got, want):
        assert rel_err(g, w) < GRAD_TOL


def test_mha_reference_dropout_recomposes_out():
    """The oracle's dropout (a torch.Generator: other bits than JAX's key):
    out is P_dropped @ V from its own return_softmax, each kept element
    scaled by 1 / (1 - rate), about a quarter dropped; the same generator
    seed gives the same mask."""
    q, k, v, _ = inputs(26, h=4)
    tq, tk, tv = T(q), T(k), T(v)
    runs = [ref.mha_reference(tq, tk, tv, causal=True, dropout_rate=0.25, return_lse=True,
                              return_softmax=True,
                              dropout_rng=torch.Generator().manual_seed(5)) for _ in range(2)]
    out, lse, p = runs[0]
    assert torch.equal(p, runs[1][2])
    vf = tv.repeat_interleave(2, dim=2)
    np.testing.assert_allclose(out.numpy(), torch.einsum("bhqk,bkhd->bqhd", p, vf).numpy(),
                               atol=FWD_TOL, rtol=FWD_TOL)
    _, _, p0 = ref.mha_reference(tq, tk, tv, causal=True, return_lse=True, return_softmax=True)
    kept = p != 0
    np.testing.assert_allclose(p[kept].numpy(), (p0[kept] / 0.75).numpy(), rtol=1e-6)
    live = p0 > 0
    share = float(1 - kept[live].float().mean())
    assert 0.2 < share < 0.3
    with pytest.raises(ValueError, match="dropout_rng"):
        ref.mha_reference(tq, tk, tv, dropout_rate=0.25)


# --- the ring's dbias ----------------------------------------------------------

@pytest.mark.parametrize("layout", ["contiguous", "striped"])
def test_ring_dbias_matches_jax(layout):
    """The ring over 4 CPU ranks (S_loc 16, causal) with a [1, H, S, S]
    bias that requires grad: dq, dk, dv and dbias against jax.grad of JAX's
    mha_reference, to 2e-6 of the largest; the striped ring on striped
    inputs and bias, its gradients unstriped."""
    n, S = 4, 64
    q, k, v, dout = inputs(27, h=4, sq=S, sk=S, b=1)
    bias = bias_of(28, (1, 4, S, S))
    bias.reshape(-1)[::7] = 0.0  # finite: every row keeps keys in every step

    def jloss(q_, k_, v_, b_):
        out = jref.mha_reference(q_, k_, v_, causal=True, mask=b_)
        return jnp.sum(out * dout)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(q, k, v, jnp.asarray(bias))
    mesh = host_local_mesh(n, axis="sp")
    tq, tk, tv, tdo = (T(x) for x in (q, k, v, dout))
    tb = torch.from_numpy(bias)
    if layout == "striped":
        tq, tk, tv, tdo = (stripe_sequence(x, n) for x in (tq, tk, tv, tdo))
        tb = stripe_sequence(stripe_sequence(tb, n, axis=2), n, axis=3)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv, tb)]
    make_ring_attention(mesh, causal=True, layout=layout, has_bias=True)(*leaves).backward(tdo)
    grads = [x.grad for x in leaves]
    if layout == "striped":
        perm = torch.from_numpy(np.arange(S).reshape(S // n, n).T.reshape(-1))
        inv = torch.argsort(perm)
        grads = [g[:, inv] for g in grads[:3]] + [grads[3][:, :, inv][..., inv]]
    for g, w, name in zip(grads, want, ("dq", "dk", "dv", "dbias")):
        assert rel_err(g, w) < GRAD_TOL, name


# --- what is still refused ------------------------------------------------------

def test_refusals():
    """ALiBi with a window or a softcap (forward and backward, any device),
    softmax_dtype="bf16", the kernels' head_dim 256 with ALiBi,
    return_softmax, clamped_verify or dS (raised before any build), a
    public clamped_verify, clamped_verify with return_softmax, want_dbias
    without a bias."""
    q = torch.zeros(1, 8, 2, 32)
    sl = np.ones(2, np.float32)
    for kw in (dict(window=(4, -1)), dict(logit_softcap=30.0)):
        with pytest.raises(NotImplementedError):
            ff.flash_fwd(q, q, q, alibi_slopes=sl, **kw)
        with pytest.raises(NotImplementedError):
            fb.flash_bwd(q, q, q, q, torch.zeros(1, 2, 8), q, alibi_slopes=sl, **kw)
    with pytest.raises(NotImplementedError, match="bf16"):
        ff.flash_fwd(q, q, q, config=FlashConfig(softmax_dtype="bf16"))
    with pytest.raises(ValueError, match="auto"):
        flash_attention(q, q, q, softmax_mode="clamped_verify")
    with pytest.raises(ValueError, match="return_softmax"):
        ff.flash_fwd(q, q, q, softmax_mode="clamped_verify", return_softmax=True)
    with pytest.raises(ValueError, match="requires a bias"):
        fb.flash_bwd(q, q, q, q, torch.zeros(1, 2, 8), q, want_dbias=True)
    q256 = torch.zeros(1, 8, 2, 256, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 8)
    for kw in (dict(alibi=torch.ones(2)), dict(probs=True), dict(verify=True)):
        with pytest.raises(NotImplementedError, match="head_dim 64 and 128"):
            ff.flash_fwd_cuda(q256, q256, q256, True, 1.0, None, None, True, **kw)
    for kw in (dict(alibi=torch.ones(2)), dict(want_ds=True)):
        with pytest.raises(NotImplementedError, match="head_dim 64 and 128"):
            fb.flash_bwd_dq_cuda(q256, q256, q256, q256, lse, lse, True, 1.0, None, None, **kw)

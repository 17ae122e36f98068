"""The FA2 options of K4, K9 and K10 against the JAX package on the CPU:
the dropout hash bit for bit, the additive bias (each broadcast shape, -inf
entries), dropout, segment ids and positions in the forward
(``flash_fwd``, K4's plain version) and the backward (``flash_bwd``, K9 +
K10's), fp16, the differentiable ``flash_attention`` /
``flash_attention_varlen`` with a mask and dropout, and packed-document
training (``llama.forward(segment_ids=...)``).

Inputs come from numpy seeds and reach both sides through numpy.  JAX runs
its Pallas kernels in interpret mode, or its jnp oracle
(``_jnp_backward``) where dropout is 0; the port runs its plain versions.
Tolerances: fp32 sides differ by summation order only (forward 1e-5 of
O(1) outputs; gradients 2e-6 of the largest, as tests/test_torch_train.py
holds them); fp16 and bf16 outputs by a rounding of the output or of an
element of P (1e-2 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models import llama as jllama
from flash_attn_tpu.ops.attention import _jnp_backward
from flash_attn_tpu.ops.attention import flash_attention as j_flash_attention
from flash_attn_tpu.ops.attention import flash_attention_varlen as j_varlen
from flash_attn_tpu.ops.flash_bwd import flash_bwd as j_flash_bwd
from flash_attn_tpu.ops.flash_fwd import dropout_keep_mask as j_keep_mask
from flash_attn_tpu.ops.flash_fwd import flash_fwd as j_flash_fwd
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.models import llama
from flash_attn_tpu_torch.ops import flash_bwd as fb
from flash_attn_tpu_torch.ops import flash_fwd as ff
from flash_attn_tpu_torch.ops.attention import flash_attention, flash_attention_varlen
from _torch_threads import one_torch_thread  # noqa: F401

B, SQ, SK, H, HK, D = 2, 40, 56, 4, 2, 32
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


def inputs(seed, dtype="float32", b=B, sq=SQ, sk=SK, h=H, hk=HK):
    """q, k, v, dout as JAX arrays."""
    rng = np.random.default_rng(seed)
    arr = lambda *s: jnp.asarray(rng.standard_normal(s), jnp.float32).astype(dtype)  # noqa: E731
    return arr(b, sq, h, D), arr(b, sk, hk, D), arr(b, sk, hk, D), arr(b, sq, h, D)


def packed_masks(seed, b=B, sq=SQ, sk=SK):
    """Sorted segment ids 1-3 and random positions on each side."""
    rng = np.random.default_rng(seed)
    qs = np.sort(rng.integers(1, 4, (b, sq)), axis=1).astype(np.int32)
    ks = np.sort(rng.integers(1, 4, (b, sk)), axis=1).astype(np.int32)
    qp = rng.integers(0, 60, (b, sq)).astype(np.int32)
    kp = rng.integers(0, 60, (b, sk)).astype(np.int32)
    return dict(q_segment_ids=qs, kv_segment_ids=ks, q_positions=qp, kv_positions=kp)


def bias_of(seed, shape, dead_row=None):
    """A random bias (scale 2), -inf on every 7th entry and, when asked,
    on a whole query row."""
    b = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 2
    b.reshape(-1)[::7] = -np.inf
    if dead_row is not None:
        b[..., dead_row, :] = -np.inf
    return b


# --- the dropout hash ---------------------------------------------------------

SEEDS = [0, -1, 2 ** 31 - 1, -2 ** 31, 1234567, -987654321]


@pytest.mark.parametrize("rate", [0.1, 0.5, 0.999])
@pytest.mark.parametrize("seed", SEEDS)
def test_dropout_keep_mask_bitwise(seed, rate):
    """The port's mask equals JAX's bit for bit at several batch and head
    indices and absolute row and column offsets (large ones included, where
    the int32 products wrap)."""
    for b, h, r0, c0 in ((0, 0, 0, 0), (1, 3, 128, 256), (7, 31, 8000, 77),
                         (65535, 5, 2 ** 20, 2 ** 20 + 3)):
        want = np.asarray(j_keep_mask(jnp.array([seed], jnp.int32), b, h, r0, c0, 16, 24, rate))
        got = ff.dropout_keep_mask(seed, b, h, r0, c0, 16, 24, rate).numpy()
        np.testing.assert_array_equal(got, want)


def test_seed_is_an_int32():
    """As jnp.asarray(seed, jnp.int32): int32 range only, a one-element
    tensor taken as its value."""
    assert ff.seed32(-2 ** 31) == -2 ** 31 and ff.seed32(torch.tensor([5])) == 5
    for bad in (2 ** 31, -2 ** 31 - 1, 2 ** 64 - 1):
        with pytest.raises(OverflowError):
            ff.seed32(bad)
        with pytest.raises(OverflowError):
            jnp.asarray(bad, jnp.int32)
    keep = ff.keep_mask(ff.Dropout(0.5, 9), 2, 3, 5, 6, "cpu", head0=2)
    assert torch.equal(keep[1, 2], ff.dropout_keep_mask(9, 1, 4, 0, 0, 5, 6, 0.5))


# --- K4's plain version --------------------------------------------------------

@pytest.mark.parametrize("shape", [(SQ, SK), (B, 1, SQ, SK), (1, H, SQ, SK), (B, H, SQ, SK),
                                   (SK,)], ids=["SS", "B1SS", "1HSS", "BHSS", "S"])
def test_fwd_bias_matches_jax(shape):
    """Each bias shape that broadcasts to [B, H, Sq, Sk], with -inf entries
    and (2-D and up) a whole dead row: out and lse as JAX's, the dead row
    out 0 and lse -1e30.  Causal, bottom-right (Sq < Sk), GQA 4/2."""
    q, k, v, _ = inputs(1)
    bias = bias_of(2, shape, dead_row=3 if len(shape) >= 2 else None)
    jo, jl = j_flash_fwd(q, k, v, bias=jnp.asarray(bias), causal=True, interpret=True)
    to, tl = ff.flash_fwd(T(q), T(k), T(v), bias=torch.from_numpy(bias), causal=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FWD_TOL, rtol=FWD_TOL)
    if len(shape) >= 2:
        assert (to[:, 3] == 0).all() and (tl[..., 3] == -1e30).all()


@pytest.mark.parametrize("causal", [False, True])
def test_fwd_dropout_matches_jax(causal):
    """Dropout 0.3 from seed -5: the kept P scaled by 1 / (1 - rate), the
    LSE the undropped one."""
    q, k, v, _ = inputs(3)
    kw = dict(causal=causal, dropout_rate=0.3, dropout_seed=-5)
    jo, jl = j_flash_fwd(q, k, v, interpret=True, **kw)
    to, tl = ff.flash_fwd(T(q), T(k), T(v), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=FWD_TOL, rtol=FWD_TOL)
    plain, _ = ff.flash_fwd(T(q), T(k), T(v), causal=causal)
    assert not torch.allclose(to, plain, atol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_fwd_all_options_match_jax(dtype):
    """A bias, segment ids, positions and dropout at once, causal; fp16
    computes as bf16 and comes back fp16 on both sides."""
    q, k, v, _ = inputs(4, dtype)
    masks = packed_masks(5)
    bias = bias_of(6, (B, 1, SQ, SK))
    kw = dict(causal=True, dropout_rate=0.25, dropout_seed=11)
    jo, jl = j_flash_fwd(q, k, v, bias=jnp.asarray(bias), interpret=True, **kw,
                         **{n: jnp.asarray(x) for n, x in masks.items()})
    to, tl = ff.flash_fwd(T(q), T(k), T(v), bias=torch.from_numpy(bias), **kw,
                          **{n: torch.from_numpy(x) for n, x in masks.items()})
    assert to.dtype == T(q).dtype
    tol = FWD_TOL if dtype == "float32" else HALF_TOL
    np.testing.assert_allclose(to.float().numpy(), np.asarray(jo, np.float32), atol=tol,
                               rtol=tol)
    live = np.asarray(jl) > -1e29
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live], atol=tol, rtol=tol)
    assert (tl.numpy()[~live] == -1e30).all()


# --- K9 + K10's plain version ------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_bwd_all_options_match_jax(dtype):
    """flash_bwd with segment ids, positions, a [1, H, Sq, Sk] bias (a dead
    row) and dropout 0.2 against JAX's flash_bwd on JAX's forward
    residuals; fp16 computes as bf16 and the gradients come back fp16."""
    q, k, v, dout = inputs(7, dtype)
    masks = packed_masks(8)
    bias = bias_of(9, (1, H, SQ, SK), dead_row=5)
    kw = dict(causal=True, dropout_rate=0.2, dropout_seed=2 ** 31 - 1)
    jm = {n: jnp.asarray(x) for n, x in masks.items()}
    tm = {n: torch.from_numpy(x) for n, x in masks.items()}
    out, lse = j_flash_fwd(q, k, v, bias=jnp.asarray(bias), interpret=True, **kw, **jm)
    want = j_flash_bwd(q, k, v, out, lse, dout, bias=jnp.asarray(bias), interpret=True, **kw,
                       **jm)
    got = fb.flash_bwd(T(q), T(k), T(v), T(out), T(lse), T(dout),
                       bias=torch.from_numpy(bias), **kw, **tm)
    tol = GRAD_TOL if dtype == "float32" else HALF_TOL
    for g, w, x, name in zip(got, want, (q, k, v), ("dq", "dk", "dv")):
        assert g.dtype == T(x).dtype, name
        assert rel_err(g, w) < tol, name


@pytest.mark.parametrize("causal", [False, True])
def test_bwd_bias_segments_match_jnp_oracle(causal):
    """Without dropout, against JAX's jnp oracle (``_jnp_backward``): a
    [B, 1, Sq, Sk] bias with segment ids and positions."""
    q, k, v, dout = inputs(10)
    masks = packed_masks(11)
    bias = bias_of(12, (B, 1, SQ, SK))
    jm = {n: jnp.asarray(x) for n, x in masks.items()}
    out, lse = j_flash_fwd(q, k, v, bias=jnp.asarray(bias), causal=causal, interpret=True,
                           **jm)
    segs = (jm["q_segment_ids"], jm["kv_segment_ids"], jm["q_positions"], jm["kv_positions"])
    want = _jnp_backward(q, k, v, out, lse, dout, bias=jnp.asarray(bias), segs=segs,
                         causal=causal, scale=None, window=None, want_dbias=False)[:3]
    got = fb.flash_bwd(T(q), T(k), T(v), T(out), T(lse), T(dout), bias=torch.from_numpy(bias),
                       causal=causal, **{n: torch.from_numpy(x) for n, x in masks.items()})
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert rel_err(g, w) < GRAD_TOL, name


def edge_bias(kind, seed, sq, sk):
    """(numpy bias for JAX, the same values as the torch view the port
    gets): "keys" a key-padding [B, 1, 1, Sk] (query stride 0 once
    broadcast), "rows" a contiguous [Sq, Sk] (rows not 16-byte aligned
    where Sk is odd), "transposed" the transpose of a [B, H, Sk, Sq] tensor
    (key stride Sq)."""
    if kind == "keys":
        b = bias_of(seed, (B, 1, 1, sk))
        return b, torch.from_numpy(b)
    if kind == "rows":
        b = bias_of(seed, (sq, sk), dead_row=3)
        return b, torch.from_numpy(b)
    t = torch.from_numpy(bias_of(seed, (B, H, sk, sq))).transpose(-1, -2)
    assert t.stride(-1) == sq
    return t.numpy().copy(), t


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["keys", "rows", "transposed"])
def test_bwd_bias_forms_match_jnp_oracle(kind, causal):
    """The bias forms K9's and K10's staging takes on the card (a
    key-padding bias, rows not 16-byte aligned at an odd Sk, a transposed
    view) through flash_bwd against JAX's jnp oracle (``_jnp_backward``) on
    JAX's forward residuals, Sq = 40 < Sk = 57."""
    sq, sk = SQ, 57
    q, k, v, dout = inputs(30, sk=sk)
    b_np, b_t = edge_bias(kind, 31, sq, sk)
    out, lse = j_flash_fwd(q, k, v, bias=jnp.asarray(b_np), causal=causal, interpret=True)
    want = _jnp_backward(q, k, v, out, lse, dout, bias=jnp.asarray(b_np), segs=None,
                         causal=causal, scale=None, window=None, want_dbias=False)[:3]
    got = fb.flash_bwd(T(q), T(k), T(v), T(out), T(lse), T(dout), bias=b_t, causal=causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert rel_err(g, w) < GRAD_TOL, name


# --- the differentiable entry points --------------------------------------------

def test_varlen_autograd_matches_jax():
    """flash_attention_varlen with a [total, total] mask and dropout,
    causal per sequence: grads of sum(out * w) against jax.grad of JAX's."""
    rng = np.random.default_rng(13)
    cu = np.array([0, 24, 40, 64], np.int32)
    q, k, v, w = (jnp.asarray(rng.standard_normal((64, h, D)), jnp.float32)
                  for h in (H, HK, HK, H))
    mask = bias_of(14, (64, 64))
    kw = dict(causal=True, dropout_rate=0.15, dropout_seed=21)

    def jloss(q_, k_, v_):
        out = j_varlen(q_, k_, v_, jnp.asarray(cu), jnp.asarray(cu), mask=jnp.asarray(mask),
                       interpret=True, **kw)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (T(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention_varlen(tq, tk, tv, torch.from_numpy(cu), torch.from_numpy(cu),
                                 mask=torch.from_numpy(mask), **kw)
    (out * T(w)).sum().backward()
    for g, wg, name in zip((tq.grad, tk.grad, tv.grad), want, ("dq", "dk", "dv")):
        assert rel_err(g, wg) < GRAD_TOL, name


def test_dense_autograd_with_options_matches_jax():
    """flash_attention with a mask, dropout and segment ids, differentiable
    w.r.t. q, k, v and the mask (dbias: K9's dS summed over the heads and
    the batch), against jax.grad."""
    q, k, v, w = inputs(15)
    masks = packed_masks(16)
    seg = dict(q_segment_ids=masks["q_segment_ids"], kv_segment_ids=masks["kv_segment_ids"])
    mask = bias_of(17, (SQ, SK))
    kw = dict(causal=True, dropout_rate=0.1, dropout_seed=4)

    def jloss(q_, k_, v_, m_):
        out = j_flash_attention(q_, k_, v_, mask=m_, interpret=True, **kw,
                                **{n: jnp.asarray(x) for n, x in seg.items()})
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(q, k, v, jnp.asarray(mask))
    tq, tk, tv = (T(x).requires_grad_(True) for x in (q, k, v))
    tm = torch.from_numpy(mask).requires_grad_(True)
    tseg = {n: torch.from_numpy(x) for n, x in seg.items()}
    out = flash_attention(tq, tk, tv, mask=tm, **kw, **tseg)
    (out * T(w)).sum().backward()
    for g, wg, name in zip((tq.grad, tk.grad, tv.grad, tm.grad), want,
                           ("dq", "dk", "dv", "dmask")):
        assert rel_err(g, wg) < GRAD_TOL, name


# --- packed-document training ---------------------------------------------------

def test_llama_forward_segment_ids_matches_jax():
    """Packed documents (11, 9 and 4 tokens a row, positions restarting a
    document) at LLAMA_TINY, fp32: the logits and every leaf's gradient of
    the mean logit product against JAX's forward(segment_ids=...)."""
    cfg, jcfg = llama.LLAMA_TINY, jllama.LLAMA_TINY
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(3))
    tp = bridge.params_from_jax(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(18)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    seg = np.repeat(np.array([1, 2, 3], np.int32), [11, 9, 4])[None].repeat(2, 0)
    pos = np.concatenate([np.arange(n) for n in (11, 9, 4)]).astype(np.int32)[None].repeat(2, 0)
    w = rng.standard_normal((2, 24, cfg.vocab_size)).astype(np.float32)

    def jloss(p):
        logits = jllama.forward(p, jnp.asarray(toks), jcfg, positions=jnp.asarray(pos),
                                segment_ids=jnp.asarray(seg), interpret=True)
        return jnp.mean(logits * w), logits

    # jitted: interpret mode traces each kernel once (~3x faster than eager)
    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    from flash_attn_tpu_torch.utils import train

    leaves = train.param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    logits = llama.forward(tp, torch.from_numpy(toks).long(), cfg,
                           positions=torch.from_numpy(pos).long(),
                           segment_ids=torch.from_numpy(seg), remat=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-4)
    grads = torch.autograd.grad((logits * torch.from_numpy(w)).mean(), leaves)
    for g, wg in zip(grads, jax.tree.leaves(jgrads)):
        assert rel_err(g, wg) < 1e-4
    # the documents do not see each other: a document's logits are its own
    alone = llama.forward(tp, torch.from_numpy(toks[:, 11:20]).long(), cfg,
                          remat=False).detach()
    np.testing.assert_allclose(logits.detach()[:, 11:20].numpy(), alone.numpy(), atol=1e-4)

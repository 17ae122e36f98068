"""Gemma-2 training in the port against the JAX package, on the CPU: the
attention backward (``flash_bwd``, whose CPU path is the plain version of
K9 + K10) with a sliding window and the logit softcap, the differentiable
``flash_attention`` with both, ``gemma2.forward``'s gradients (the tied
embedding takes both of its uses') and three ``make_train_step`` steps at
GEMMA2_TINY with a sequence past its window, in fp32 and bf16, remat on
and off.

Inputs come from numpy seeds and reach both sides through numpy.  JAX
runs its Pallas kernels in interpret mode (and, for the backward, also its
plain ``_jnp_backward``); the port runs the plain versions of its kernels.
Tolerances are those of tests/test_torch_train.py, with their reasons
there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models import gemma2 as jgemma2
from flash_attn_tpu.ops.attention import _jnp_backward
from flash_attn_tpu.ops.attention import flash_attention as j_flash_attention
from flash_attn_tpu.ops.flash_bwd import flash_bwd as j_flash_bwd
from flash_attn_tpu.ops.flash_fwd import flash_fwd as j_flash_fwd
from flash_attn_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from flash_attn_tpu.utils import train as jtrain
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.models import gemma2
from flash_attn_tpu_torch.ops import flash_bwd as fb
from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.utils import train
from _torch_threads import one_torch_thread  # noqa: F401

CFG = gemma2.GEMMA2_TINY
# GQA 4/2 and Sq < Sk, so the causal mask and the window are shifted
# (bottom-right)
B, SQ, SK, H, HK = 1, 40, 56, 4, 2
# as tests/test_torch_train.py: fp32 summation order; bf16 one flipped
# rounding of an element of P or dS
BWD_TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -7}


def T(x):
    """A JAX or numpy array -> a CPU tensor (bf16 kept)."""
    return bridge.to_torch(jax.device_get(x), device="cpu")


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    g = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


def attn_inputs(seed, dtype, D, scores=1.0):
    """q, k, v, dout and rope tables; ``scores`` scales q so that the
    softcap bends the scores (tanh far from linear)."""
    rng = np.random.default_rng(seed)
    arr = lambda *s: jnp.asarray(rng.standard_normal(s), jnp.float32)  # noqa: E731
    q = (arr(B, SQ, H, D) * scores).astype(dtype)
    k, v, dout = (x.astype(dtype) for x in (arr(B, SK, HK, D), arr(B, SK, HK, D),
                                            arr(B, SQ, H, D)))
    cos, sin = j_rope_cos_sin(jnp.arange(SQ)[None] + (SK - SQ), D, 10000.0)
    return q, k, v, dout, cos, sin


# (D, window, causal, cap): Gemma's window (left only, causal) and the
# two-sided forms (non-causal), each with the cap and without, at a small
# head dim and at Gemma-2-9B's 256; the cap of 2 on scores of ~3 bends
# tanh far from linear, so a missed 1 - t^2 factor cannot hide
BWD_CASES = [pytest.param("float32", d, w, c, cap, id=f"D{d}-w{w[0]}.{w[1]}-c{int(c)}-cap{cap}")
             for d in (32, 256) for w, c in (((7, -1), True), ((7, 0), False), ((3, 3), False))
             for cap in (50.0, None)]
BWD_CASES += [pytest.param("float32", 32, (7, -1), True, 2.0, id="D32-w7.-1-c1-cap2"),
              pytest.param("bfloat16", 256, (7, -1), True, 50.0, id="bf16-D256-w7.-1-c1-cap50")]


@pytest.mark.parametrize("dtype,D,window,causal,cap", BWD_CASES)
def test_flash_bwd_window_softcap_matches_jax(dtype, D, window, causal, cap):
    """flash_bwd with a window and the softcap against JAX's flash_bwd in
    interpret mode (q rotated inside the kernels) and, without rope,
    against JAX's plain ``_jnp_backward``."""
    q, k, v, dout, cos, sin = attn_inputs(D + 7, dtype, D, 3.0 if cap == 2.0 else 1.0)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    out, lse = j_flash_fwd(q, k, v, rope_cos=cos, rope_sin=sin, interpret=True, **kw)
    want = j_flash_bwd(q, k, v, out, lse, dout, rope_cos=cos, rope_sin=sin, interpret=True, **kw)
    got = fb.flash_bwd(T(q), T(k), T(v), T(out), T(lse), T(dout), rope_cos=T(cos),
                       rope_sin=T(sin), **kw)
    for g, w, x, name in zip(got, want, (q, k, v), ("dq", "dk", "dv")):
        assert g.shape == x.shape and g.dtype == T(x).dtype, name
        assert rel_err(g, w) < BWD_TOL[dtype], name
    if dtype != "float32":
        return
    out, lse = j_flash_fwd(q, k, v, interpret=True, **kw)
    want = _jnp_backward(q, k, v, out, lse, dout, bias=None, segs=None, scale=None,
                         want_dbias=False, **kw)[:3]
    got = fb.flash_bwd(T(q), T(k), T(v), T(out), T(lse), T(dout), **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert rel_err(g, w) < BWD_TOL[dtype], name


def test_flash_attention_window_softcap_grads_match_jax():
    """autograd through the port's flash_attention with Gemma's options
    (causal, a window, the softcap, an explicit scale, q rotated in the
    kernels) against jax.grad through the JAX one, fp32; then the same
    call under no_grad gives the same out."""
    q, k, v, w, cos, sin = attn_inputs(3, "float32", 32, 3.0)
    kw = dict(causal=True, window=(9, -1), logit_softcap=2.0, scale=0.25)

    def jloss(q_, k_, v_):
        out = j_flash_attention(q_, k_, v_, rope_cos=cos, rope_sin=sin, interpret=True, **kw)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (T(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, rope_cos=T(cos), rope_sin=T(sin), **kw)
    (out * T(w)).sum().backward()
    for g, wg, name in zip((tq.grad, tk.grad, tv.grad), want, ("dq", "dk", "dv")):
        assert rel_err(g, wg) < BWD_TOL["float32"], name
    with torch.no_grad():
        again = flash_attention(tq, tk, tv, rope_cos=T(cos), rope_sin=T(sin), **kw)
    assert torch.equal(again, out.detach())


def _params(dtype="float32", seed=0):
    jcfg = dataclasses.replace(jgemma2.GEMMA2_TINY, dtype=dtype)
    jp = jgemma2.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, bridge.params_from_jax(jax.device_get(jp), device="cpu")


def tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, shape).astype(np.int32)


def test_forward_grads_match_jax():
    """gemma2.forward's gradient of a weighted sum of its logits w.r.t.
    every param (the tied embedding's through both uses) against jax.grad
    of JAX's forward, fp32, S=48 past the window of 16: each leaf to 1e-4
    of its largest value (fp32 summation order through two layers and the
    capped head); the logits as tests/test_torch_gemma2.py holds them.
    Serving's path (the cached head, the cap in place) gives the same
    logits, and the forward under no_grad caches no head."""
    jcfg, jp, tp = _params()
    toks = tokens(4, (2, 48))
    w = np.random.default_rng(5).standard_normal((2, 48, CFG.vocab_size)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jgemma2.forward(p, jnp.asarray(toks), jcfg, interpret=True) * w)

    want = jax.tree.leaves(jax.jit(jax.grad(jloss))(jp))
    leaves = train.param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    logits = gemma2.forward(tp, torch.from_numpy(toks).long(), CFG, remat=True)
    (logits * torch.from_numpy(w)).sum().backward()
    names = [name for name, _ in train.named_leaves(tp)]
    assert len(leaves) == len(want)
    for name, p, wg in zip(names, leaves, want):
        assert p.grad is not None and rel_err(p.grad, wg) < 1e-4, name
    with torch.no_grad():
        again = gemma2.forward(tp, torch.from_numpy(toks).long(), CFG)
    assert "_lm_head_f32" not in tp and torch.equal(again, logits.detach())
    pos = torch.arange(48)[None].expand(2, 48)
    served, _ = gemma2.prefill_with_kv(tp, torch.from_numpy(toks).long(), pos, CFG)
    np.testing.assert_allclose(served.numpy(), logits.detach().numpy(), atol=1e-5)
    jl = jax.jit(lambda p: jgemma2.forward(p, jnp.asarray(toks), jcfg, interpret=True))(jp)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), atol=5e-3)


def _hold_leaf_norms(jcfg, jparams, cfg, tp, tok, tgt, remat):
    """Each leaf's gradient norm and the global norm, in fp32, against
    JAX's on the same params and batch (the tolerances in
    test_train_step_matches_jax)."""
    def jloss(p):
        return jtrain.cross_entropy(jgemma2.forward(p, jnp.asarray(tok), jcfg, interpret=True),
                                    jnp.asarray(tgt))

    want = [np.asarray(w, np.float32) for w in jax.tree.leaves(jax.jit(jax.grad(jloss))(jparams))]
    for p in train.param_leaves(tp):
        p.requires_grad_(True)
    _, got = train.loss_and_grads(lambda p, t, remat: gemma2.forward(p, t, cfg, remat=remat), tp,
                                  torch.from_numpy(tok).long(), torch.from_numpy(tgt).long(),
                                  remat=remat)
    got = [g.float().numpy() for g in got]
    names = [name for name, _ in train.named_leaves(tp)]
    norm = lambda xs: float(np.sqrt(sum(np.square(x, dtype=np.float64).sum() for x in xs)))  # noqa
    assert len(got) == len(want)
    np.testing.assert_allclose(norm(got), norm(want), rtol=1e-3)
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(norm([g]), norm([w]), rtol=2.0 ** -8, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [True, False])
def test_train_step_matches_jax(dtype, remat):
    """Three steps of make_train_step at GEMMA2_TINY on the same params
    and batch (S=48, past the window of 16), remat on and off on both
    sides, against JAX's make_train_step.  Tolerances as
    tests/test_torch_train.py states them: fp32 loss to 1e-5 relative,
    grad_norm to 1e-4, params to a tenth of lr (mean 1e-6); bf16 loss to
    2e-4, params to 2 lr a step (mean 1e-5).  A bf16 grad_norm is a bf16
    number: each leaf's gradient agrees with JAX's to bf16 rounding (1.2 %
    of its largest value at most, measured), which moves a leaf's sum of
    squares by ~0.1 % and can flip the norm's own bf16 rounding, so the
    step's norm is held to one bf16 ulp (2^-7 relative) where Llama's
    happened to match exactly.  So that no error hides in that rounding,
    the first step's gradients are also held leaf by leaf in fp32: the
    global norm to 1e-3 (measured 8.5e-6) and each leaf's norm to 2^-8,
    the sum of the two sides' bf16 rounding of its elements (measured
    1.3e-3, on a 64-element norm gain)."""
    jcfg, jparams, tp = _params(dtype, seed=1)
    cfg = dataclasses.replace(CFG, dtype=dtype)
    batch = tokens(6, (2, 49))
    tok, tgt = batch[:, :-1], batch[:, 1:]
    jinit, jstep = jtrain.make_train_step(
        lambda p, t: jgemma2.forward(p, t, jcfg, interpret=True),
        jtrain.TrainConfig(remat=remat))
    jstep = jax.jit(jstep)
    jstate = jinit(jparams)
    init_fn, step_fn = train.make_train_step(
        lambda p, t, remat: gemma2.forward(p, t, cfg, remat=remat),
        train.TrainConfig(remat=remat))
    state = init_fn(tp)
    fp32 = dtype == "float32"
    if not fp32:
        _hold_leaf_norms(jcfg, jparams, cfg, tp, tok, tgt, remat)
    for _ in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(tok), jnp.asarray(tgt))
        tp, state, m = step_fn(tp, state, torch.from_numpy(tok).long(),
                               torch.from_numpy(tgt).long())
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if fp32 else 2e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4 if fp32 else 2.0 ** -7)
    lr = train.TrainConfig().learning_rate
    diffs = [np.abs(g.detach().float().numpy() - np.asarray(w, np.float32))
             for g, w in zip(train.param_leaves(tp), jax.tree.leaves(jparams))]
    assert all(str(g.dtype) == f"torch.{dtype}" for g in train.param_leaves(tp))
    assert max(float(d.max()) for d in diffs) <= (0.1 * lr if fp32 else 3 * 2 * lr)
    assert sum(float(d.sum()) for d in diffs) / sum(d.size for d in diffs) < (
        1e-6 if fp32 else 1e-5)

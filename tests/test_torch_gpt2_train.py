"""GPT-2 training in the port against the JAX package, on the CPU: the
attention backward (``flash_bwd``, whose CPU path is the plain version of
K9 + K10, the oracle K9 and K10 are held to on the card) at head_dim 64,
the differentiable ``flash_attention`` at 64, ``gpt2.forward``'s logits
and gradients (the tied ``wte`` takes both of its uses'), three
``make_train_step`` steps at GPT2_TINY in fp32 and bf16 with remat on
and off, and serve, train, serve on one params dict.

Inputs come from numpy seeds (or JAX's init) and reach both sides through
``bridge``.  JAX runs its Pallas kernels in interpret mode; the port runs
the plain versions of its kernels.  Tolerances are those of
tests/test_torch_train.py, with their reasons there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models import gpt2 as jgpt2
from flash_attn_tpu.ops.attention import flash_attention as j_flash_attention
from flash_attn_tpu.ops.flash_bwd import flash_bwd as j_flash_bwd
from flash_attn_tpu.ops.flash_fwd import flash_fwd as j_flash_fwd
from flash_attn_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from flash_attn_tpu.utils import train as jtrain
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.models import gpt2
from flash_attn_tpu_torch.ops import flash_bwd as fb
from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.utils import train

D = 64
# Sq < Sk, so the causal mask is shifted (bottom-right)
SQ, SK = 40, 56
# fp32: summation order; bf16: one flipped rounding of an element of P or
# dS (tests/test_torch_train.py)
BWD_TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -7}
# two layers of two heads of 64: GPT-2 124M's head_dim at a tiny size
TINY64 = dict(vocab_size=1024, max_position=128, num_layers=2, num_heads=2, hidden=128)


def T(x):
    """A JAX or numpy array -> a CPU tensor (bf16 kept)."""
    return bridge.to_torch(jax.device_get(x), device="cpu")


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    g = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


def attn_inputs(seed, dtype, b, h, hk, rope):
    """q, k, v, dout, and rope tables (each sequence its own positions) or
    None."""
    rng = np.random.default_rng(seed)
    arr = lambda *s: jnp.asarray(rng.standard_normal(s), jnp.float32).astype(dtype)  # noqa
    q, k, v, dout = arr(b, SQ, h, D), arr(b, SK, hk, D), arr(b, SK, hk, D), arr(b, SQ, h, D)
    cos = sin = None
    if rope:
        cos, sin = j_rope_cos_sin(jnp.arange(SQ)[None] + 7 * jnp.arange(b)[:, None], D, 10000.0)
    return q, k, v, dout, cos, sin


# (dtype, causal, batch, heads, kv heads, rope): GPT-2's own form (H = Hk,
# causal, no rope) in both dtypes, GQA 4/2 with rope causal and not, and
# B=2 with per-sequence rope tables, so that K9's rope pull-back at 64 (a
# column's partner 32 columns away) has an oracle
BWD_CASES = [pytest.param(dt, True, 1, 4, 4, False, id=f"{dt}-gpt2")
             for dt in ("float32", "bfloat16")]
BWD_CASES += [pytest.param("float32", c, 1, 4, 2, True, id=f"float32-{c}-gqa-rope")
              for c in (True, False)]
BWD_CASES += [pytest.param("bfloat16", True, 2, 4, 2, True, id="bfloat16-True-B2-rope")]


@pytest.mark.parametrize("dtype,causal,b,h,hk,rope", BWD_CASES)
def test_flash_bwd_d64_matches_jax(dtype, causal, b, h, hk, rope):
    """flash_bwd at head_dim 64 against JAX's flash_bwd in interpret mode
    (q rotated inside the kernels where rope is given)."""
    q, k, v, dout, cos, sin = attn_inputs(D + b + h + hk, dtype, b, h, hk, rope)
    kw = dict(causal=causal, rope_cos=cos, rope_sin=sin)
    out, lse = j_flash_fwd(q, k, v, interpret=True, **kw)
    want = j_flash_bwd(q, k, v, out, lse, dout, interpret=True, **kw)
    tkw = dict(causal=causal, rope_cos=None if cos is None else T(cos),
               rope_sin=None if sin is None else T(sin))
    got = fb.flash_bwd(T(q), T(k), T(v), T(out), T(lse), T(dout), **tkw)
    for g, w, x, name in zip(got, want, (q, k, v), ("dq", "dk", "dv")):
        assert g.shape == x.shape and g.dtype == T(x).dtype, name
        assert rel_err(g, w) < BWD_TOL[dtype], name


def test_flash_attention_d64_grads_match_jax():
    """autograd through the port's flash_attention at head_dim 64 (K4's
    plain forward, K9 + K10's plain backward) against jax.grad through the
    JAX one, fp32, causal, GQA, q rotated inside the kernels."""
    q, k, v, w, cos, sin = attn_inputs(3, "float32", 1, 4, 2, True)

    def jloss(q_, k_, v_):
        out = j_flash_attention(q_, k_, v_, causal=True, rope_cos=cos, rope_sin=sin,
                                interpret=True)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (T(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, causal=True, rope_cos=T(cos), rope_sin=T(sin))
    (out * T(w)).sum().backward()
    for g, wg, name in zip((tq.grad, tk.grad, tv.grad), want, ("dq", "dk", "dv")):
        assert rel_err(g, wg) < BWD_TOL["float32"], name


def _params(cfg_kw, dtype="float32", seed=0):
    """(JAX config, JAX params, port config, port params) from one JAX key."""
    jcfg = jgpt2.GPT2Config(**cfg_kw, dtype=dtype)
    jp = jgpt2.init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = gpt2.GPT2Config(**cfg_kw, dtype=dtype)
    return jcfg, jp, cfg, bridge.params_from_jax(jax.device_get(jp), device="cpu")


_TINY = {f.name: getattr(gpt2.GPT2_TINY, f.name) for f in dataclasses.fields(gpt2.GPT2_TINY)
         if f.name not in ("dtype", "softmax_mode")}


def tokens(seed, shape, vocab=1024):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("cfg_kw,remat", [(_TINY, True), (TINY64, False)],
                         ids=["GPT2_TINY-d32-remat", "d64"])
def test_forward_grads_match_jax(cfg_kw, remat):
    """gpt2.forward's gradient of a weighted sum of its logits w.r.t.
    every param (the tied wte's through the gather and the head) against
    jax.grad of JAX's forward, fp32, at GPT2_TINY (head_dim 32) and at
    head_dim 64: each leaf to 1e-4 of its largest value (fp32 summation
    order through two layers and the head), the logits to 1e-5.  The
    forward caches no head, with a gradient or without, and the serving
    path's cached head gives the same logits."""
    jcfg, jp, cfg, tp = _params(cfg_kw)
    toks = tokens(4, (2, 40))
    w = np.random.default_rng(5).standard_normal((2, 40, cfg.vocab_size)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jgpt2.forward(p, jnp.asarray(toks), jcfg, interpret=True) * w)

    want = jax.tree.leaves(jax.jit(jax.grad(jloss))(jp))
    leaves = train.param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    logits = gpt2.forward(tp, torch.from_numpy(toks).long(), cfg, remat=remat)
    (logits * torch.from_numpy(w)).sum().backward()
    names = [name for name, _ in train.named_leaves(tp)]
    assert len(leaves) == len(want)
    for name, p, wg in zip(names, leaves, want):
        assert p.grad is not None and rel_err(p.grad, wg) < 1e-4, name
    jl = jax.jit(lambda p: jgpt2.forward(p, jnp.asarray(toks), jcfg, interpret=True))(jp)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), atol=1e-5)
    with torch.no_grad():
        again = gpt2.forward(tp, torch.from_numpy(toks).long(), cfg)
    assert "_lm_head_f32" not in tp and torch.equal(again, logits.detach())
    pos = torch.arange(40)[None].expand(2, 40)
    served, _ = gpt2.prefill_with_kv(tp, torch.from_numpy(toks).long(), pos, cfg)
    np.testing.assert_allclose(served.numpy(), logits.detach().numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [True, False])
def test_train_step_matches_jax(dtype, remat):
    """Three steps of make_train_step at GPT2_TINY on the same params and
    batch (B=2, S=32), remat on and off on both sides, against JAX's
    make_train_step.  Tolerances as tests/test_torch_train.py states them:
    fp32 loss to 1e-5 relative, grad_norm to 1e-4, params to a tenth of lr
    (mean 1e-6); bf16 loss to 2e-4, grad_norm to 1e-3, params to 2 lr a
    step (mean 1e-5)."""
    jcfg, jparams, cfg, tp = _params(_TINY, dtype, seed=1)
    batch = tokens(6, (2, 33))
    tok, tgt = batch[:, :-1], batch[:, 1:]
    jinit, jstep = jtrain.make_train_step(
        lambda p, t: jgpt2.forward(p, t, jcfg, interpret=True), jtrain.TrainConfig(remat=remat))
    jstep = jax.jit(jstep)
    jstate = jinit(jparams)
    init_fn, step_fn = train.make_train_step(
        lambda p, t, remat: gpt2.forward(p, t, cfg, remat=remat), train.TrainConfig(remat=remat))
    state = init_fn(tp)
    fp32 = dtype == "float32"
    for _ in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(tok), jnp.asarray(tgt))
        tp, state, m = step_fn(tp, state, torch.from_numpy(tok).long(),
                               torch.from_numpy(tgt).long())
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-5 if fp32 else 2e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=1e-4 if fp32 else 1e-3)
    lr = train.TrainConfig().learning_rate
    diffs = [np.abs(g.detach().float().numpy() - np.asarray(w, np.float32))
             for g, w in zip(train.param_leaves(tp), jax.tree.leaves(jparams))]
    assert all(str(g.dtype) == f"torch.{dtype}" for g in train.param_leaves(tp))
    assert max(float(d.max()) for d in diffs) <= (0.1 * lr if fp32 else 3 * 2 * lr)
    assert sum(float(d.sum()) for d in diffs) / sum(d.size for d in diffs) < (
        1e-6 if fp32 else 1e-5)


# Serve, train, serve: logits of the trained params against JAX's, as
# tests/test_torch_train.py holds Llama's (fp32: summation order; bf16:
# the decode step's bf16 activations rounded at other points than XLA's)
SERVED_TOL = {"float32": 1e-4, "bfloat16": 8e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_train_serve_reads_the_trained_head(dtype):
    """One decode step, one make_train_step step, one decode step on the
    same params dict at GPT2_TINY: the second step scores with the trained
    wte, equal to JAX's decode step on JAX's trained params and bit for
    bit to a fresh copy of the params (the serving head's fp32 copy
    follows wte's version counter; AdamW changes wte in place)."""
    jcfg, jp, cfg, tp = _params(_TINY, dtype)
    tok0 = tokens(9, (2,))
    batch = tokens(10, (2, 17))
    tok, tgt = batch[:, :-1], batch[:, 1:]
    gpt2.decode_step(tp, torch.from_numpy(tok0).long(), cfg,
                     gpt2.make_cache(cfg, 2, 16, device="cpu"))
    assert "_lm_head_f32" in tp
    jinit, jstep = jtrain.make_train_step(
        lambda p, t: jgpt2.forward(p, t, jcfg, interpret=True), jtrain.TrainConfig())
    jp, _, _ = jax.jit(jstep)(jp, jinit(jp), jnp.asarray(tok), jnp.asarray(tgt))
    init_fn, step_fn = train.make_train_step(
        lambda p, t, remat: gpt2.forward(p, t, cfg, remat=remat), train.TrainConfig())
    tp, _, _ = step_fn(tp, init_fn(tp), torch.from_numpy(tok).long(),
                       torch.from_numpy(tgt).long())
    with torch.no_grad():
        got, _ = gpt2.decode_step(tp, torch.from_numpy(tok0).long(), cfg,
                                  gpt2.make_cache(cfg, 2, 16, device="cpu"))
        fresh = {k: v for k, v in tp.items() if not k.startswith("_")}
        again, _ = gpt2.decode_step(fresh, torch.from_numpy(tok0).long(), cfg,
                                    gpt2.make_cache(cfg, 2, 16, device="cpu"))
    want, _ = jax.jit(lambda p, c: jgpt2.decode_step(p, jnp.asarray(tok0), jcfg, c,
                                                     interpret=True))(
        jp, jgpt2.make_cache(jcfg, 2, 16))
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=SERVED_TOL[dtype])


def test_flash_bwd_d64_wrappers_refuse():
    """K9 and K10 at head_dim 64 refuse a window and a softcap (which only
    the 128 and 256 instances take; raised before any build) and CPU
    tensors."""
    bf = [torch.zeros(s, dtype=torch.bfloat16) for s in
          ((1, 8, 2, D), (1, 8, 1, D), (1, 8, 1, D), (1, 8, 2, D))]
    stats = torch.zeros((1, 2, 8))
    with pytest.raises(NotImplementedError, match="head_dim 128 and 256"):
        fb.flash_bwd_dq_cuda(*bf, stats, stats, True, 1.0, None, None, (4, -1), None)
    with pytest.raises(NotImplementedError, match="head_dim 128 and 256"):
        fb.flash_bwd_dkv_cuda(*bf, stats, stats, True, 1.0, None, 50.0)
    with pytest.raises(ValueError, match="CUDA"):
        fb.flash_bwd_dq_cuda(*bf, stats, stats, True, 1.0, None, None)
    with pytest.raises(ValueError, match="CUDA"):
        fb.flash_bwd_dkv_cuda(*bf, stats, stats, False, 1.0)
    assert fb.flash_bwd_dq_cuda.d64_launches == 0 and fb.flash_bwd_dkv_cuda.d64_launches == 0

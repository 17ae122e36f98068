"""The port's training path against the JAX package on the CPU: the
attention backward (``flash_bwd``, whose CPU path is the plain version of
K9 + K10), the differentiable ``flash_attention``, the Llama training
``forward``, the train step (clipping, AdamW, accumulation, remat),
``chunked_cross_entropy`` and ``train_tiny_lm``.

Inputs come from numpy seeds and reach both sides through numpy.  JAX
runs its Pallas kernels in interpret mode, as tests/test_flash_bwd.py
does; the port runs its plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models import llama as jllama
from flash_attn_tpu.ops.attention import flash_attention as j_flash_attention
from flash_attn_tpu.ops.flash_bwd import flash_bwd as j_flash_bwd
from flash_attn_tpu.ops.flash_fwd import flash_fwd as j_flash_fwd
from flash_attn_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from flash_attn_tpu.utils import train as jtrain
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.models import llama
from flash_attn_tpu_torch.ops import flash_bwd as fb
from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.utils import train
from _torch_threads import one_torch_thread  # noqa: F401

CFG = llama.LLAMA_TINY
# GQA with Sq != Sk, so the causal mask is shifted (bottom-right)
B, SQ, SK, H, HK, D = 1, 100, 150, 4, 2, 32


def T(x):
    """A JAX or numpy array -> a CPU tensor (bf16 kept)."""
    return bridge.to_torch(jax.device_get(x), device="cpu")


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    g = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


def attn_inputs(seed, dtype, b=B, h=H, hk=HK):
    """q, k, v, dout and rope tables; with b > 1 each sequence has its own
    positions (sequence i starts at 7 i), so the tables are [b, SQ, D/2]."""
    rng = np.random.default_rng(seed)
    arr = lambda *s: jnp.asarray(rng.standard_normal(s), jnp.float32).astype(dtype)
    q, k, v, dout = arr(b, SQ, h, D), arr(b, SK, hk, D), arr(b, SK, hk, D), arr(b, SQ, h, D)
    cos, sin = j_rope_cos_sin(jnp.arange(SQ)[None] + 7 * jnp.arange(b)[:, None], D, 10000.0)
    return q, k, v, dout, cos, sin


# fp32: both sides compute the same exact products and differ only by fp32
# summation order (~1e-7 of the largest gradient).  bf16: the outputs are
# rounded to bf16 (2^-8 relative) and a summation-order difference can
# flip the bf16 rounding of an element of P or dS, one ulp of one term;
# 2^-7 holds that, while a wrong mask, a missed tile or a missing rope
# pull-back moves a gradient by more than its largest value.
BWD_TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -7}


# (dtype, causal, batch, heads, kv heads): GQA 4/2 in both dtypes and
# masks; group sizes 1 (H = Hk) and 4 (one KV head), and B=2 with
# per-sequence rope tables, on the causal training mask
BWD_CASES = [pytest.param(dt, c, B, H, HK, id=f"{dt}-{c}")
             for c in (False, True) for dt in ("float32", "bfloat16")]
BWD_CASES += [pytest.param(dt, True, b, h, hk, id=f"{dt}-True-B{b}-H{h}-Hk{hk}")
              for dt in ("float32", "bfloat16") for b, h, hk in ((1, 4, 4), (1, 4, 1), (2, 4, 2))]


@pytest.mark.parametrize("dtype,causal,b,h,hk", BWD_CASES)
def test_flash_bwd_plain_matches_jax(dtype, causal, b, h, hk):
    q, k, v, dout, cos, sin = attn_inputs(1, dtype, b, h, hk)
    kw = dict(causal=causal, rope_cos=cos, rope_sin=sin)
    out, lse = j_flash_fwd(q, k, v, interpret=True, **kw)
    want = j_flash_bwd(q, k, v, out, lse, dout, interpret=True, **kw)
    got = fb.flash_bwd(T(q), T(k), T(v), T(out), T(lse), T(dout), causal=causal,
                       rope_cos=T(cos), rope_sin=T(sin))
    for g, w, x, name in zip(got, want, (q, k, v), ("dq", "dk", "dv")):
        assert g.shape == x.shape and g.dtype == T(x).dtype, name
        assert rel_err(g, w) < BWD_TOL[dtype], name


def test_flash_attention_grads_match_jax():
    """autograd through the port's flash_attention (K4's plain forward,
    K9 + K10's plain backward) against jax.grad through the JAX one, fp32,
    causal, GQA, q rotated inside the kernels.  Tolerance as above."""
    q, k, v, w, cos, sin = attn_inputs(2, "float32")

    def jloss(q_, k_, v_):
        out = j_flash_attention(q_, k_, v_, causal=True, rope_cos=cos, rope_sin=sin,
                                interpret=True)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (T(x).requires_grad_(True) for x in (q, k, v))
    tcos = T(cos).requires_grad_(True)
    out = flash_attention(tq, tk, tv, causal=True, rope_cos=tcos, rope_sin=T(sin))
    (out * T(w)).sum().backward()
    for g, wg, name in zip((tq.grad, tk.grad, tv.grad), want, ("dq", "dk", "dv")):
        assert rel_err(g, wg) < BWD_TOL["float32"], name
    assert tcos.grad is None  # the rope tables are constants
    # return_lse stays forward-only, as in JAX: it refuses inputs that
    # would need a gradient, and runs under no_grad
    rope = dict(rope_cos=T(cos), rope_sin=T(sin))
    with pytest.raises(NotImplementedError, match="forward-only"):
        flash_attention(tq, tk, tv, causal=True, return_lse=True, **rope)
    with torch.no_grad():
        o2, lse = flash_attention(tq, tk, tv, causal=True, return_lse=True, **rope)
    assert torch.equal(o2, out.detach()) and lse.shape == (B, H, SQ)


@pytest.fixture(scope="module")
def tiny():
    """LLAMA_TINY from one JAX key, and a fresh port copy per call."""
    jp = jllama.init_params(jllama.LLAMA_TINY, jax.random.PRNGKey(0))
    return jp, lambda: bridge.params_from_jax(jax.device_get(jp), device="cpu")


def tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, shape).astype(np.int32)


def test_forward_matches_jax(tiny):
    """Training logits at LLAMA_TINY (fp32): only summation order differs,
    ~1e-6 on logits of O(0.1), as the prefill test holds them."""
    jp, port = tiny
    toks = tokens(3, (2, 24))
    want = jax.jit(lambda p: jllama.forward(p, jnp.asarray(toks), jllama.LLAMA_TINY,
                                            interpret=True))(jp)
    tp = port()
    got = llama.forward(tp, torch.from_numpy(toks).long(), CFG)
    assert got.shape == (2, 24, CFG.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    again = llama.forward(tp, torch.from_numpy(toks).long(), CFG, remat=True)
    assert torch.equal(got, again)


def port_fwd(p, toks, remat):
    return llama.forward(p, toks, CFG, remat=remat)


def test_train_step_matches_jax(tiny):
    """Three steps of the default TrainConfig on the same params and batch:
    loss and grad_norm to fp32 summation order.  AdamW's first step moves
    each weight by about lr * sign(g), so a gradient within rounding of 0
    could flip its weight's move by 2 lr; params are held to a tenth of lr
    (no such flip happened) and at most 1e-6 relative on the mean."""
    jp, port = tiny
    batch = tokens(4, (2, 17))
    tok, tgt = batch[:, :-1], batch[:, 1:]
    tcfg = jtrain.TrainConfig()

    jfwd = lambda p, t: jllama.forward(p, t, jllama.LLAMA_TINY, interpret=True)
    jinit, jstep = jtrain.make_train_step(jfwd, tcfg)
    jstep = jax.jit(jstep)
    jstate = jinit(jp)
    tp = port()
    init_fn, step_fn = train.make_train_step(port_fwd, train.TrainConfig())
    state = init_fn(tp)
    jparams = jp
    for _ in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(tok), jnp.asarray(tgt))
        tp, state, m = step_fn(tp, state, torch.from_numpy(tok).long(),
                               torch.from_numpy(tgt).long())
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    lr = tcfg.learning_rate
    for g, w in zip(train.param_leaves(tp), jax.tree.leaves(jparams)):
        diff = np.abs(g.detach().numpy() - np.asarray(w))
        assert diff.max() < 0.1 * lr and diff.mean() < 1e-6


def jax_moments(jstate):
    """mu and nu of optax's chain(clip_by_global_norm, adamw) state."""
    adam = jstate[1][0]
    return jax.tree.leaves(adam.mu), jax.tree.leaves(adam.nu)


@pytest.mark.parametrize("gdtype", ["bfloat16", "float32"])
def test_adamw_matches_optax_bf16_params(gdtype):
    """clip_by_global_norm + AdamW on bf16 params against optax's chain,
    three steps on the same gradients (the first clipped, norm > 1).  With
    bf16 gradients both sides round every operation to bf16 with the
    constants in bf16: params, moments and the norm bit-equal.  fp32
    gradients (what accum_steps makes) promote the moments to fp32 as
    optax does.  The fp32 norm is summed in another order, which scales
    the clipped step, and XLA on the CPU contracts a*b + c into one FMA
    where torch rounds twice: the fp32 moments agree to 1e-6 of their
    largest value, and such a rounding can flip the bf16 rounding of
    p + u, so a param may differ by one bf16 ulp (2^-8 of it), in under
    1 % of the elements."""
    import optax

    rng = np.random.default_rng(11)
    shapes = [(64, 48), (48,), (7, 5, 3)]
    p0 = [(rng.standard_normal(s) * 0.05).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
             for scale in (0.5, 1e-3, 2e-3)]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(3e-4, weight_decay=0.1))
    jparams = [jnp.asarray(x, jnp.bfloat16) for x in p0]
    jstate = tx.init(jparams)

    @jax.jit
    def jstep(params, state, g):
        u, state = tx.update(g, state, params)
        return optax.apply_updates(params, u), state, optax.global_norm(g)

    leaves = [T(x) for x in jparams]
    state = train.adamw_init(leaves)
    for step in grads:
        jg = [jnp.asarray(x, gdtype) for x in step]
        jparams, jstate, jnorm = jstep(jparams, jstate, jg)
        g = [T(x) for x in jg]
        norm = train.clip_by_global_norm(g, 1.0)
        train.adamw_update(leaves, g, state, 3e-4, 0.1)
        # a bf16 norm is rounded to bf16 on both sides; fp32 sums differ in order
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=0 if gdtype == "bfloat16"
                                   else 1e-6)
    jmu, jnu = jax_moments(jstate)
    for got, want in zip(state["mu"] + state["nu"], jmu + jnu):
        assert str(got.dtype) == f"torch.{want.dtype}"
        if gdtype == "bfloat16":
            assert torch.equal(got, T(want))
        else:
            assert rel_err(got, want) < 1e-6
    for got, want in zip(leaves, jparams):
        assert got.dtype == torch.bfloat16
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if gdtype == "bfloat16":
            np.testing.assert_array_equal(got, want)
        else:
            ulp = np.maximum(np.abs(got), np.abs(want)) * 2.0 ** -8
            assert np.all(np.abs(got - want) <= ulp) and np.mean(got != want) < 0.01


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_bf16_matches_jax(accum):
    """Three steps of LLAMA_TINY in bf16 on both sides (params, gradients,
    and moments as optax keeps them: bf16, or fp32 once accum_steps' fp32
    gradients reach them).  The forward rounds bf16 activations at other
    points than XLA does (8 significant bits): the loss agrees to 2e-4
    relative (measured 4e-5), a bf16 grad_norm exactly or an fp32 one to
    1e-3 (measured 1.6e-4).  AdamW moves each weight by about lr * sign(g)
    per step, so a gradient within that rounding of 0 can flip a move by
    2 lr: params are held to 2 lr per step and a mean |diff| of 1e-5
    (measured 3.5e-6), far below what a wrong update (lr on every weight)
    gives."""
    import dataclasses

    jcfg = dataclasses.replace(jllama.LLAMA_TINY, dtype="bfloat16")
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    tp = bridge.params_from_jax(jax.device_get(jparams), device="cpu")
    batch = tokens(12, (4, 17))
    tok, tgt = batch[:, :-1], batch[:, 1:]
    jinit, jstep = jtrain.make_train_step(
        lambda p, t: jllama.forward(p, t, jcfg, interpret=True),
        jtrain.TrainConfig(accum_steps=accum))
    jstep = jax.jit(jstep)
    jstate = jinit(jparams)
    init_fn, step_fn = train.make_train_step(
        lambda p, t, remat: llama.forward(p, t, cfg, remat=remat),
        train.TrainConfig(accum_steps=accum))
    state = init_fn(tp)
    for _ in range(3):
        jparams, jstate, jm = jstep(jparams, jstate, jnp.asarray(tok), jnp.asarray(tgt))
        tp, state, m = step_fn(tp, state, torch.from_numpy(tok).long(),
                               torch.from_numpy(tgt).long())
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-4)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    jmu, jnu = jax_moments(jstate)
    assert [str(x.dtype) for x in state["mu"] + state["nu"]] == \
        [f"torch.{x.dtype}" for x in jmu + jnu]
    lr = train.TrainConfig().learning_rate
    diffs = [np.abs(g.detach().float().numpy() - np.asarray(w, np.float32))
             for g, w in zip(train.param_leaves(tp), jax.tree.leaves(jparams))]
    assert all(g.dtype == torch.bfloat16 for g in train.param_leaves(tp))
    assert max(float(d.max()) for d in diffs) <= 3 * 2 * lr
    assert sum(float(d.sum()) for d in diffs) / sum(d.size for d in diffs) < 1e-5


@pytest.mark.parametrize("case", ["remat", "accum"])
def test_remat_and_accum_keep_the_step(tiny, case):
    """remat on against off: the same ops rerun, so the same loss and
    gradients.  accum_steps=2 against 1 on 4 sequences: the mean of two
    halves' losses and gradients, equal to fp32 summation order; then one
    step each, params as in the JAX test of the same option."""
    _, port = tiny
    batch = torch.from_numpy(tokens(5, (4, 9))).long()
    tok, tgt = batch[:, :-1], batch[:, 1:]
    a, b = port(), port()
    if case == "remat":
        for leaf in train.param_leaves(a) + train.param_leaves(b):
            leaf.requires_grad_(True)
        la, ga = train.loss_and_grads(port_fwd, a, tok, tgt, remat=False)
        lb, gb = train.loss_and_grads(port_fwd, b, tok, tgt, remat=True)
        assert float(la) == float(lb)
        assert all(torch.equal(x, y) for x, y in zip(ga, gb))
        return
    _, s1 = train.make_train_step(port_fwd, train.TrainConfig(accum_steps=1, remat=False))
    init2, s2 = train.make_train_step(port_fwd, train.TrainConfig(accum_steps=2, remat=False))
    a, sa, ma = s1(a, init2(a), tok, tgt)
    b, sb, mb = s2(b, init2(b), tok, tgt)
    assert abs(float(ma["loss"]) - float(mb["loss"])) < 1e-5
    np.testing.assert_allclose(float(ma["grad_norm"]), float(mb["grad_norm"]), rtol=1e-4)
    for x, y in zip(train.param_leaves(a), train.param_leaves(b)):
        assert float((x - y).detach().abs().max()) < 1e-4


def test_chunked_cross_entropy_matches_jax():
    """Value and both gradients against the JAX chunked cross-entropy, with
    a mask and a chunk (8) that does not divide S (25); fp32 throughout,
    so only summation order differs (tests/test_utils.py holds JAX's
    chunked against its dense version to 1e-5)."""
    rng = np.random.default_rng(6)
    Bc, S, Hd, V = 2, 25, 16, 97
    x = rng.standard_normal((Bc, S, Hd)).astype(np.float32)
    head = (rng.standard_normal((Hd, V)) * 0.1).astype(np.float32)
    tgt = rng.integers(0, V, (Bc, S))
    mask = (rng.random((Bc, S)) > 0.3).astype(np.float32)

    def jce(x_, h_):
        return jtrain.chunked_cross_entropy(x_, h_, jnp.asarray(tgt), jnp.asarray(mask), chunk=8)

    want, (gxw, ghw) = jax.value_and_grad(jce, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    tx = torch.from_numpy(x).requires_grad_(True)
    th = torch.from_numpy(head).requires_grad_(True)
    got = train.chunked_cross_entropy(tx, th, torch.from_numpy(tgt), torch.from_numpy(mask),
                                      chunk=8)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gxw), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(ghw), atol=1e-5, rtol=1e-5)
    dense = train.cross_entropy(torch.from_numpy(x) @ torch.from_numpy(head),
                                torch.from_numpy(tgt), torch.from_numpy(mask))
    np.testing.assert_allclose(float(dense), float(want), rtol=1e-5)


def test_train_tiny_lm_matches_jax(tiny):
    """The recipe's crops (numpy default_rng(0)) and three steps from the
    same initial params: losses to fp32 summation order."""
    jp, port = tiny
    corpus = np.random.default_rng(7).integers(0, CFG.vocab_size, 600)
    _, want = jtrain.train_tiny_lm(jllama.LLAMA_TINY, corpus, 3, jax.random.PRNGKey(0),
                                   batch=2, seqlen=16, interpret=True)
    _, got = train.train_tiny_lm(CFG, corpus, 3, batch=2, seqlen=16, params=port())
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_training_head_is_live(tiny):
    """The training forward never reads the serving path's fp32 head
    cache: a stale ``_lm_head_f32`` changes nothing, and ``lm_head`` gets
    its gradient."""
    _, port = tiny
    tp = port()
    toks = torch.from_numpy(tokens(8, (1, 8))).long()
    tp["lm_head"].requires_grad_(True)
    base = llama.forward(tp, toks, CFG)
    tp["_lm_head_f32"] = torch.zeros_like(tp["lm_head"])
    logits = llama.forward(tp, toks, CFG)
    assert torch.equal(base, logits)
    logits.sum().backward()
    assert tp["lm_head"].grad is not None and float(tp["lm_head"].grad.abs().max()) > 0
    assert all(leaf is not tp["_lm_head_f32"] for leaf in train.param_leaves(tp))


# Serve, train, serve: logits of the trained params against JAX's.  fp32:
# summation order, as test_forward_matches_jax holds them.  bf16: the
# decode step rounds bf16 activations at other points than XLA does
# (measured 3.8e-3 on logits of 0.77); one step moves the logits by 7.5e-2,
# and scoring with the head from before the step misses JAX's by 1.5e-2.
SERVED_TOL = {"float32": 1e-4, "bfloat16": 8e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_train_serve_reads_the_trained_head(dtype):
    """One decode step, one make_train_step step, one decode step on the
    same params dict: the second step scores with the trained head, equal
    to JAX's decode step on JAX's trained params and bit for bit to a
    fresh copy of the params.  A bf16 head is served from an fp32 copy
    that the first step caches; AdamW changes the head in place."""
    import dataclasses

    jcfg = dataclasses.replace(jllama.LLAMA_TINY, dtype=dtype)
    cfg = dataclasses.replace(CFG, dtype=dtype)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    tp = bridge.params_from_jax(jax.device_get(jp), device="cpu")
    tok0 = tokens(9, (2,))
    batch = tokens(10, (2, 17))
    tok, tgt = batch[:, :-1], batch[:, 1:]
    llama.decode_step(tp, torch.from_numpy(tok0).long(), cfg,
                      llama.make_cache(cfg, 2, 16, device="cpu"))
    jinit, jstep = jtrain.make_train_step(
        lambda p, t: jllama.forward(p, t, jcfg, interpret=True), jtrain.TrainConfig())
    jp, _, _ = jax.jit(jstep)(jp, jinit(jp), jnp.asarray(tok), jnp.asarray(tgt))
    init_fn, step_fn = train.make_train_step(
        lambda p, t, remat: llama.forward(p, t, cfg, remat=remat), train.TrainConfig())
    tp, _, _ = step_fn(tp, init_fn(tp), torch.from_numpy(tok).long(),
                       torch.from_numpy(tgt).long())
    with torch.no_grad():
        got, _ = llama.decode_step(tp, torch.from_numpy(tok0).long(), cfg,
                                   llama.make_cache(cfg, 2, 16, device="cpu"))
        fresh = {k: v for k, v in tp.items() if not k.startswith("_")}
        again, _ = llama.decode_step(fresh, torch.from_numpy(tok0).long(), cfg,
                                     llama.make_cache(cfg, 2, 16, device="cpu"))
    want, _ = jax.jit(lambda p, c: jllama.decode_step(p, jnp.asarray(tok0), jcfg, c,
                                                      interpret=True))(
        jp, jllama.make_cache(jcfg, 2, 16))
    assert torch.equal(got, again)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=SERVED_TOL[dtype])


@pytest.mark.parametrize("option", [
    {"bias": np.zeros((1, 1, SQ, SK), np.float32), "window": (4, -1)},
    {"q_segment_ids": np.zeros((B, SQ)), "kv_segment_ids": np.zeros((B, SK)),
     "logit_softcap": 30.0},
    {"q_positions": np.zeros((B, SQ)), "kv_positions": np.zeros((B, SK)), "window": (4, -1)},
    {"q_segment_ids": np.zeros((B, SQ)), "kv_segment_ids": np.zeros((B, SK)),
     "window": (2, 2)},
    {"alibi_slopes": np.ones(H), "window": (4, -1)},
    {"dropout_rate": 0.1, "logit_softcap": 30.0},
    {"alibi_slopes": np.ones(H), "logit_softcap": 30.0}])
def test_flash_bwd_refuses_unported_options(option):
    """A bias, dropout or ALiBi with a window or a softcap raises (each of
    those alone is ported: tests/test_torch_fa2_options.py,
    tests/test_torch_fa2_surface.py).  Segment ids or positions with a
    window or a softcap are ported: those options' gradients match JAX's
    flash_bwd on the same inputs, its out and lse (interpret mode), at
    BWD_TOL (tests/test_torch_window_train.py holds them on packed
    documents)."""
    jq, jk, jv, jdout, _, _ = attn_inputs(9, "float32")
    q, k, v, dout = (T(x) for x in (jq, jk, jv, jdout))
    if any(n.endswith(("segment_ids", "positions")) for n in option):
        jopt = {n: jnp.asarray(x, jnp.int32) if isinstance(x, np.ndarray) else x
                for n, x in option.items()}
        jout, jlse = j_flash_fwd(jq, jk, jv, interpret=True, **jopt)
        want = j_flash_bwd(jq, jk, jv, jout, jlse, jdout, interpret=True, **jopt)
        got = fb.flash_bwd(q, k, v, T(jout), T(jlse), dout,
                           **{n: T(x) if isinstance(x, jax.Array) else x
                              for n, x in jopt.items()})
        for g, w, name in zip(got, want, ("dq", "dk", "dv")):
            assert rel_err(g, w) < BWD_TOL["float32"], name
        return
    out, lse = q.clone(), torch.zeros((B, H, SQ))
    option = {n: T(x) if isinstance(x, np.ndarray) else x for n, x in option.items()}
    with pytest.raises(NotImplementedError):
        fb.flash_bwd(q, k, v, out, lse, dout, **option)


def test_training_wrappers_refuse():
    """fp16 (computed as bf16, gradients cast back), what K9/K10 do not
    take (CPU tensors, fp32, D other than 128 and 256, fp32 lse, fp32 rope tables, head_dim 256 without causal;
    raised before any build; a window or a softcap at head_dim 128 reaches
    the CUDA check), and the unported attention options.  K10 takes R(q) from K9 and no
    tables.  The training forward with segment ids and a window, once
    refused, matches JAX's forward(segment_ids=...) (logits at 1e-4, as
    test_forward_matches_jax holds them)."""
    q, k, v, dout, _, _ = (T(x) for x in attn_inputs(10, "float32"))
    lse = torch.zeros((B, H, SQ))
    grads = fb.flash_bwd(q.half(), k.half(), v.half(), q.half(), lse, dout.half())
    assert all(g.dtype == torch.float16 for g in grads)
    delta = torch.zeros((B, H, SQ))
    bf = [x.bfloat16() for x in (q, k, v, dout)]
    for args in ((q, k, v, dout), bf):  # fp32; then bf16 on the CPU / D = 32
        with pytest.raises(ValueError):
            fb.flash_bwd_dq_cuda(*args, lse, delta, True, 1.0, None, None)
        with pytest.raises(ValueError):
            fb.flash_bwd_dkv_cuda(*args, lse, delta, True, 1.0)
    big = [torch.zeros(s, dtype=torch.bfloat16) for s in
           ((1, 8, 2, 128), (1, 8, 1, 128), (1, 8, 1, 128), (1, 8, 2, 128))]
    stats = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fb.flash_bwd_dq_cuda(*big, stats, stats, True, 1.0, None, None)
    with pytest.raises(ValueError, match="CUDA"):
        fb.flash_bwd_dkv_cuda(*big, stats, stats, True, 1.0)
    with pytest.raises(ValueError, match="fp32 lse"):
        fb.flash_bwd_dkv_cuda(*big, stats.bfloat16(), stats, True, 1.0)
    tables = torch.zeros((8, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="fp32"):
        fb.flash_bwd_dq_cuda(*big, stats, stats, True, 1.0, tables, tables)
    wide = [torch.zeros(s, dtype=torch.bfloat16) for s in
            ((1, 8, 2, 256), (1, 8, 1, 256), (1, 8, 1, 256), (1, 8, 2, 256))]
    with pytest.raises(NotImplementedError, match="causal"):
        fb.flash_bwd_dq_cuda(*wide, stats, stats, False, 1.0, None, None)
    with pytest.raises(NotImplementedError, match="causal"):
        fb.flash_bwd_dkv_cuda(*wide, stats, stats, False, 1.0, (4, -1), 50.0)
    # a window and a softcap at head_dim 128 (Gemma-2-27B's instances),
    # causal or not, pass on to the tensors' check
    with pytest.raises(ValueError, match="CUDA"):
        fb.flash_bwd_dq_cuda(*big, stats, stats, True, 1.0, None, None, (4, -1), None)
    with pytest.raises(ValueError, match="CUDA"):
        fb.flash_bwd_dkv_cuda(*big, stats, stats, False, 1.0, (3, 3), 50.0)
    assert fb.flash_bwd_dq_cuda.launches == 0 and fb.flash_bwd_dkv_cuda.launches == 0
    assert fb.flash_bwd_dq_cuda.local_launches == 0 == fb.flash_bwd_dkv_cuda.local_launches
    jcfg = dataclasses.replace(jllama.LLAMA_TINY, sliding_window=4)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(1))
    toks = tokens(12, (1, 12))
    seg = np.repeat(np.array([1, 2], np.int32), [7, 5])[None]
    want = jax.jit(lambda p: jllama.forward(p, jnp.asarray(toks), jcfg,
                                            segment_ids=jnp.asarray(seg), interpret=True))(jp)
    got = llama.forward(bridge.params_from_jax(jax.device_get(jp), device="cpu"),
                        torch.from_numpy(toks).long(), dataclasses.replace(CFG, sliding_window=4),
                        segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    ids = torch.zeros((B, SQ), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="forward-only"):
        flash_attention(q.requires_grad_(True), k, v, q_segment_ids=ids,
                        kv_segment_ids=torch.zeros((B, SK), dtype=torch.int32),
                        return_lse=True)

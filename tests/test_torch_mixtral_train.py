"""Mixtral's training path in the port against the JAX package on the CPU,
at MIXTRAL_TINY: the differentiable ``forward`` (remat on and off, packed
documents), ``router_topk``'s gradient, three ``make_train_step`` steps
in fp32 and in bf16, AdamW over the Mixtral tree against optax, the
refusal of a windowed config with segment ids, ``utils/checkpoint`` and
``__version__``.

Inputs are made with numpy from a seed and handed to both sides; the
params go through the bridge.  JAX runs its Pallas kernels in interpret
mode under ``jax.grad``; the port runs the plain versions of its kernels.
Each JAX oracle is computed once a module.  The seeds leave every token's
top-2 expert set equal on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_attn_tpu
from flash_attn_tpu.models import mixtral as jmx
from flash_attn_tpu.parallel import moe as jmoe
from flash_attn_tpu.utils import train as jtrain
import flash_attn_tpu_torch
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.models import mixtral as mx
from flash_attn_tpu_torch.parallel import moe
from flash_attn_tpu_torch.utils import checkpoint, train
from _torch_threads import one_torch_thread  # noqa: F401

CFG = mx.MIXTRAL_TINY
JCFG = jmx.MIXTRAL_TINY
B, S = 2, 24
DOCS = (10, 14)  # each row packs two documents


def _np(t):
    return t.detach().float().numpy()


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, CFG.vocab_size, shape).astype(np.int32)


def _packed():
    """Segment ids 1, 2 and positions restarting a document, [B, S] each."""
    seg = np.concatenate([np.full(n, i + 1) for i, n in enumerate(DOCS)]).astype(np.int32)
    pos = np.concatenate([np.arange(n) for n in DOCS]).astype(np.int32)
    return np.broadcast_to(seg, (B, S)).copy(), np.broadcast_to(pos, (B, S)).copy()


@pytest.fixture(scope="module")
def jparams():
    return jmx.init_params(JCFG, jax.random.PRNGKey(0))


def _port(jp):
    return bridge.params_from_jax(jax.device_get(jp), device="cpu")


@pytest.fixture(scope="module")
def oracle(jparams):
    """{"plain" | "packed": (logits, loss, JAX's gradient leaves)}: JAX's
    forward under ``jax.value_and_grad`` of the cross-entropy on one batch,
    without and with packed documents."""
    batch = _tokens(3, (B, S + 1))
    tok, tgt = jnp.asarray(batch[:, :-1]), jnp.asarray(batch[:, 1:])
    seg, pos = _packed()
    out = {"batch": batch}
    for case, kw in (("plain", {}),
                     ("packed", dict(segment_ids=jnp.asarray(seg), positions=jnp.asarray(pos)))):
        def loss_fn(p, kw=kw):
            logits = jmx.forward(p, tok, JCFG, interpret=True, **kw)
            return jtrain.cross_entropy(logits, tgt), logits

        (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jparams)
        out[case] = (np.asarray(logits), float(loss), [np.asarray(g) for g in
                                                       jax.tree.leaves(grads)])
    return out


# fp32 on both sides: the two differ in the order of fp32 sums only, ~1e-6
# of a logit or a gradient's largest element; a leaf taken from another
# place in the tree, a lost router gradient or a wrong mask moves a leaf by
# its whole size
F32_TOL = 1e-4


@pytest.mark.parametrize("case,remat", [("plain", False), ("plain", True), ("packed", False),
                                        ("packed", True)])
def test_forward_grads_match_jax(jparams, oracle, case, remat):
    """Logits, loss and every gradient leaf (attention, router, each
    expert, norms, embedding and head) in ``named_leaves`` order against
    JAX's tree order, remat on and off; packed documents through segment
    ids and restarting positions."""
    want_logits, want_loss, want_grads = oracle[case]
    batch = torch.from_numpy(oracle["batch"]).long()
    kw = {}
    if case == "packed":
        seg, pos = _packed()
        kw = dict(segment_ids=torch.from_numpy(seg), positions=torch.from_numpy(pos).long())
    tp = _port(jparams)
    leaves = train.param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    logits = mx.forward(tp, batch[:, :-1], CFG, remat=remat, **kw)
    loss = train.cross_entropy(logits, batch[:, 1:])
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(_np(logits), want_logits, rtol=0,
                               atol=F32_TOL * np.abs(want_logits).max())
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-5)
    assert len(grads) == len(want_grads)
    names = [n for n, _ in train.named_leaves(tp)]
    assert sum(".router" in n for n in names) == CFG.num_layers
    for name, g, w in zip(names, grads, want_grads):
        assert g.shape == w.shape, name
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(_np(g), w, rtol=0, atol=F32_TOL * np.abs(w).max(),
                                   err_msg=name)


def test_remat_gives_the_same_gradients(jparams, oracle):
    """remat reruns the same ops: the same loss and gradients, bit for bit."""
    batch = torch.from_numpy(oracle["batch"]).long()
    out = []
    for remat in (False, True):
        tp = _port(jparams)
        leaves = train.param_leaves(tp)
        for p in leaves:
            p.requires_grad_(True)
        loss = train.cross_entropy(mx.forward(tp, batch[:, :-1], CFG, remat=remat),
                                   batch[:, 1:])
        out.append([loss.detach()] + list(torch.autograd.grad(loss, leaves)))
    assert all(torch.equal(a, b) for a, b in zip(*out))


ROUTER_LOGITS = np.array([
    [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],    # all equal: experts 0, 1
    [0.0, 2.0, 2.0, 2.0, 1.0, 0.0, 0.0, 0.0],    # three-way tie at the top
    [3.0, 0.5, 0.5, 3.0, 0.5, 0.5, 3.0, 0.5],    # three-way tie, spread
    [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 7.0],    # one top, seven tied below
    [0.3, -1.2, 2.5, 0.7, -0.1, 1.9, 0.2, -2.0],  # no tie
], np.float32)


ROUTER_INPUTS = {"ties": ROUTER_LOGITS,
                 "random": np.random.default_rng(7).standard_normal((32, 8)).astype(np.float32)}


@pytest.fixture(scope="module")
def router_grads():
    """{k: (logits, r, JAX's gradient)} of sum(router_topk(logits, k) * r)
    for both inputs stacked row-wise (the router works row by row, so each
    row's gradient is its own), one jitted JAX call a k."""
    x = np.concatenate([ROUTER_INPUTS["ties"], ROUTER_INPUTS["random"]])
    r = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    return {k: (x, r, np.asarray(jax.jit(jax.grad(
        lambda z, k=k: jnp.sum(jmoe.router_topk(z, k) * r)))(jnp.asarray(x))))
        for k in (1, 2, 3)}


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("logits", ["ties", "random"])
def test_router_topk_gradient_matches_jax(router_grads, k, logits):
    """The gradient of sum(weights * r) into the logits: JAX's through
    ``lax.top_k`` reaches the selected logits and is zero elsewhere; exact
    ties go to the lower index on both sides, so the gradient lands on the
    same experts."""
    x, r, want = router_grads[k]
    rows = slice(0, 5) if logits == "ties" else slice(5, None)
    x, r, want = x[rows], r[rows], want[rows]
    assert np.array_equal(x, ROUTER_INPUTS[logits])
    t = torch.from_numpy(x).requires_grad_(True)
    (moe.router_topk(t, k) * torch.from_numpy(r)).sum().backward()
    got = t.grad.numpy()
    chosen = moe.router_topk(torch.from_numpy(x), k).numpy() > 0
    assert np.all(got[~chosen] == 0) and np.all(want[~chosen] == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_windowed_config_with_segment_ids_is_refused(jparams):
    """The packed path with a window, once refused before attention, now
    runs (K4's masked kLocal instance, K9's and K10's kLocal and kOpt ones
    on the card): a window of 8 on documents of 10 and 14 gives JAX's
    forward(segment_ids=...) logits at F32_TOL (the gradient is held in
    tests/test_torch_window_train.py)."""
    seg, pos = _packed()
    toks = _tokens(1, (B, S))
    jcfg = dataclasses.replace(JCFG, sliding_window=8)
    want = jax.jit(lambda p: jmx.forward(p, jnp.asarray(toks), jcfg, interpret=True,
                                         segment_ids=jnp.asarray(seg),
                                         positions=jnp.asarray(pos)))(jparams)
    got = mx.forward(_port(jparams), torch.from_numpy(toks).long(),
                     dataclasses.replace(CFG, sliding_window=8),
                     segment_ids=torch.from_numpy(seg), positions=torch.from_numpy(pos).long())
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=F32_TOL)


def _port_fwd(cfg):
    return lambda p, t, remat: mx.forward(p, t, cfg, remat=remat)


@pytest.fixture(scope="module")
def jax_steps(jparams):
    """{dtype: (batch, [(loss, grad_norm)] of three steps, final params
    leaves, moments)} of JAX's make_train_step (default TrainConfig) on one
    batch, fp32 from ``jparams`` and bf16 from its bf16 copy."""
    batch = _tokens(4, (B, 17))
    tok, tgt = jnp.asarray(batch[:, :-1]), jnp.asarray(batch[:, 1:])
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(JCFG, dtype=dtype)
        p = jax.tree.map(lambda x: x.astype(dtype), jparams)
        jinit, jstep = jtrain.make_train_step(
            lambda q, t, cfg=cfg: jmx.forward(q, t, cfg, interpret=True), jtrain.TrainConfig())
        jstep = jax.jit(jstep)
        state = jinit(p)
        start = p
        metrics = []
        for _ in range(3):
            p, state, m = jstep(p, state, tok, tgt)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        adam = state[1][0]
        out[dtype] = (batch, start, metrics, jax.tree.leaves(p),
                      jax.tree.leaves(adam.mu) + jax.tree.leaves(adam.nu))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_matches_jax(jax_steps, dtype):
    """Three steps of the default TrainConfig (remat on), the same params and
    batch.  fp32: loss to 1e-5 and grad_norm to 1e-4 (summation order), as
    the Llama step's test holds them; params to a tenth of lr.  bf16: the
    forward rounds bf16 activations at other points than XLA does, so the
    loss agrees to 2e-4 and grad_norm to 1e-3, and AdamW moves each weight
    by about lr * sign(g) a step, so params are held to 2 lr a step and a
    mean |diff| of 1e-5 (the Llama bf16 step's bounds); the moments keep
    optax's dtypes."""
    batch, start, metrics, jleaves, jmoments = jax_steps[dtype]
    tp = _port(start)
    init_fn, step_fn = train.make_train_step(_port_fwd(dataclasses.replace(CFG, dtype=dtype)),
                                             train.TrainConfig())
    state = init_fn(tp)
    tok, tgt = torch.from_numpy(batch[:, :-1]).long(), torch.from_numpy(batch[:, 1:]).long()
    rtol = (1e-5, 1e-4) if dtype == "float32" else (2e-4, 1e-3)
    for jloss, jnorm in metrics:
        tp, state, m = step_fn(tp, state, tok, tgt)
        np.testing.assert_allclose(float(m["loss"]), jloss, rtol=rtol[0])
        np.testing.assert_allclose(float(m["grad_norm"]), jnorm, rtol=rtol[1])
    assert [str(x.dtype) for x in state["mu"] + state["nu"]] == \
        [f"torch.{x.dtype}" for x in jmoments]
    lr = train.TrainConfig().learning_rate
    diffs = [np.abs(_np(g) - np.asarray(w, np.float32))
             for g, w in zip(train.param_leaves(tp), jleaves)]
    mean = sum(float(d.sum()) for d in diffs) / sum(d.size for d in diffs)
    if dtype == "float32":
        assert max(float(d.max()) for d in diffs) < 0.1 * lr and mean < 1e-6
    else:
        assert max(float(d.max()) for d in diffs) <= 3 * 2 * lr and mean < 1e-5


def test_adamw_over_the_mixtral_tree_is_optax_bit_for_bit(jparams):
    """Clipping and AdamW on the bf16 Mixtral tree, the same bf16 gradients
    on both sides, three steps: params and moments bit-equal to optax's.
    Every expert's three leaves share their shapes with the other
    experts', so only JAX's leaf order gives equal values."""
    import optax

    jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jparams)
    rng = np.random.default_rng(12)
    jgrads = [jax.tree.map(lambda x, s=s: jnp.asarray(
        rng.standard_normal(x.shape) * s, jnp.bfloat16), jp) for s in (0.05, 1e-3, 2e-3)]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(3e-4, weight_decay=0.1))
    jstate = tx.init(jp)

    @jax.jit
    def jstep(params, state, g):
        u, state = tx.update(g, state, params)
        return optax.apply_updates(params, u), state

    tp = _port(jp)
    leaves = train.param_leaves(tp)
    state = train.adamw_init(leaves)
    for g in jgrads:
        jp, jstate = jstep(jp, jstate, g)
        grads = [bridge.to_torch(x, "cpu") for x in jax.tree.leaves(g)]
        train.clip_by_global_norm(grads, 1.0)
        train.adamw_update(leaves, grads, state, 3e-4, 0.1)
    adam = jstate[1][0]
    for got, want in zip(leaves + state["mu"] + state["nu"],
                         jax.tree.leaves(jp) + jax.tree.leaves(adam.mu)
                         + jax.tree.leaves(adam.nu)):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, bridge.to_torch(want, "cpu"))


def _steps(params, state, step_fn, batch, n):
    tok, tgt = torch.from_numpy(batch[:, :-1]).long(), torch.from_numpy(batch[:, 1:]).long()
    losses = []
    for _ in range(n):
        params, state, m = step_fn(params, state, tok, tgt)
        losses.append(m["loss"])
    return params, state, losses


def _bitwise(a, b):
    la, lb = train.param_leaves(a), train.param_leaves(b)
    return len(la) == len(lb) and all(
        x == y if isinstance(x, int) else x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(la, lb))


def test_checkpoint_resume_is_bitwise(jparams, tmp_path):
    """Three straight steps against two steps, a save through
    TrainCheckpointManager, a restore into a fresh tree and one more step:
    the params, the moments, the count and the last loss bit for bit."""
    batch = _tokens(5, (B, 13))
    init_fn, step_fn = train.make_train_step(_port_fwd(CFG), train.TrainConfig())
    straight = _port(jparams)
    st = init_fn(straight)
    straight, st, want = _steps(straight, st, step_fn, batch, 3)

    tp = _port(jparams)
    state = init_fn(tp)
    tp, state, _ = _steps(tp, state, step_fn, batch, 2)
    mgr = checkpoint.TrainCheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, {"params": tp, "opt": state})
    mgr.close()
    fresh = _port(jparams)
    like = {"params": fresh, "opt": init_fn(fresh)}
    step, restored = checkpoint.TrainCheckpointManager(str(tmp_path / "ckpt")).restore_latest(
        like)
    assert step == 2
    assert _bitwise(restored, {"params": tp, "opt": state})
    assert restored["opt"]["count"] == 2
    assert all(p.requires_grad for p in train.param_leaves(restored["params"]))
    got_p, got_st, got = _steps(restored["params"], restored["opt"], step_fn, batch, 1)
    assert torch.equal(got[0], want[-1])
    assert _bitwise({"params": got_p, "opt": got_st}, {"params": straight, "opt": st})


def test_checkpoint_save_load_and_retention(tmp_path):
    """save/load keep every leaf's dtype and bits and skip "_" keys; like
    restores its dtypes' tensors onto its device; force=False refuses an
    existing file; the manager keeps the newest max_to_keep and answers
    (None, None) on an empty directory."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn((8, 4), generator=g).to(torch.bfloat16)
    tree = {"blocks": [{"a": w, "b": torch.randn(3, generator=g)}], "count": 7,
            "_lm_head_f32": (w, 0, w.float())}
    path = str(tmp_path / "one.pt")
    checkpoint.save(path, tree)
    back = checkpoint.load(path)
    assert set(back) == {"blocks", "count"} and back["count"] == 7
    assert back["blocks"][0]["a"].dtype == torch.bfloat16
    assert torch.equal(back["blocks"][0]["a"], w)
    assert torch.equal(back["blocks"][0]["b"], tree["blocks"][0]["b"])
    like = {"blocks": [{"a": w.clone().requires_grad_(True), "b": torch.zeros(3)}], "count": 0}
    again = checkpoint.load(path, like)
    assert again["blocks"][0]["a"].requires_grad and torch.equal(again["blocks"][0]["a"], w)
    assert again["count"] == 7
    with pytest.raises(FileExistsError):
        checkpoint.save(path, tree, force=False)

    assert checkpoint.TrainCheckpointManager(str(tmp_path / "empty")).restore_latest() == \
        (None, None)
    mgr = checkpoint.TrainCheckpointManager(str(tmp_path / "keep"), max_to_keep=2)
    for step in (1, 2, 3, 5):
        mgr.save(step, {"x": torch.full((2,), float(step))})
    assert mgr.all_steps() == [3, 5]
    step, state = mgr.restore_latest()
    assert step == 5 and torch.equal(state["x"], torch.full((2,), 5.0))
    mgr.close()


def test_version_equals_jax():
    assert flash_attn_tpu_torch.__version__ == flash_attn_tpu.__version__ == "0.1.0"

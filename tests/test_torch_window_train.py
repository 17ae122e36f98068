"""Training a sliding-window model on packed documents, and the windowed
ring, against the JAX package on the CPU.

The window and the logit softcap with segment ids and positions go through
the port's whole training path: ``flash_fwd`` and ``flash_bwd`` (the plain
versions of K4's masked kLocal instance and of K9's and K10's kLocal and
kOpt instances) against JAX's Pallas kernels in interpret mode, with
segment ids alone (the window on the bottom-right aligned indices), with
positions alone and with both (the window on the positions), causal and
not, one-sided and two-sided windows, with and without the softcap; the
differentiable ``flash_attention`` against ``jax.grad``; ``LLAMA_TINY``
with a window of 6 and with a softcap through ``forward(segment_ids=...)``
and three ``make_train_step`` steps on packed documents; ``MIXTRAL_TINY``
windowed through ``forward(segment_ids=...)`` and its gradient; and the
contiguous windowed ring on four CPU ranks against JAX's ring, out and
gradients.

Inputs are made with numpy from a seed and handed to both sides; params go
through the bridge.  JAX runs jitted, its kernels in interpret mode; the
port runs the plain versions of its kernels.  Everything is fp32.
Tolerances are those of tests/test_torch_train.py (fp32 gradients 2e-6 of
the largest, logits 1e-4, the train step's loss 1e-5 and grad norm 1e-4
relative) and tests/test_torch_window_paths.py (outputs and LSE 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.models import llama as jllama
from flash_attn_tpu.models import mixtral as jmx
from flash_attn_tpu.ops.attention import flash_attention as j_flash_attention
from flash_attn_tpu.ops.flash_bwd import flash_bwd as j_flash_bwd
from flash_attn_tpu.ops.flash_fwd import flash_fwd as j_flash_fwd
from flash_attn_tpu.ops.reference import mha_reference as j_mha
from flash_attn_tpu.parallel import mesh as jmesh
from flash_attn_tpu.parallel.ring import make_ring_attention as j_make_ring
from flash_attn_tpu.utils import train as jtrain
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.models import llama
from flash_attn_tpu_torch.models import mixtral as mx
from flash_attn_tpu_torch.ops import flash_bwd as fb
from flash_attn_tpu_torch.ops import flash_fwd as ff
from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.parallel import mesh
from flash_attn_tpu_torch.parallel.ring import make_ring_attention
from flash_attn_tpu_torch.utils import train
from _torch_threads import one_torch_thread  # noqa: F401

# GQA with Sq != Sk, so that the window and causal are shifted (bottom-right)
B, SQ, SK, H, HK, D = 2, 40, 56, 4, 2, 32
OP_TOL = 1e-4
GRAD_TOL = 2e-6
LOGIT_TOL = 1e-4
WINDOW = 6
# a cap below this init's scores (|s| up to ~0.1), so that it bends them
CAP = 0.02


def T(x):
    """A JAX or numpy array -> a CPU tensor."""
    return bridge.to_torch(jax.device_get(x), device="cpu")


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    g = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32)
    w = np.asarray(want, np.float32)
    return float(np.abs(g - w).max() / np.abs(w).max())


def inputs(seed):
    """q, k, v, dout as fp32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, SQ, H, D), np.float32),
            rng.standard_normal((B, SK, HK, D), np.float32),
            rng.standard_normal((B, SK, HK, D), np.float32),
            rng.standard_normal((B, SQ, H, D), np.float32))


def packed(seed, segments: bool, positions: bool):
    """Documents packed on each side: sorted segment ids 1-3 and, with
    ``positions``, each token's place in its document, a query's shifted by
    its document's key length less its query length (varlen's bottom-right
    alignment)."""
    rng = np.random.default_rng(seed)
    qs = np.sort(rng.integers(1, 4, (B, SQ)), axis=1).astype(np.int32)
    ks = np.sort(rng.integers(1, 4, (B, SK)), axis=1).astype(np.int32)
    out = {}
    if segments:
        out.update(q_segment_ids=qs, kv_segment_ids=ks)
    if positions:
        qp, kp = np.zeros_like(qs), np.zeros_like(ks)
        for b in range(B):
            for s in (1, 2, 3):
                qi, ki = np.nonzero(qs[b] == s)[0], np.nonzero(ks[b] == s)[0]
                qp[b, qi] = np.arange(len(qi)) + len(ki) - len(qi)
                kp[b, ki] = np.arange(len(ki))
        out.update(q_positions=qp, kv_positions=kp)
    return out


# (id, segment ids, positions, causal, window, softcap): the window on the
# indices (segment ids alone) and on the positions (positions, or both),
# one-sided and two-sided, causal and not, and the softcap with each
CASES = [
    ("segments-window-causal", True, False, True, (4, -1), None),
    ("segments-window2-not-causal", True, False, False, (3, 2), None),
    ("positions-window-softcap-causal", False, True, True, (4, -1), 2.0),
    ("positions-window2-not-causal", False, True, False, (3, 3), None),
    ("both-window-causal", True, True, True, (4, -1), None),
    ("segments-softcap-causal", True, False, True, None, 2.0),
    ("both-window2-softcap-not-causal", True, True, False, (5, 2), 2.0),
]


@pytest.fixture(scope="module")
def jax_ops():
    """JAX's forward and backward, in interpret mode, for each of CASES on
    its inputs (seed from its index): {id: (inputs, masks, out, lse, dq,
    dk, dv)}, computed once for the module in one jitted call (one compile
    for all)."""
    args = [(*inputs(30 + i), packed(40 + i, seg, pos))
            for i, (_, seg, pos, _, _, _) in enumerate(CASES)]

    def f(args):
        outs = []
        for (q, k, v, dout, masks), (_, _, _, causal, window, cap) in zip(args, CASES):
            kw = dict(causal=causal, window=window, logit_softcap=cap, interpret=True)
            o, lse = j_flash_fwd(q, k, v, **masks, **kw)
            outs.append((o, lse, *j_flash_bwd(q, k, v, o, lse, dout, **masks, **kw)))
        return outs

    return {c[0]: (a[:4], a[4], *r) for c, a, r in zip(CASES, args, jax.jit(f)(args))}


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_flash_fwd_bwd_window_masks_match_jax(jax_ops, name):
    """out and lse (flash_fwd), then dq, dk, dv (flash_bwd on JAX's out and
    lse), each against JAX's kernels."""
    _, seg, pos, causal, window, cap = next(c for c in CASES if c[0] == name)
    (q, k, v, dout), masks, jout, jlse, *jgrads = jax_ops[name]
    tm = {n: torch.from_numpy(x) for n, x in masks.items()}
    kw = dict(causal=causal, window=window, logit_softcap=cap, **tm)
    out, lse = ff.flash_fwd(T(q), T(k), T(v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=OP_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=OP_TOL, rtol=OP_TOL)
    grads = fb.flash_bwd(T(q), T(k), T(v), T(jout), T(jlse), T(dout), **kw)
    for g, w, x, n in zip(grads, jgrads, (q, k, v), ("dq", "dk", "dv")):
        assert g.shape == x.shape, n
        assert rel_err(g, w) < GRAD_TOL, n


@pytest.mark.parametrize("name", ["segments-window2-not-causal", "both-window-causal",
                                  "both-window2-softcap-not-causal"])
def test_flash_attention_window_masks_grads_match_jax(name):
    """autograd through the port's flash_attention against jax.grad through
    JAX's, with the masks, the window and the cap of CASES ``name``."""
    _, seg, pos, causal, window, cap = next(c for c in CASES if c[0] == name)
    q, k, v, w = inputs(60)
    masks = packed(61, seg, pos)
    kw = dict(causal=causal, window=window, logit_softcap=cap)

    def jloss(q_, k_, v_):
        return jnp.sum(j_flash_attention(q_, k_, v_, interpret=True, **masks, **kw) * w)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (T(x).requires_grad_(True) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, **{n: torch.from_numpy(x) for n, x in masks.items()},
                          **kw)
    (out * T(w)).sum().backward()
    for g, wg, n in zip((tq.grad, tk.grad, tv.grad), want, ("dq", "dk", "dv")):
        assert rel_err(g, wg) < GRAD_TOL, n


# --- the models on packed documents -------------------------------------------

DOCS = (9, 7, 5, 3)  # one row of 24 tokens: the first document past the window


def docs_masks(b):
    """Segment ids 1-4 and positions restarting a document, [b, 24]."""
    seg = np.repeat(np.arange(1, len(DOCS) + 1, dtype=np.int32), DOCS)[None].repeat(b, 0)
    pos = np.concatenate([np.arange(n) for n in DOCS]).astype(np.int32)[None].repeat(b, 0)
    return seg, pos


CONFIGS = {
    "window": (dataclasses.replace(llama.LLAMA_TINY, sliding_window=WINDOW),
               dataclasses.replace(jllama.LLAMA_TINY, sliding_window=WINDOW)),
    "softcap": (dataclasses.replace(llama.LLAMA_TINY, attn_logit_softcap=CAP),
                dataclasses.replace(jllama.LLAMA_TINY, attn_logit_softcap=CAP)),
}


@pytest.fixture(scope="module")
def tiny_params():
    jp = jllama.init_params(jllama.LLAMA_TINY, jax.random.PRNGKey(5))
    return jp, lambda: bridge.params_from_jax(jax.device_get(jp), device="cpu")


def forward_batch():
    """Tokens, segment ids, positions and the logits' weights of the
    forward test."""
    rng = np.random.default_rng(70)
    toks = rng.integers(0, llama.LLAMA_TINY.vocab_size, (2, sum(DOCS))).astype(np.int32)
    w = rng.standard_normal((2, sum(DOCS), llama.LLAMA_TINY.vocab_size)).astype(np.float32)
    return (toks, *docs_masks(2), w)


@pytest.fixture(scope="module")
def jax_forwards(tiny_params):
    """{config: (JAX's logits, its gradients of the mean logit product)}
    of each of CONFIGS on forward_batch, in one jitted call."""
    jp, _ = tiny_params
    toks, seg, pos, w = forward_batch()

    def f(p):
        res = {}
        for which, (_, jcfg) in CONFIGS.items():
            def jloss(p_, jcfg=jcfg):
                logits = jllama.forward(p_, jnp.asarray(toks), jcfg, positions=jnp.asarray(pos),
                                        segment_ids=jnp.asarray(seg), interpret=True)
                return jnp.mean(logits * w), logits
            (_, logits), grads = jax.value_and_grad(jloss, has_aux=True)(p)
            res[which] = (logits, grads)
        return res

    return jax.jit(f)(jp)


@pytest.mark.parametrize("which", list(CONFIGS))
def test_llama_forward_segment_ids_matches_jax(tiny_params, jax_forwards, which):
    """LLAMA_TINY with a window of 6 (the first document of 9 runs past
    it) or a softcap, two rows of packed documents: the logits and every
    leaf's gradient of the mean logit product against JAX's
    forward(segment_ids=...), remat on; a document's logits are those of
    the document alone."""
    cfg, _ = CONFIGS[which]
    _, port = tiny_params
    toks, seg, pos, w = forward_batch()
    jlogits, jgrads = jax_forwards[which]
    tp = port()
    leaves = train.param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    logits = llama.forward(tp, torch.from_numpy(toks).long(), cfg,
                           positions=torch.from_numpy(pos).long(),
                           segment_ids=torch.from_numpy(seg), remat=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=LOGIT_TOL)
    grads = torch.autograd.grad((logits * torch.from_numpy(w)).mean(), leaves)
    for g, wg in zip(grads, jax.tree.leaves(jgrads)):
        assert rel_err(g, wg) < 1e-4
    alone = llama.forward(tp, torch.from_numpy(toks[:, :DOCS[0]]).long(), cfg).detach()
    np.testing.assert_allclose(logits.detach()[:, :DOCS[0]].numpy(), alone.numpy(),
                               atol=LOGIT_TOL)


def test_train_step_packed_matches_jax(tiny_params):
    """Three steps of the default TrainConfig on packed documents with the
    window of 6 and the softcap together, as tests/test_torch_train.py
    holds the unpacked step: loss and grad norm to fp32 summation order,
    params to a tenth of lr."""
    cfg, jcfg = (dataclasses.replace(c, attn_logit_softcap=CAP) for c in CONFIGS["window"])
    jp, port = tiny_params
    batch = np.random.default_rng(71).integers(0, cfg.vocab_size, (2, sum(DOCS) + 1))
    batch = batch.astype(np.int32)
    tok, tgt = batch[:, :-1], batch[:, 1:]
    seg, pos = docs_masks(2)

    def jfwd(p, t):
        return jllama.forward(p, t, jcfg, positions=jnp.asarray(pos),
                              segment_ids=jnp.asarray(seg), interpret=True)

    def tfwd(p, t, remat):
        return llama.forward(p, t, cfg, positions=torch.from_numpy(pos).long(),
                             segment_ids=torch.from_numpy(seg), remat=remat)

    tcfg = jtrain.TrainConfig()
    jinit, jstep = jtrain.make_train_step(jfwd, tcfg)
    jstep = jax.jit(jstep)
    jstate, jparams = jinit(jp), jp
    tp = port()
    init_fn, step_fn = train.make_train_step(tfwd, train.TrainConfig())
    state = init_fn(tp)
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


def test_mixtral_forward_segment_ids_window_matches_jax():
    """MIXTRAL_TINY with a window of 6 on packed documents: logits and every
    leaf's gradient of the mean logit product against JAX's, remat on."""
    cfg = dataclasses.replace(mx.MIXTRAL_TINY, sliding_window=WINDOW)
    jcfg = dataclasses.replace(jmx.MIXTRAL_TINY, sliding_window=WINDOW)
    jp = jmx.init_params(jcfg, jax.random.PRNGKey(6))
    tp = bridge.params_from_jax(jax.device_get(jp), device="cpu")
    rng = np.random.default_rng(72)
    toks = rng.integers(0, cfg.vocab_size, (1, sum(DOCS))).astype(np.int32)
    seg, pos = docs_masks(1)
    w = rng.standard_normal((1, sum(DOCS), cfg.vocab_size)).astype(np.float32)

    def jloss(p):
        logits = jmx.forward(p, jnp.asarray(toks), jcfg, positions=jnp.asarray(pos),
                             segment_ids=jnp.asarray(seg), interpret=True)
        return jnp.mean(logits * w), logits

    (_, jlogits), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    leaves = train.param_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    logits = mx.forward(tp, torch.from_numpy(toks).long(), cfg,
                        positions=torch.from_numpy(pos).long(),
                        segment_ids=torch.from_numpy(seg), remat=True)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=LOGIT_TOL)
    grads = torch.autograd.grad((logits * torch.from_numpy(w)).mean(), leaves)
    for g, wg in zip(grads, jax.tree.leaves(jgrads)):
        assert rel_err(g, wg) < 1e-4


# --- the windowed ring --------------------------------------------------------

N = 4


@pytest.fixture(scope="module")
def mesh4():
    return mesh.host_local_mesh(N, axis="sp")


@pytest.fixture(scope="module")
def jmesh4():
    return jmesh.make_mesh(jmesh.MeshConfig(sp=N))


def test_ring_window_matches_jax_ring(mesh4, jmesh4):
    """The contiguous ring, causal, with a window on the global positions
    that reaches back over two shards of 64 and one forward (100, 0: past
    the causal edge, so causal decides there), GQA 4/2, S=256 over 4 ranks:
    out and gradients against JAX's ring
    on four virtual devices (interpret mode) and its jnp oracle, at
    tests/test_torch_parallel.py's tolerances (2e-5 out, 5e-5 gradients of
    O(1) values)."""
    window = (100, 0)
    rng = np.random.default_rng(80)
    q, dout = (rng.standard_normal((1, 256, 4, 64), np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, 256, 2, 64), np.float32) for _ in range(2))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = make_ring_attention(mesh4, causal=True, window=window)(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    j_fn = j_make_ring(jmesh4, causal=True, window=window, interpret=True)

    def j_out_grads(q_, k_, v_):
        o, vjp = jax.vjp(j_fn, q_, k_, v_)
        return o, vjp(jnp.asarray(dout))

    jout, jgrads = jax.jit(j_out_grads)(q, k, v)
    assert np.abs(out.detach().numpy() - np.asarray(jout)).max() <= 2e-5
    assert np.abs(out.detach().numpy()
                  - np.asarray(j_mha(q, k, v, causal=True, window=window))).max() <= 2e-5
    for g, w in zip(grads, jgrads):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 5e-5

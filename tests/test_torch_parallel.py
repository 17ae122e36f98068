"""The port's sequence-parallel path against the JAX package on the CPU:
the mesh and its collectives, ``lse_merge2``, the ring over K4 / K9 + K10
(contiguous and striped, forward and backward, GQA, dropout, a bias, the
softcap), the one-kernel ring (K11's plain version) and Ulysses.

The port runs over ``host_local_mesh(4, axis="sp")``: four CPU ranks in
one process, as JAX's tests run four virtual CPU devices.  Inputs come
from numpy seeds and reach both sides through numpy.  JAX runs its rings
in interpret mode only a few times at S = 256 (the rdma ring, causal and
not; the ring with dropout, forward and gradients; Ulysses with dropout),
and its jnp oracle (``mha_reference`` and ``jax.grad`` of it) for the
rest.  Tolerances: both sides fp32, differing by summation order and by
the LSE merges' exp/log roundings: outputs 2e-5 and gradients 5e-5 of
O(1) values; the rdma ring at JAX's own 2e-4 (tests/test_parallel.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.ops.lse import lse_merge as j_lse_merge
from flash_attn_tpu.ops.lse import lse_merge2 as j_lse_merge2
from flash_attn_tpu.ops.reference import mha_reference as j_mha
from flash_attn_tpu.parallel import mesh as jmesh
from flash_attn_tpu.parallel.rdma_ring import make_rdma_ring_attention as j_make_rdma
from flash_attn_tpu.parallel.ring import make_ring_attention as j_make_ring
from flash_attn_tpu.parallel import ring as jring
from flash_attn_tpu.parallel.ring import stripe_sequence as j_stripe
from flash_attn_tpu.parallel.ulysses import make_ulysses_attention as j_make_ulysses
import flash_attn_tpu_torch
from flash_attn_tpu_torch.ops.lse import lse_merge2
from flash_attn_tpu_torch.parallel import mesh, ring
from flash_attn_tpu_torch.parallel.rdma_ring import make_rdma_ring_attention, ring_attn_plain
from flash_attn_tpu_torch.parallel.ring import (
    make_ring_attention,
    stripe_sequence,
    unstripe_sequence,
)
from flash_attn_tpu_torch.parallel.ulysses import make_ulysses_attention
from _torch_threads import one_torch_thread  # noqa: F401

N = 4
OUT_TOL = 2e-5
GRAD_TOL = 5e-5
RDMA_TOL = 2e-4


@pytest.fixture(scope="module")
def mesh4():
    return mesh.host_local_mesh(N, axis="sp")


@pytest.fixture(scope="module")
def jmesh4():
    return jmesh.make_mesh(jmesh.MeshConfig(sp=N))


def arrays(seed, b=1, s=256, h=4, hk=2, d=64):
    """q, k, v, dout as numpy fp32."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, d), np.float32),
            rng.standard_normal((b, s, hk, d), np.float32),
            rng.standard_normal((b, s, hk, d), np.float32),
            rng.standard_normal((b, s, h, d), np.float32))


def T(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def err(got, want) -> float:
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(g - np.asarray(want)).max())


def port_grads(fn, q, k, v, dout):
    """out and (dq, dk, dv) of sum(fn(q, k, v) * dout) on numpy inputs."""
    tq, tk, tv = T(q, True), T(k, True), T(v, True)
    out = fn(tq, tk, tv)
    return out, torch.autograd.grad(out, (tq, tk, tv), T(dout))


def jax_grads(fn, q, k, v, dout):
    """jax.grad of sum(fn(q, k, v) * dout), jitted (one compile in place
    of one an operation)."""
    return jax.jit(jax.grad(lambda q_, k_, v_: jnp.sum(fn(q_, k_, v_) * dout),
                            argnums=(0, 1, 2)))(q, k, v)


# ---------------------------------------------------------------- the mesh


def test_make_mesh_raises_on_too_few_devices():
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh.make_mesh(mesh.MeshConfig(sp=4), devices=["cpu"] * 3)
    m = mesh.make_mesh(mesh.MeshConfig(dp=2, sp=2), devices=["cpu"] * 4)
    assert m.shape == {"dp": 2, "tp": 1, "sp": 2}
    assert m.axis_devices("sp") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="unknown mesh axis"):
        m.axis_devices("ep")


def test_mesh_collectives(mesh4):
    """shard / unshard round trip, ppermute's ring shift and all_to_all's
    regrouping, element for element."""
    x = torch.arange(2 * 8 * 4 * 3).reshape(2, 8, 4, 3)
    spec = (None, "sp", None, None)
    parts = mesh.shard(mesh4, x, spec)
    assert [tuple(p.shape) for p in parts] == [(2, 2, 4, 3)] * N
    assert torch.equal(mesh.unshard(mesh4, parts, spec), x)
    moved = mesh.ppermute(mesh4, parts)
    for r in range(N):
        assert torch.equal(moved[r], parts[(r - 1) % N])
    heads = mesh.all_to_all(mesh4, parts, split_dim=2, concat_dim=1)
    for r in range(N):  # rank r: the whole sequence of head r
        assert torch.equal(heads[r], x[:, :, r:r + 1])
    back = mesh.all_to_all(mesh4, heads, split_dim=1, concat_dim=2)
    assert all(torch.equal(a, b) for a, b in zip(back, parts))
    with pytest.raises(ValueError, match="cannot split"):
        mesh.shard(mesh4, x[:, :6], spec)


# ---------------------------------------------------------------- lse_merge2


def test_lse_merge2_matches_jax():
    """Live rows against JAX's merge; dead partials (-inf, JAX's; -1e30,
    the port kernels') weigh 0 on both sides once the port's -1e30 is
    JAX's -inf; two dead partials give out 0 and lse -inf."""
    rng = np.random.default_rng(3)
    o1, o2 = (rng.standard_normal((2, 6, 16), np.float32) for _ in range(2))
    l1, l2 = (rng.standard_normal((2, 6), np.float32) * 4 for _ in range(2))
    l1[0, 0] = l2[0, 1] = -np.inf
    l1[0, 2] = l2[0, 3] = -1e30
    l1[1, 0] = l2[1, 0] = -np.inf
    l1[1, 1] = l2[1, 1] = -1e30
    l1[1, 2], l2[1, 2] = -np.inf, -1e30
    out, lse = lse_merge2(T(o1), T(l1), T(o2), T(l2))
    j1, j2 = (np.where(x <= -1e30, -np.inf, x).astype(np.float32) for x in (l1, l2))
    wout, wlse = j_lse_merge2(o1, j1, o2, j2)
    assert err(out, wout) <= 1e-6
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(np.asarray(wlse)))
    live = np.isfinite(np.asarray(wlse))
    assert np.abs(lse.numpy()[live] - np.asarray(wlse)[live]).max() <= 1e-6
    assert np.isneginf(lse.numpy()[1, :3]).all() and not out.numpy()[1, :3].any()


# ---------------------------------------------------------------- striping


def test_stripe_round_trip_and_flops_balance():
    """The port's stripe_sequence is JAX's permutation, unstripe undoes it,
    and on it every (rank, kv-source) block of the causal mask is exactly
    triangular (j <= i for sources up to the rank, j <= i - 1 after), so
    each step's work is equal across ranks to one diagonal, while the
    contiguous layout's totals are ~(n + 1) / 2 apart
    (tests/test_parallel.py:233-279)."""
    n, S = 4, 64
    s_loc = S // n
    x = torch.arange(2 * S * 3).reshape(2, S, 3)
    np.testing.assert_array_equal(stripe_sequence(x, n).numpy(),
                                  np.asarray(j_stripe(jnp.asarray(x.numpy()), n)))
    assert torch.equal(unstripe_sequence(stripe_sequence(x, n), n), x)
    perm = stripe_sequence(torch.arange(S)[None], n)[0].numpy()
    causal = np.tril(np.ones((S, S), bool))
    m_str = causal[np.ix_(perm, perm)]
    tri = np.tril(np.ones((s_loc, s_loc), bool))
    strict = np.tril(np.ones((s_loc, s_loc), bool), k=-1)
    per_step = np.zeros((n, n), int)
    for d in range(n):
        for t in range(n):
            s = (d - t) % n
            blk = m_str[d * s_loc:(d + 1) * s_loc, s * s_loc:(s + 1) * s_loc]
            assert (blk == (tri if s <= d else strict)).all(), (d, s)
            per_step[d, t] = blk.sum()
    assert (per_step.max(0) - per_step.min(0) <= s_loc).all()
    contig = np.array([causal[d * s_loc:(d + 1) * s_loc, :(d + 1) * s_loc].sum()
                       for d in range(n)])
    assert contig.max() / contig.min() > (n + 1) / 2 - 0.1
    assert per_step.sum(1).max() - per_step.sum(1).min() <= n * s_loc
    with pytest.raises(ValueError, match="not divisible"):
        stripe_sequence(x[:, :30], n)


@pytest.mark.parametrize("name", ["lse_merge", "stripe_sequence", "unstripe_sequence"])
def test_axis_keyword_as_jax(name):
    """lse_merge (the package-top export), stripe_sequence and
    unstripe_sequence take JAX's ``axis`` keyword and give JAX's result on
    the same numpy inputs, exactly.  lse_merge merges along axis 1
    partials of which one a row is live (the others -inf; one row all
    -inf), so that both sides' arithmetic is exact; its rounding on mixed
    partials is held by tests/test_torch_ops.py."""
    rng = np.random.default_rng(23)
    if name == "lse_merge":
        outs = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
        lses = np.full((2, 3, 5), -np.inf, np.float32)
        for b in range(2):
            for r in range(5):
                lses[b, rng.integers(0, 3), r] = rng.standard_normal()
        lses[1, :, 4] = -np.inf
        want = j_lse_merge(jnp.asarray(outs), jnp.asarray(lses), axis=1)
        got = flash_attn_tpu_torch.lse_merge(torch.from_numpy(outs), torch.from_numpy(lses),
                                             axis=1)
    else:
        x = rng.standard_normal((2, 3, 24, 4)).astype(np.float32)
        want = (getattr(jring, name)(jnp.asarray(x), 4, axis=2),)
        got = (getattr(ring, name)(torch.from_numpy(x), 4, axis=2),)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------- the ring


def _ring_fn(mesh4, layout, **kw):
    fn = make_ring_attention(mesh4, layout=layout, **kw)
    if layout == "contiguous":
        return fn
    return lambda q, k, v: unstripe_sequence(fn(*(stripe_sequence(x, N) for x in (q, k, v))), N)


@pytest.mark.parametrize("layout,causal,b", [("contiguous", True, 1), ("contiguous", False, 1),
                                             ("striped", True, 1), ("striped", False, 1),
                                             ("contiguous", True, 2)])
def test_ring_matches_reference(mesh4, layout, causal, b):
    """Forward and gradients with GQA (H=4 over Hk=2) against JAX's
    mha_reference and jax.grad of it; B=2 makes every shard a copy."""
    q, k, v, dout = arrays(10, b=b)
    out, grads = port_grads(_ring_fn(mesh4, layout, causal=causal), q, k, v, dout)
    assert err(out, j_mha(q, k, v, causal=causal)) <= OUT_TOL
    want = jax_grads(lambda *a: j_mha(*a, causal=causal), q, k, v, dout)
    for g, w in zip(grads, want):
        assert err(g, w) <= GRAD_TOL


def test_ring_dropout_matches_jax_ring(mesh4, jmesh4):
    """Dropout 0.25, causal, GQA: the port's ring equals JAX's ring (run in
    interpret mode) forward and through jax.grad, so the per-step seeds
    replay JAX's masks in both passes; the port's backward repeats bit for
    bit and differs from the one without dropout."""
    q, k, v, dout = arrays(11)
    out, grads = port_grads(make_ring_attention(mesh4, causal=True, dropout_rate=0.25),
                            q, k, v, dout)
    j_fn = j_make_ring(jmesh4, causal=True, dropout_rate=0.25, interpret=True)
    assert err(out, j_fn(q, k, v)) <= OUT_TOL
    for g, w in zip(grads, jax_grads(j_fn, q, k, v, dout)):
        assert err(g, w) <= GRAD_TOL
    _, again = port_grads(make_ring_attention(mesh4, causal=True, dropout_rate=0.25),
                          q, k, v, dout)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    _, plain = port_grads(make_ring_attention(mesh4, causal=True), q, k, v, dout)
    assert err(grads[0], plain[0].numpy()) > 1e-3


@pytest.mark.parametrize("layout", ["contiguous", "striped"])
def test_ring_bias(mesh4, layout):
    """A [B, H, S, S] bias (-inf entries included), causal: the forward
    against mha_reference with the mask, and gradients of q, k, v through
    a bias that needs none against jax.grad with the bias held fixed."""
    q, k, v, dout = arrays(12)
    rng = np.random.default_rng(13)
    bias = (rng.standard_normal((1, 4, 256, 256)) * 2).astype(np.float32)
    bias[:, :, 5, 100:] = -np.inf
    fn = make_ring_attention(mesh4, causal=True, layout=layout, has_bias=True)
    tb = T(bias)
    if layout == "striped":
        call = lambda q_, k_, v_: unstripe_sequence(fn(  # noqa: E731
            *(stripe_sequence(x, N) for x in (q_, k_, v_)),
            stripe_sequence(stripe_sequence(tb, N, axis=2), N, axis=3)), N)
    else:
        call = lambda q_, k_, v_: fn(q_, k_, v_, tb)  # noqa: E731
    out, grads = port_grads(call, q, k, v, dout)
    ref = lambda *a: j_mha(*a, causal=True, mask=bias)  # noqa: E731
    assert err(out, ref(q, k, v)) <= OUT_TOL
    for g, w in zip(grads, jax_grads(ref, q, k, v, dout)):
        assert err(g, w) <= GRAD_TOL


def test_ring_softcap(mesh4):
    """logit_softcap 5 (where tanh bends), causal, forward and gradients
    against mha_reference with the cap."""
    q, k, v, dout = arrays(14)
    out, grads = port_grads(make_ring_attention(mesh4, causal=True, logit_softcap=5.0),
                            q * 3, k, v, dout)
    ref = lambda *a: j_mha(*a, causal=True, logit_softcap=5.0)  # noqa: E731
    assert err(out, ref(q * 3, k, v)) <= OUT_TOL
    for g, w in zip(grads, jax_grads(ref, q * 3, k, v, dout)):
        assert err(g, w) <= GRAD_TOL


def test_ring_refusals_before_any_launch(mesh4, monkeypatch):
    """A window with the striped layout (as in JAX), without causal or with
    a bias or dropout, and a softcap with a bias or dropout raise before
    the ring calls its first kernel; a bad layout is a ValueError.  A bias
    that requires grad runs (tests/test_torch_fa2_surface.py).  The
    contiguous causal window, once refused, runs: its out matches
    mha_reference with the window at OUT_TOL (tests/test_torch_window_train.py
    holds it against JAX's ring, with gradients)."""
    q, k, v, _ = (T(x) for x in arrays(15, s=64))
    jq, jk, jv, _ = arrays(15, s=64)
    got = make_ring_attention(mesh4, window=(16, 0), causal=True)(q, k, v)
    assert err(got, j_mha(jq, jk, jv, causal=True, window=(16, 0))) <= OUT_TOL
    calls = []
    monkeypatch.setattr(ring, "flash_fwd", lambda *a, **kw: calls.append(1))
    bias = torch.zeros((1, 4, 64, 64), requires_grad=True)
    cases = [
        (NotImplementedError, dict(window=(16, 0)), ()),
        (NotImplementedError, dict(window=(16, 0), causal=True, layout="striped"), ()),
        (NotImplementedError, dict(window=(16, 0), causal=True, dropout_rate=0.1), ()),
        (NotImplementedError, dict(has_bias=True, logit_softcap=5.0), (bias.detach(),)),
        (NotImplementedError, dict(dropout_rate=0.1, logit_softcap=5.0), ()),
        (ValueError, dict(layout="zigzag"), ()),
    ]
    for exc, kw, extra in cases:
        with pytest.raises(exc):
            make_ring_attention(mesh4, **kw)(q, k, v, *extra)
    assert not calls


# ---------------------------------------------------------------- the rdma ring (K11)


@pytest.mark.parametrize("causal", [False, True])
def test_rdma_ring_plain_matches_jax(mesh4, jmesh4, causal):
    """K11's plain version through make_rdma_ring_attention against JAX's
    make_rdma_ring_attention(block_q=64) in interpret mode, at
    tests/test_parallel.py:459-474's shape and tolerance."""
    q, k, v, _ = arrays(40)
    got = make_rdma_ring_attention(mesh4, causal=causal, block_q=64)(T(q), T(k), T(v))
    want = j_make_rdma(jmesh4, causal=causal, block_q=64, interpret=True)(q, k, v)
    assert err(got, want) <= RDMA_TOL
    assert err(got, j_mha(q, k, v, causal=causal)) <= OUT_TOL


def test_rdma_ring_plain_large_logits(mesh4):
    """K11's plain version at the card check's large-logit case (q x 8:
    logits reach 42.6 here; one TF32 pass would miss it, three hold it)
    through make_rdma_ring_attention against JAX's jnp oracle
    mha_reference, both fp32, at OUT_TOL (1.0e-5 measured)."""
    q, k, v, _ = arrays(42)
    q = q * 8
    got = make_rdma_ring_attention(mesh4, causal=True, block_q=64)(T(q), T(k), T(v))
    assert err(got, j_mha(q, k, v, causal=True)) <= OUT_TOL


def test_rdma_ring_block_q_and_bf16(mesh4):
    """S_loc % block_q raises as JAX's does; bf16 shards come back in bf16
    within a bf16 rounding of the fp32 result; the plain version's ranks
    agree with the ring over K4 (the same function)."""
    q, k, v, _ = arrays(41, s=320)
    with pytest.raises(ValueError, match="not divisible by block_q"):
        make_rdma_ring_attention(mesh4, block_q=64)(T(q), T(k), T(v))
    f32 = make_rdma_ring_attention(mesh4, causal=True, block_q=16)(T(q), T(k), T(v))
    bf = make_rdma_ring_attention(mesh4, causal=True, block_q=16)(
        *(T(x).bfloat16() for x in (q, k, v)))
    assert bf.dtype == torch.bfloat16
    assert err(bf.float(), f32.numpy()) <= 2e-2
    assert err(f32, make_ring_attention(mesh4, causal=True)(T(q), T(k), T(v)).numpy()) <= OUT_TOL
    qs = mesh.shard(mesh4, T(q), (None, "sp", None, None))
    ks = mesh.shard(mesh4, T(k), (None, "sp", None, None))
    outs = ring_attn_plain(qs, ks, ks, False, 0.125)
    assert [tuple(o.shape) for o in outs] == [(1, 80, 4, 64)] * N


# ---------------------------------------------------------------- Ulysses


@pytest.mark.parametrize("hk", [4, 2])
def test_ulysses_matches_reference(mesh4, hk):
    """H=8 over Hk=4 (one KV head a rank) and Hk=2 < 4 ranks (KV heads
    repeated), causal: forward and gradients against mha_reference and
    jax.grad of it."""
    q, k, v, dout = arrays(30 + hk, h=8, hk=hk)
    out, grads = port_grads(make_ulysses_attention(mesh4, causal=True), q, k, v, dout)
    ref = lambda *a: j_mha(*a, causal=True)  # noqa: E731
    assert err(out, ref(q, k, v)) <= OUT_TOL
    for g, w in zip(grads, jax_grads(ref, q, k, v, dout)):
        assert err(g, w) <= GRAD_TOL


def test_ulysses_dropout_matches_jax(mesh4, jmesh4):
    """Dropout 0.25 with Hk=2 < 4 ranks: the port's Ulysses equals JAX's
    (interpret mode), so the rank-offset seeds give JAX's masks; heads not
    divisible by the ranks raise."""
    q, k, v, _ = arrays(33, h=8, hk=2)
    got = make_ulysses_attention(mesh4, causal=True, dropout_rate=0.25)(T(q), T(k), T(v))
    want = j_make_ulysses(jmesh4, causal=True, dropout_rate=0.25, interpret=True)(q, k, v)
    assert err(got, want) <= OUT_TOL
    q6, k6, v6, _ = arrays(34, s=64, h=6, hk=6)
    with pytest.raises(ValueError, match="not divisible by axis size"):
        make_ulysses_attention(mesh4)(T(q6), T(k6), T(v6))

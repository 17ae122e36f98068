"""The port's sequence-sharded decode, tensor, pipeline and expert
parallelism and multi-process bring-up against the JAX package on the
CPU.

The port runs its single-process meshes over CPU ranks
(``parallel/mesh.py``); JAX runs its ``shard_map`` and ``jit`` forms on the
conftest's 8 virtual CPU devices.  Inputs come from numpy seeds (or JAX's
params through the bridge) and reach both sides through numpy.
Tolerances are JAX's own tests' (tests/test_parallel.py, test_llama.py,
test_quant.py, test_utils.py): the sharded decode 2e-4, GPT-2 under TP
1e-3, quantized Llama under TP 2e-3, the pipeline 1e-5 and the MoE forms
1e-4; the engines' greedy tokens exactly.
"""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from flash_attn_tpu.engine.engine import InferenceEngine as JEngine
from flash_attn_tpu.models import gpt2 as jgpt2
from flash_attn_tpu.models import llama as jllama
from flash_attn_tpu.parallel import mesh as jmesh
from flash_attn_tpu.parallel import moe as jmoe
from flash_attn_tpu.parallel import tp as jtp
from flash_attn_tpu.parallel.pp import pipeline_spmd as j_pipeline
from flash_attn_tpu.parallel.sharded_decode import make_sharded_decode as j_make_sharded
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.engine.engine import InferenceEngine, SpecConfig
from flash_attn_tpu_torch.models import gpt2, llama
from flash_attn_tpu_torch.ops import decode as dec
from flash_attn_tpu_torch.ops.quant import quantize_fp8, quantize_int8
from flash_attn_tpu_torch.parallel import mesh, moe, pp, tp
from flash_attn_tpu_torch.parallel.sharded_decode import (
    make_sharded_decode,
    merge_shards,
    shard_lengths,
)
from flash_attn_tpu_torch.utils import distributed
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
N = 4
GLENS = [300, 512]


@pytest.fixture(scope="module")
def mesh4():
    return mesh.host_local_mesh(N, axis="sp")


@pytest.fixture(scope="module")
def jmesh4():
    return jmesh.make_mesh(jmesh.MeshConfig(sp=N))


def T(x):
    return bridge.to_torch(x, "cpu")


def from_jax(tree):
    return bridge.params_from_jax(jax.device_get(tree), device="cpu")


def err(got, want) -> float:
    g = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.abs(g - np.asarray(want, np.float32)).max())


def _decode_inputs(kv, layout, seed=5, B=2, S=512, H=4, Hk=2, D=64):
    """q, k, v (fp32 or quantized) and scales in ``layout`` as numpy:
    scales [B, S, Hk, 1] (bshd) / [B, Hk, S, 1] (bhsd), JAX's "kv" layout."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D), np.float32)
    shape = (B, S, Hk, D) if layout == "bshd" else (B, Hk, S, D)
    k = rng.standard_normal(shape, np.float32)
    v = rng.standard_normal(shape, np.float32)
    if kv == "none":
        return q, k, v, None, None
    quant = quantize_int8 if kv == "int8" else quantize_fp8
    (kq, ks), (vq, vs) = quant(torch.tensor(k)), quant(torch.tensor(v))
    to_np = (lambda t: t.numpy()) if kv == "int8" else (
        lambda t: t.view(torch.uint8).numpy().view(jnp.float8_e4m3fn))
    return q, to_np(kq), to_np(vq), ks.numpy(), vs.numpy()


@pytest.mark.parametrize("kv,layout", [("none", "bshd"), ("none", "bhsd"), ("int8", "bhsd"),
                                       ("fp8", "bhsd"), ("int8", "bshd")])
def test_sharded_decode_matches_jax(mesh4, jmesh4, kv, layout):
    """make_sharded_decode over 4 shards of 128 at global lengths [300,
    512] (shards 3 of the first sequence empty) against JAX's, 2e-4 on
    O(1) outputs, and against the port's single-device flash_decode."""
    q, k, v, ks, vs = _decode_inputs(kv, layout)
    lens = np.asarray(shard_lengths(torch.tensor(GLENS, dtype=torch.int32), N, 512 // N))
    assert lens[:, 0].tolist() == [128, 128, 44, 0]
    quantized = kv != "none"
    jfn = jax.jit(j_make_sharded(jmesh4, interpret=True, quantized=quantized, kv_layout=layout))
    fn = make_sharded_decode(mesh4, quantized=quantized, kv_layout=layout)
    if quantized:
        want = jfn(q, k, v, ks, vs, jnp.asarray(lens))
        # the port's BHSD scales are [B, Hk, S]
        tks, tvs = (T(ks), T(vs)) if layout == "bshd" else (T(ks[..., 0]), T(vs[..., 0]))
        got = fn(T(q), T(k), T(v), tks, tvs, T(lens))
        single = dec.flash_decode(T(q), T(k), T(v), k_scale=tks, v_scale=tvs,
                                  kv_length=torch.tensor(GLENS, dtype=torch.int32),
                                  kv_layout=layout, softmax_mode="online")
    else:
        want = jfn(q, k, v, jnp.asarray(lens))
        got = fn(T(q), T(k), T(v), T(lens))
        single = dec.flash_decode(T(q), T(k), T(v), kv_length=torch.tensor(
            GLENS, dtype=torch.int32), kv_layout=layout)
    assert got.shape == (2, 4, 64) and got.dtype == torch.float32
    assert err(got, want) < 2e-4
    assert err(got, single) < 2e-4


def test_shard_views_partials_and_empty_shards(mesh4):
    """Each rank's shard is a view of the one buffer (no copy); K1's
    partials on a view equal those on a contiguous copy; a shard of
    length 0 gives out 0 and lse -1e30, which weighs nothing in the merge;
    and _view_cap reads the buffer's capacity off a view's strides and
    refuses what is no run of positions."""
    q, k, v, ks, vs = _decode_inputs("fp8", "bhsd", seed=9)
    k, ks = T(k), T(ks[..., 0])
    views = mesh.shard_views(mesh4, k, (None, None, "sp", None))
    assert all(x.data_ptr() == k.data_ptr() + r * 128 * 64 for r, x in enumerate(views))
    assert [dec._view_cap(x, "bhsd") for x in views] == [512] * N
    sviews = mesh.shard_views(mesh4, ks, (None, None, "sp"))
    assert dec._view_cap(sviews[2], "bhsd") == 512
    assert dec._view_cap(k.transpose(2, 3), "bhsd") is None
    assert dec._view_cap(k[:, :, ::2], "bhsd") is None
    bshd = k.transpose(1, 2).contiguous()
    assert dec._view_cap(bshd[:, 128:256], "bshd") == 512
    lens = torch.tensor([44, 0], dtype=torch.int32)
    qt = T(q)
    o1, l1 = dec.flash_decode_partials(qt, views[2], views[2], kv_length=lens, k_scale=sviews[2],
                                       v_scale=sviews[2], kv_layout="bhsd")
    o2, l2 = dec.flash_decode_partials(qt, views[2].contiguous(), views[2].contiguous(),
                                       kv_length=lens, k_scale=sviews[2].contiguous(),
                                       v_scale=sviews[2].contiguous(), kv_layout="bhsd")
    assert torch.equal(o1, o2) and torch.equal(l1, l2)
    assert torch.all(o1[:, 1] == 0) and torch.all(l1[:, 1] == -1e30)
    # a merge over one live shard and dead ones is the live shard's output
    o3, l3 = dec.flash_decode_partials(qt, views[0], views[0], kv_length=lens,
                                       k_scale=sviews[0], v_scale=sviews[0], kv_layout="bhsd")
    merged = merge_shards(torch.cat([o3, o1]), torch.cat([l3, l1]), torch.float32)
    assert torch.allclose(merged[1], o3[0, 1], atol=1e-6)
    assert torch.all(merge_shards(o1, l1, torch.float32)[1] == 0)


def _jax_run_engine(jp, mesh_, kv_mode):
    eng = JEngine(jp, jllama.make_adapter(jllama.LLAMA_TINY, interpret=True, mesh=mesh_),
                  max_batch=2, capacity=64, cache_dtype=jnp.float32, mesh=mesh_,
                  kv_mode=kv_mode)
    reqs = [eng.submit(p, max_tokens=6) for p in ([1, 2, 3, 4, 5], [7, 8, 9])]
    eng.run()
    return [list(r.generated) for r in reqs]


def _run_engine(params, mesh_, kv_mode):
    eng = InferenceEngine(params, llama.make_adapter(llama.LLAMA_TINY, mesh=mesh_),
                          max_batch=2, capacity=64, cache_dtype=torch.float32, mesh=mesh_,
                          kv_mode=kv_mode, device="cpu")
    reqs = [eng.submit(p, max_tokens=6) for p in ([1, 2, 3, 4, 5], [7, 8, 9])]
    eng.run()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs]


@pytest.mark.parametrize("kv_mode", ["none", "fp8"])
def test_engine_sharded_kv_matches_jax(mesh4, kv_mode):
    """JAX's test_engine_sharded_kv_matches_unsharded: the mesh engine at
    LLAMA_TINY over 4 ranks, token for token against JAX's mesh engine
    (float cache) and against the port's unsharded engine."""
    jp = jllama.init_params(jllama.LLAMA_TINY, jax.random.PRNGKey(0))
    params = from_jax(jp)
    got = _run_engine(params, mesh4, kv_mode)
    assert got == _run_engine(params, None, kv_mode)
    if kv_mode == "none":
        jm = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("sp",))
        assert got == _jax_run_engine(jp, jm, kv_mode)


def test_engine_mesh_chunked_prefill_and_bursts(mesh4):
    """The mesh engine with chunked prefill (a 69-token prompt in chunks of
    16, across three shards of 32) and decode bursts of 3: the tokens of
    the unsharded engine (fp8 cache)."""
    cfg = llama.LLAMA_TINY
    params = llama.init_params(cfg, 0, device="cpu")

    def run(mesh_, burst):
        eng = InferenceEngine(params, llama.make_adapter(cfg, mesh=mesh_), max_batch=2,
                              capacity=128, kv_mode="fp8", device="cpu", mesh=mesh_,
                              prefill_chunk_size=16, decode_burst=burst)
        reqs = [eng.submit(list(range(1, 70)), max_tokens=8), eng.submit([5, 6, 7], max_tokens=8)]
        eng.run()
        return [list(r.generated) for r in reqs]

    want = run(None, 1)
    assert run(mesh4, 1) == want
    assert run(mesh4, 3) == want


def test_engine_mesh_refusals(mesh4, monkeypatch):
    """The capacity must divide by the axis's ranks (JAX's message),
    draft-model speculation refuses a mesh (JAX's ValueError), and a mesh
    whose ranks sit on more than one device raises NotImplementedError;
    each before any launch."""
    def launched(*a, **k):
        raise AssertionError("a kernel was launched")

    monkeypatch.setattr(dec, "flash_decode_cuda", launched)
    params = llama.init_params(llama.LLAMA_TINY, 0, device="cpu")
    adapter = llama.make_adapter(llama.LLAMA_TINY, mesh=mesh4)
    with pytest.raises(ValueError, match="capacity 66 not divisible by mesh axis sp=4"):
        InferenceEngine(params, adapter, capacity=66, mesh=mesh4, device="cpu")
    with pytest.raises(ValueError, match="does not compose with sharded KV"):
        InferenceEngine(params, adapter, capacity=64, mesh=mesh4, device="cpu",
                        spec=SpecConfig(draft_params=params, draft_adapter=adapter))
    split = mesh.make_mesh(mesh.MeshConfig(sp=2), ["cpu", "cuda:0"])
    with pytest.raises(NotImplementedError, match="mesh across devices"):
        InferenceEngine(params, llama.make_adapter(llama.LLAMA_TINY, mesh=split), capacity=64,
                        mesh=split, device="cpu")
    cache = llama.make_cache(llama.LLAMA_TINY, 2, 64, device="cpu")
    with pytest.raises(NotImplementedError, match="mesh across devices"):
        llama.decode_step_sharded(params, torch.tensor([1, 2]), llama.LLAMA_TINY, cache, split)


def test_decode_step_sharded_matches_decode_step(mesh4):
    """decode_step_sharded and decode_step from the same fp8 cache state
    (lengths 40 and 0: a sequence across a shard boundary and an idle
    slot), 2e-4 of O(1) logits."""
    cfg = llama.LLAMA_TINY
    params = llama.init_params(cfg, 3, device="cpu")
    cache = llama.make_cache(cfg, 2, 64, mode="fp8", device="cpu")
    toks = torch.arange(40)[None] % cfg.vocab_size
    _, kvs = llama.prefill_with_kv(params, toks, torch.arange(40)[None], cfg)
    for i, (k, v) in enumerate(kvs):
        cache.insert_prompt(i, 0, k[0], v[0])
    cache.set_length(0, 40)
    tok = torch.tensor([7, 9])
    got, _ = llama.decode_step_sharded(params, tok, cfg, cache, mesh4)
    cache.length -= 1
    want, _ = llama.decode_step(params, tok, cfg, cache)
    assert err(got, want) < 2e-4


def test_tp_sharded_gpt2_forward(jmesh4):
    """JAX's test_tp_sharded_gpt2_forward: GPT-2's forward on params
    sharded by gpt2_param_specs over 4 ranks against JAX's sharded
    forward, 1e-3."""
    jm = jmesh.make_mesh(jmesh.MeshConfig(tp=N))
    cfg = jgpt2.GPT2_TINY
    jp = jgpt2.init_params(cfg, jax.random.PRNGKey(2))
    tokens = jax.random.randint(jax.random.PRNGKey(3), (2, 16), 0, cfg.vocab_size)
    want = jax.jit(lambda p, t: jgpt2.forward(p, t, cfg, interpret=True))(
        jtp.shard_params(jp, jm, jtp.gpt2_param_specs("tp")), tokens)
    tm = mesh.host_local_mesh(N)
    sharded = tp.shard_params(from_jax(jp), tm, tp.gpt2_param_specs("tp"))
    assert isinstance(sharded["wte"], tp.ShardedWeight) and sharded["wte"].kind == "vocab"
    assert sharded["blocks"][0]["attn"]["qkv"]["b"].kind == "col"
    got = gpt2.forward(sharded, T(tokens), gpt2.GPT2_TINY)
    assert err(got, want) < 1e-3


def jax_quantize(params, mode, group_size):
    """JAX's quantize_weights, jitted (its int4 clip search is slow eagerly)."""
    return jax.jit(lambda p: jllama.quantize_weights(p, mode=mode, group_size=group_size))(params)


SMALL70 = dict(vocab_size=512, hidden=256, intermediate=1024, num_layers=2, num_heads=8,
               num_kv_heads=1, head_dim=32, max_position=128, rope_theta=500000.0,
               dtype="float32")


@pytest.mark.parametrize("group_size,n", [(64, 4), (128, 2)])
def test_shard_params_quant_70b_structure(group_size, n):
    """JAX's test_llama_70b_structure_tp_int4_fp8_decode: a 70B-structure
    model (GQA 8:1) with int4 weights and an fp8 cache under TP; the
    prefill and one decode step's logits against JAX's unsharded
    quantized model, 2e-3."""
    jcfg, cfg = jllama.LlamaConfig(**SMALL70), llama.LlamaConfig(**SMALL70)
    jq = jax_quantize(jllama.init_params(jcfg, jax.random.PRNGKey(50)), "int4", group_size)
    B, S = 2, 16
    toks = jax.random.randint(jax.random.PRNGKey(51), (B, S), 0, cfg.vocab_size)
    tok_next = jax.random.randint(jax.random.PRNGKey(52), (B,), 0, cfg.vocab_size)

    @jax.jit
    def jrun(p):
        cache = jllama.make_cache(jcfg, B, 64, mode="fp8")
        logits, kvs = jllama.prefill_with_kv(p, toks, jnp.arange(S)[None], jcfg,
                                             interpret=True)
        for i, (k, v) in enumerate(kvs):
            cache = cache.append(i, k, v)
        step, _ = jllama.decode_step(p, tok_next, jcfg, cache.advance(S), interpret=True)
        return logits, step

    want_l, want_s = jrun(jq)
    sharded = tp.shard_params_quant(from_jax(jq), mesh.host_local_mesh(n))
    assert sharded["blocks"][0]["w_down"].kind == "row"
    assert len(sharded["blocks"][0]["wq"].parts) == n
    cache = llama.make_cache(cfg, B, 64, mode="fp8", device="cpu")
    logits, kvs = llama.prefill_with_kv(sharded, T(toks), torch.arange(S)[None], cfg)
    for i, (k, v) in enumerate(kvs):
        cache.append(i, k, v)
    cache.advance(S)
    step, _ = llama.decode_step(sharded, T(tok_next), cfg, cache)
    assert err(logits, want_l) < 2e-3
    assert err(step, want_s) < 2e-3


def test_shard_params_quant_w4a8_and_refusals():
    """test_quant.py's TP case: W4A8 at tp=2 against JAX's forward, 2e-3
    (each token's activations quantized once over the whole row, then the
    int8 row split); a fused tree raises JAX's ValueError; a row-parallel
    int4 split off the group boundaries raises."""
    cfg = jllama.LLAMA_TINY
    jq = jax_quantize(jllama.init_params(cfg, jax.random.PRNGKey(0)), "w4a8", 32)
    toks = jnp.asarray([[1, 2, 3, 4, 5, 6, 7, 8]])
    want = jax.jit(lambda p: jllama.forward(p, toks, cfg, interpret=True))(jq)
    params = from_jax(jq)
    sharded = tp.shard_params_quant(params, mesh.host_local_mesh(2))
    got = llama.forward(sharded, T(toks), llama.LLAMA_TINY)
    assert err(got, want) < 2e-3
    with pytest.raises(ValueError, match="fused projection"):
        tp.shard_params_quant(llama.fuse_projections(params), mesh.host_local_mesh(2))
    with pytest.raises(ValueError, match="group boundaries"):
        tp.shard_params_quant(params, mesh.host_local_mesh(8))


def test_bridge_shards_like_jax():
    """Params converted from JAX (int4 at g=128, the planes layout) shard
    with the port's shard_params_quant to JAX's shards of the same leaves."""
    jcfg = jllama.LlamaConfig(**SMALL70)
    jq = jax_quantize(jllama.init_params(jcfg, jax.random.PRNGKey(50)), "int4", 128)
    jm = jmesh.make_mesh(jmesh.MeshConfig(tp=2))
    js = jtp.shard_params_quant(jq, jm)
    ts = tp.shard_params_quant(from_jax(jq), mesh.host_local_mesh(2))
    for name in ("wq", "w_down"):
        jw, tw = js["blocks"][0][name], ts["blocks"][0][name]
        for r, part in enumerate(tw.parts):
            dev = jm.devices.flat[r]
            shard = {f: next(s.data for s in getattr(jw, f).addressable_shards
                             if s.device == dev) for f in ("packed", "scales")}
            conv = from_jax(type(jw)(shard["packed"], shard["scales"], jw.group_size,
                                     tuple(part.shape), jw.layout))
            assert torch.equal(conv.packed, part.packed) and torch.equal(conv.scales,
                                                                        part.scales)


def test_pipeline_spmd_and_split_layers():
    """JAX's test_pipeline_spmd_ring and test_split_layers: 4 stages of
    h * w_s over 6 microbatches against JAX's shard_map pipeline and the
    sequential product, 1e-5."""
    assert [len(s) for s in pp.split_layers(list(range(7)), 3)] == [3, 3, 1]
    ws = np.asarray([1.0, 2.0, 0.5, 3.0], np.float32).reshape(N, 1, 1)
    x = np.random.default_rng(0).standard_normal((6, 2, 8), np.float32)
    jm = jmesh.make_mesh(jmesh.MeshConfig(sp=N))
    want = jax.shard_map(
        lambda w, xx: j_pipeline(lambda wl, h: h * wl[0], w, xx, axis_name="sp",
                                 num_microbatches=6),
        mesh=jm, in_specs=(P("sp", None, None), P(None, None, None)),
        out_specs=P(None, None, None), check_vma=False)(ws, x)
    got = pp.pipeline_spmd(lambda wl, h: h * wl[0], T(ws), T(x),
                           mesh=mesh.host_local_mesh(N, axis="sp"), axis_name="sp",
                           num_microbatches=6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), x * 3.0, rtol=1e-5)


def _moe_inputs(seed):
    rng = np.random.default_rng(seed)
    T_, H, F, E = 16, 32, 64, 8
    return (rng.standard_normal((T_, H), np.float32), rng.standard_normal((H, E), np.float32),
            0.1 * rng.standard_normal((E, H, F), np.float32),
            0.1 * rng.standard_normal((E, H, F), np.float32),
            0.1 * rng.standard_normal((E, F, H), np.float32))


@pytest.mark.parametrize("form", ["dense", "a2a", "a2a drop"])
def test_moe_ep_matches_jax(form):
    """moe_ffn_ep (dense combine + psum) and moe_ffn_ep_a2a (capacity 32:
    nothing drops; capacity 1: GShard's drops) over 4 ranks against JAX's
    forms and, where nothing drops, the dense oracle, 1e-4."""
    args = _moe_inputs(1)
    jm = jmesh.make_mesh(jmesh.MeshConfig(tp=N))
    tm = mesh.host_local_mesh(N)
    if form == "dense":
        jfn, fn = jax.jit(jmoe.make_moe_ffn(jm, top_k=2)), moe.make_moe_ffn(tm, top_k=2)
    else:
        cap = 32 if form == "a2a" else 1
        jfn = jax.jit(jmoe.make_moe_ffn_a2a(jm, axis_name="tp", top_k=2, capacity=cap))
        fn = moe.make_moe_ffn_a2a(tm, axis_name="tp", top_k=2, capacity=cap)
    want = jfn(*args)
    got = fn(*(T(a) for a in args))
    assert got.shape == (16, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    if form != "a2a drop":
        ref = moe.moe_ffn_reference(*(T(a) for a in args), top_k=2)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_distributed_initialize_and_is_primary():
    """One process: initialize is a no-op with JAX's summary keys and
    is_primary holds; two gloo processes on localhost join one group, each
    seeing its index, the count 2 and both processes' devices."""
    from flash_attn_tpu.utils import distributed as jdist

    got = distributed.initialize()
    assert set(got) == set(jdist._summary())
    assert got["process_count"] == 1 and distributed.is_primary()
    port = _free_port()
    code = textwrap.dedent(f"""
        import json, sys
        from flash_attn_tpu_torch.utils import distributed
        s = distributed.initialize("localhost:{port}", 2, int(sys.argv[1]), backend="gloo",
                                   timeout_s=60)
        print(json.dumps([s, distributed.is_primary()]))
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], stdout=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT) for r in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    import json

    res = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    for r, (s, primary) in enumerate(res):
        assert s == {"process_index": r, "process_count": 2, "local_devices": 1,
                     "global_devices": 2}
        assert primary == (r == 0)

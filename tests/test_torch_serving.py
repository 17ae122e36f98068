"""The port's HTTP front end (serving/server.py) over the port's engine, on
the CPU: JAX's five tests/test_serving.py cases at GPT2_TINY, whose greedy
tokens must equal the JAX engine's on the same (bridged) params; /cancel
freeing its slot; a LoRA bank engine at LLAMA_TINY whose "adapter"
selects the adapter; and a dead engine worker answered with a 500, not a
hang.  Every client call times out within 30 s, and each test leaves the
worker thread alive."""

import contextlib
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import pytest
import torch

from flash_attn_tpu.engine.engine import InferenceEngine as JEngine
from flash_attn_tpu.models import gpt2 as jgpt2
from flash_attn_tpu_torch import bridge
from flash_attn_tpu_torch.engine.engine import InferenceEngine
from flash_attn_tpu_torch.models import gpt2, llama, lora
from flash_attn_tpu_torch.serving import ServingConfig, serve
from flash_attn_tpu_torch.utils.metrics import EngineMetrics

TIMEOUT = 30
# (prompt, max_tokens) of every request the GPT-2 tests send
REQUESTS = [([1, 2, 3, 4], 5), ([7, 8, 9], 4), ([5, 6, 7], 6)] + [
    ([i + 1, i + 2], 3) for i in range(4)]


@contextlib.contextmanager
def _serving(engine):
    """serve(engine) on an ephemeral port (parallel runs never collide);
    at exit the server and the worker are shut down and the worker joined."""
    scfg = ServingConfig(port=0)
    srv, worker = serve(engine, scfg, block=False)
    scfg.port = srv.server_address[1]
    try:
        yield scfg, worker
    finally:
        srv.shutdown()
        srv.server_close()
        worker.stop_flag.set()
        worker.join(timeout=TIMEOUT)
        assert not worker.is_alive()


def _post(port, path, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=TIMEOUT) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def server():
    """The port's GPT2_TINY engine (two slots) behind the server, and the
    JAX engine's greedy tokens for every request, one request a slot."""
    jcfg = jgpt2.GPT2_TINY
    jp = jgpt2.init_params(jcfg, jax.random.PRNGKey(0))
    jeng = JEngine(jp, jgpt2.make_adapter(jcfg, interpret=True), max_batch=1, capacity=64,
                   cache_dtype=jnp.float32)
    jreqs = [jeng.submit(p, max_tokens=n) for p, n in REQUESTS]
    jeng.run()
    want = {tuple(p): r.generated for (p, _), r in zip(REQUESTS, jreqs)}
    tp = bridge.params_from_jax(jax.device_get(jp), device="cpu")
    eng = InferenceEngine(tp, gpt2.make_adapter(gpt2.GPT2_TINY), max_batch=2, capacity=64,
                          cache_dtype=torch.float32, device="cpu")
    with _serving(eng) as (scfg, worker):
        yield scfg, worker, want


@pytest.fixture
def live(server):
    yield server
    worker = server[1]
    assert worker.is_alive(), f"the engine worker died: {worker.error!r}"


def test_generate_matches_greedy(live):
    scfg, _, want = live
    res = _post(scfg.port, "/generate", {"prompt": [1, 2, 3, 4], "max_tokens": 5})
    assert res["tokens"] == want[(1, 2, 3, 4)] and len(res["tokens"]) == 5


def test_async_submit_and_result(live):
    scfg, _, want = live
    uid = _post(scfg.port, "/submit", {"prompt": [7, 8, 9], "max_tokens": 4})["uid"]
    deadline = time.monotonic() + TIMEOUT
    res = _get(scfg.port, f"/result?uid={uid}")
    while not res["done"] and time.monotonic() < deadline:
        time.sleep(0.02)
        res = _get(scfg.port, f"/result?uid={uid}")
    assert res["done"] and res["tokens"] == want[(7, 8, 9)]


def test_concurrent_clients_batched(live):
    scfg, _, want = live
    results = {}

    def client(i):
        prompt = [i + 1, i + 2]
        results[i] = _post(scfg.port, "/generate", {"prompt": prompt, "max_tokens": 3})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert sorted(results) == [0, 1, 2, 3]
    for i, res in results.items():
        assert res["tokens"] == want[(i + 1, i + 2)], i


def test_health_and_errors(live):
    scfg, *_ = live
    h = _get(scfg.port, "/health")
    assert h["ok"] and "decode_tokens_per_s" in h["metrics"]
    for call, code in ((lambda: _post(scfg.port, "/generate", {"nope": 1}), 400),
                       (lambda: _get(scfg.port, "/result?uid=99999"), 404),
                       (lambda: _get(scfg.port, "/result"), 400),
                       (lambda: _post(scfg.port, "/cancel", {"uid": 99999}), 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            call()
        assert e.value.code == code


def test_stream_endpoint_incremental(live):
    """GET /stream delivers ndjson lines whose tokens, joined, equal the
    final /result tokens and the JAX engine's."""
    scfg, _, want = live
    uid = _post(scfg.port, "/submit", {"prompt": [5, 6, 7], "max_tokens": 6})["uid"]
    with urllib.request.urlopen(f"http://127.0.0.1:{scfg.port}/stream?uid={uid}",
                                timeout=TIMEOUT) as r:
        lines = [json.loads(raw) for raw in r]
    assert lines and lines[-1]["done"]
    streamed = [t for ln in lines for t in ln["tokens"]]
    final = _get(scfg.port, f"/result?uid={uid}")
    assert final["done"] and streamed == final["tokens"] == want[(5, 6, 7)]


def test_cancel_frees_its_slot(live):
    """/cancel of a running request (its first tokens out; the worker
    takes the cancel within one run of 8 steps) answers {"cancelled":
    true}; the request ends early and its slot returns to the free list."""
    scfg, worker, _ = live
    uid = _post(scfg.port, "/submit", {"prompt": [11, 12, 13], "max_tokens": 60})["uid"]
    deadline = time.monotonic() + TIMEOUT
    while not _get(scfg.port, f"/result?uid={uid}")["tokens"] and time.monotonic() < deadline:
        time.sleep(0.001)
    assert _post(scfg.port, "/cancel", {"uid": uid}) == {"cancelled": True}
    sched = worker.engine.sched
    while (sched.active or sched.waiting) and time.monotonic() < deadline:
        time.sleep(0.02)
    res = _get(scfg.port, f"/result?uid={uid}")
    assert res["done"] and len(res["tokens"]) < 60
    assert not sched.active and sorted(sched.free_slots) == [0, 1]
    assert _post(scfg.port, "/cancel", {"uid": uid}) == {"cancelled": False}


def test_lora_generate_equals_direct_engine():
    """POST /generate with "adapter" on a LLAMA_TINY engine with a bank of
    two adapters (B != 0) gives the direct engine's tokens for the same
    request; an adapter outside the bank is a 400."""
    cfg = llama.LLAMA_TINY
    tp = llama.init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    adapters = [lora.init_lora(tp, 4, gen, alpha=8.0) for _ in range(2)]
    for a in adapters:
        for ab in a["blocks"]:
            for _, B in ab.values():
                B.normal_(generator=gen).mul_(0.05)
    bank = lora.stack_adapters(adapters)

    def engine():
        return InferenceEngine(tp, llama.make_adapter(cfg), max_batch=2, capacity=64,
                               cache_dtype=torch.float32, device="cpu", lora_bank=bank)

    direct = engine()
    want = [direct.submit([4, 8, 15, 16], max_tokens=5, adapter=a) for a in (1, 0)]
    direct.run()
    assert want[0].generated != want[1].generated
    with _serving(engine()) as (scfg, worker):
        for a, w in zip((1, 0), want):
            res = _post(scfg.port, "/generate",
                        {"prompt": [4, 8, 15, 16], "max_tokens": 5, "adapter": a})
            assert res["tokens"] == w.generated
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(scfg.port, "/generate", {"prompt": [1], "adapter": 2})
        assert e.value.code == 400
        assert worker.is_alive()


class _Request:
    done = False
    generated = []


class _FailingEngine:
    """An engine whose step raises: the worker thread dies on it."""

    device = torch.device("cpu")
    metrics = EngineMetrics()

    class sched:
        has_work = True

    def submit(self, prompt, max_tokens):
        return _Request()

    def run(self, max_steps):
        raise RuntimeError("a failed step")


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_dead_worker_answers_500():
    """A /generate waiting on a worker that died answers 500 with the
    worker's error, and /stream ends, instead of polling forever."""
    with _serving(_FailingEngine()) as (scfg, worker):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(scfg.port, "/generate", {"prompt": [1, 2]})
        assert e.value.code == 500 and "a failed step" in e.value.read().decode()
        assert not worker.is_alive() and isinstance(worker.error, RuntimeError)
        uid = _post(scfg.port, "/submit", {"prompt": [3]})["uid"]
        with urllib.request.urlopen(f"http://127.0.0.1:{scfg.port}/stream?uid={uid}",
                                    timeout=TIMEOUT) as r:
            assert r.read() == b""

"""HTTP serving front end over the continuous-batching engine: port of
flash_attn_tpu/serving/server.py.

A minimal request API (JSON over HTTP, standard library only):

  POST /generate   {"prompt": [ids...], "max_tokens": N, "adapter": i}
                   -> {"tokens": [...], "uid": u}
  POST /submit     same body -> {"uid": u}          (async)
  GET  /result?uid=u -> {"done": bool, "tokens": [...]}
  GET  /stream?uid=u -> ndjson lines {"tokens": [new...], "done": bool}
                        (incremental tokens as they are generated)
  POST /cancel     {"uid": u} -> {"cancelled": bool}
  GET  /health     -> {"ok": true, "metrics": {...}}

"adapter" selects a LoRA adapter of the engine's ``lora_bank``
(multi-adapter serving); it is ignored without one, and one outside the
bank is a 400.

Design: one worker thread owns the engine and the card.  It enters the
engine's device before its first step (PyTorch's current device and
current stream are per thread), so the engine's CUDA graphs are captured
and replayed on that thread.  HTTP handlers only enqueue requests and
cancellations and read results (host lists) under a lock; they never
touch a tensor.  The worker batches whatever is queued (continuous
batching), so concurrent clients share decode steps.  A handler that
waits on the worker answers 500 once the worker has stopped (shut down or
failed) instead of polling forever.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch


@dataclass
class ServingConfig:
    host: str = "127.0.0.1"
    port: int = 8477
    poll_interval_s: float = 0.005
    default_max_tokens: int = 64


class WorkerStopped(RuntimeError):
    """The engine worker is no longer running."""


@dataclass
class _CancelAsk:
    req: object
    done: threading.Event = field(default_factory=threading.Event)
    result: bool = False


class _EngineWorker(threading.Thread):
    """Single thread that owns the engine: drains the submit and cancel
    queues, steps the engine while work exists, idles otherwise."""

    def __init__(self, engine, poll_interval_s: float):
        super().__init__(daemon=True)
        self.engine = engine
        self.poll = poll_interval_s
        self.lock = threading.Lock()
        self.pending = []  # (uid, prompt, max_tokens, adapter)
        self.cancels: list[_CancelAsk] = []
        self.results = {}  # uid -> Request
        self.stop_flag = threading.Event()
        self.error: BaseException | None = None
        self._uid = 0

    def submit(self, prompt, max_tokens, adapter=0) -> int:
        with self.lock:
            self._uid += 1
            uid = self._uid
            # register the uid at once: a client may poll /result before
            # the worker drains the queue (submitted but not yet admitted is
            # "not done", not "unknown")
            self.results[uid] = None
            self.pending.append((uid, prompt, max_tokens, adapter))
        return uid

    def result(self, uid):
        with self.lock:
            if uid not in self.results:
                return None
            req = self.results[uid]
        if req is None:
            return {"done": False, "tokens": []}
        return {"done": req.done, "tokens": list(req.generated)}

    def cancel(self, uid):
        """True if newly cancelled, None for an unknown uid.  The engine
        cancels on the worker thread, which alone changes its state."""
        with self.lock:
            if uid not in self.results:
                return None
            req = self.results[uid]
            if req is None:
                # not yet drained into the engine: drop it from pending
                self.pending = [p for p in self.pending if p[0] != uid]
                self.results[uid] = _CancelledStub()
                return True
            ask = _CancelAsk(req)
            self.cancels.append(ask)
        while not ask.done.wait(self.poll):
            self.check_alive()
        return ask.result

    def check_alive(self):
        if not self.is_alive():
            raise WorkerStopped(f"the engine worker stopped: {self.error!r}")

    def run(self):
        dev = self.engine.device
        try:
            with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                self._loop()
        except BaseException as e:
            self.error = e
            raise

    def _loop(self):
        while not self.stop_flag.is_set():
            with self.lock:
                new, self.pending = self.pending, []
                cancels, self.cancels = self.cancels, []
            for uid, prompt, max_tokens, adapter in new:
                if adapter:
                    req = self.engine.submit(prompt, max_tokens=max_tokens, adapter=adapter)
                else:
                    req = self.engine.submit(prompt, max_tokens=max_tokens)
                with self.lock:
                    self.results[uid] = req
            for ask in cancels:
                ask.result = self.engine.cancel(ask.req)
                ask.done.set()
            if self.engine.sched.has_work:
                # a bounded run, so fresh submits join the batch promptly
                self.engine.run(max_steps=8)
            else:
                time.sleep(self.poll)


class _CancelledStub:
    done = True
    generated = ()


def _make_handler(worker: _EngineWorker, cfg: ServingConfig):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def _uid(self):
            try:
                return int(parse_qs(urlparse(self.path).query)["uid"][0])
            except (KeyError, ValueError):
                self._json(400, {"error": "uid required"})
                return None

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/health":
                self._json(200, {"ok": True, "metrics": worker.engine.metrics.snapshot()})
            elif path in ("/result", "/stream"):
                uid = self._uid()
                if uid is None:
                    return
                res = worker.result(uid)
                if res is None:
                    self._json(404, {"error": f"unknown uid {uid}"})
                elif path == "/result":
                    self._json(200, res)
                else:
                    self._stream(uid)
            else:
                self._json(404, {"error": "not found"})

        def _stream(self, uid):
            # incremental ndjson, one line per batch of new tokens; HTTP/1.0
            # semantics (no Content-Length, stream until close)
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            sent = 0
            while True:
                res = worker.result(uid)
                toks = res["tokens"]
                if len(toks) > sent or res["done"]:
                    line = json.dumps({"tokens": toks[sent:], "done": res["done"]})
                    try:
                        self.wfile.write(line.encode() + b"\n")
                        self.wfile.flush()
                    except BrokenPipeError:
                        return  # the client went away; the engine finishes anyway
                    sent = len(toks)
                    if res["done"]:
                        return
                if not worker.is_alive():
                    return  # the stream ends without a done line
                time.sleep(cfg.poll_interval_s)

        def do_POST(self):
            path = urlparse(self.path).path
            try:
                if path == "/cancel":
                    self._cancel()
                elif path in ("/submit", "/generate"):
                    self._submit(path)
                else:
                    self._json(404, {"error": "not found"})
            except WorkerStopped as e:
                self._json(500, {"error": str(e)})

        def _cancel(self):
            try:
                uid = int(self._read_body()["uid"])
            except (KeyError, ValueError, TypeError, json.JSONDecodeError):
                self._json(400, {"error": "uid required"})
                return
            res = worker.cancel(uid)
            if res is None:
                self._json(404, {"error": f"unknown uid {uid}"})
            else:
                self._json(200, {"cancelled": bool(res)})

        def _submit(self, path):
            try:
                body = self._read_body()
                prompt = [int(t) for t in body["prompt"]]
                max_tokens = int(body.get("max_tokens", cfg.default_max_tokens))
                adapter = int(body.get("adapter", 0))
            except (KeyError, ValueError, TypeError, json.JSONDecodeError):
                self._json(400, {"error": "body must be JSON with 'prompt'"})
                return
            n = getattr(worker.engine, "num_adapters", 0)
            if not n:
                adapter = 0  # no bank: the adapter is ignored
            elif not 0 <= adapter < n:
                self._json(400, {"error": f"adapter {adapter} is not in the bank of {n}"})
                return
            uid = worker.submit(prompt, max_tokens, adapter)
            if path == "/submit":
                self._json(200, {"uid": uid})
                return
            # /generate: synchronous, poll until done
            while True:
                res = worker.result(uid)
                if res is not None and res["done"]:
                    res["uid"] = uid
                    self._json(200, res)
                    return
                worker.check_alive()
                time.sleep(cfg.poll_interval_s)

    return Handler


def serve(engine, config: ServingConfig | None = None, *, block: bool = True):
    """Start serving ``engine`` over HTTP.  Returns (server, worker); with
    block=False the caller owns shutdown (server.shutdown();
    worker.stop_flag.set())."""
    cfg = config or ServingConfig()
    worker = _EngineWorker(engine, cfg.poll_interval_s)
    worker.start()
    server = ThreadingHTTPServer((cfg.host, cfg.port), _make_handler(worker, cfg))
    if block:
        try:
            server.serve_forever()
        finally:
            worker.stop_flag.set()
    else:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
    return server, worker

"""CUDA-graph capture of the engine's decode bodies: the port's place of
``jax.jit``.

The JAX engine jits each body of its decode loop (the decode step, a burst
of steps, the draft scan, the verify step; flash_attn_tpu/engine/
engine.py), so one dispatch runs it.  On the card the port records each
body once in a ``torch.cuda.CUDAGraph`` and replays it (``GraphBody``):

- its first call runs eagerly and its second eagerly on a side stream, so
  the kernel library is built, and K8's arrival counters and the fp32
  LM-head copy are made, before any capture;
- the third call captures it on that side stream (with the engine's
  generator registered when sampling draws from it) and replays it; every
  later call copies its inputs into the graph's static input buffers and
  replays.  A replay writes the same static outputs each time, so the
  caller reads or copies them before its next call;
- the cache and pool buffers that a body updates in place must not move:
  their addresses are stored at capture and checked at every replay;
- a watched tensor changed in place (an optimizer step on the head)
  brings the body back to its eager calls and a new capture, so what the
  model derives from it at a first call (the fp32 head) is made anew;
- the kernel wrappers' launch counters: what the wrappers added while the
  body was captured (when nothing ran) is taken back out and added once
  per replay, so the counts stay those of the kernels that ran.

A failed capture raises: the body never runs eagerly in its place.  On
the CPU, and inside ``disable_graphs()`` (the port's ``jax.disable_jit``),
a body is a plain call.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from flash_attn_tpu_torch.ops import matmul as _mm
from flash_attn_tpu_torch.ops.decode import flash_decode_cuda
from flash_attn_tpu_torch.ops.flash_fwd import flash_fwd_cuda
from flash_attn_tpu_torch.ops.kv_append import kv_append_cuda
from flash_attn_tpu_torch.ops.lse import lse_merge_cuda
from flash_attn_tpu_torch.ops.paged_decode import paged_flash_decode_cuda

# every launch counter of the wrappers a body may reach
_COUNTERS = (
    (flash_decode_cuda, ("launches", "chunk_launches", "bshd_launches", "window_launches",
                         "d256_launches", "d64_launches", "view_launches",
                         "chunk_local_launches")),
    (paged_flash_decode_cuda, ("launches", "chunk_launches", "merges", "d64_launches",
                               "local_launches", "chunk_local_launches")),
    (kv_append_cuda, ("launches",)),
    (lse_merge_cuda, ("launches",)),
    (flash_fwd_cuda, ("launches", "d256_launches", "d64_launches", "window_launches",
                      "local_launches")),
    (_mm.matmul_int8_cuda, ("launches",)),
    (_mm.matmul_int8_grouped_cuda, ("launches",)),
    (_mm.matmul_int4_cuda, ("launches",)),
    (_mm.matmul_w8a8_cuda, ("launches",)),
    (_mm.matmul_w4a8_cuda, ("launches",)),
)
_NAMES = [(fn, a) for fn, attrs in _COUNTERS for a in attrs]

_enabled = True


@contextlib.contextmanager
def disable_graphs():
    """Run every body eagerly inside the block (the port's counterpart of
    ``jax.disable_jit``): for comparing the captured bodies against their
    eager runs."""
    global _enabled
    prev, _enabled = _enabled, False
    try:
        yield
    finally:
        _enabled = prev


def _counts() -> list[int]:
    return [getattr(fn, a) for fn, a in _NAMES]


def _set_counts(values) -> None:
    for (fn, a), v in zip(_NAMES, values):
        setattr(fn, a, v)


def _tensors(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def tensor_versions(*dicts) -> tuple:
    """The version counters of the tensors held directly in ``dicts`` (a
    params dict's top level: embeddings, final norm, a float head), which
    an in-place optimizer step advances."""
    return tuple(v._version for d in dicts if d is not None
                 for v in d.values() if isinstance(v, torch.Tensor))


class GraphBody:
    """``fn(*inputs) -> tensor or tuple of tensors`` replayed from a CUDA
    graph on the card (see the module docstring).

    device: where the body runs; inputs may lie on the host and are moved
    (or, on replay, copied into the static inputs) without a sync.
    buffers: () -> the tensors that ``fn`` updates in place (cache, pool).
    watch: () -> a key; a change brings back the eager calls and a new
    capture (default: never).
    generator: the ``torch.Generator`` that ``fn`` samples from, if any.
    ``calls`` counts the calls, eager or replayed."""

    def __init__(self, fn: Callable, device, *, buffers: Callable,
                 watch: Callable | None = None, generator=None):
        self.fn = fn
        self.device = torch.device(device)
        self.buffers = buffers
        self.watch = watch or (lambda: None)
        self.generator = generator
        self.graph = None
        self._key = None
        self._calls = 0
        self._stream = None
        self.calls = 0

    def __call__(self, *inputs):
        self.calls += 1
        if not _enabled or self.device.type != "cuda":
            return self.fn(*(x.to(self.device) for x in inputs))
        key = self.watch()
        if self.graph is None or key != self._key:
            if key != self._key:
                self._key, self._calls, self.graph = key, 0, None
            self._calls += 1
            dev = [x.to(self.device, non_blocking=True) for x in inputs]
            if self._calls == 1:
                return self.fn(*dev)
            if self._calls == 2:
                return self._side_call(dev)
            self._capture(dev)
        return self._replay(inputs)

    def _side_call(self, inputs):
        cur = torch.cuda.current_stream(self.device)
        self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = self.fn(*inputs)
        cur.wait_stream(self._stream)
        for t in _tensors(out):
            t.record_stream(cur)
        return out

    def _capture(self, inputs):
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError("this PyTorch cannot capture sampling from an engine's "
                                   "generator (CUDAGraph.register_generator_state)")
            graph.register_generator_state(self.generator)
        self._in = [x.clone() for x in inputs]
        before = _counts()
        try:
            with torch.cuda.graph(graph, stream=self._stream):
                out = self.fn(*self._in)
        finally:
            during = _counts()
            _set_counts(before)
        self._deltas = [(fn, a, d - b) for (fn, a), d, b in zip(_NAMES, during, before)
                        if d != b]
        self._ptrs = [t.data_ptr() for t in self.buffers()]
        self.graph, self._out = graph, out

    def _replay(self, inputs):
        ptrs = [t.data_ptr() for t in self.buffers()]
        if ptrs != self._ptrs:
            raise RuntimeError("a cache or pool buffer moved since the body was captured; "
                               "the engine's buffers must be updated in place")
        for s, x in zip(self._in, inputs):
            if x.shape != s.shape or x.dtype != s.dtype:
                raise ValueError(f"captured input is {tuple(s.shape)} {s.dtype}, "
                                 f"got {tuple(x.shape)} {x.dtype}")
            s.copy_(x, non_blocking=True)
        self.graph.replay()
        for fn, a, d in self._deltas:
            setattr(fn, a, getattr(fn, a) + d)
        return self._out

"""Inference engine: continuous batching over a one-prompt prefill and a
batched decode step.

Port of flash_attn_tpu/engine/engine.py:InferenceEngine for the plain
path: bucketed prefill of one prompt per call and one decode token for
every slot per step (idle slots are masked by kv_length and ignored by the
scheduler).  Chunked and packed prefill, decode bursts, speculative
decoding, LoRA banks and meshes are still to port and raise
``NotImplementedError``.  PyTorch runs eagerly, so there is no jit; the
KV cache is updated in place.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from flash_attn_tpu_torch._device import resolve_device
from flash_attn_tpu_torch.engine.kv_cache import KVCache
from flash_attn_tpu_torch.engine.sampler import SamplingParams, sample
from flash_attn_tpu_torch.engine.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    bucket_length,
)
from flash_attn_tpu_torch.utils.metrics import EngineMetrics


@dataclass
class ModelAdapter:
    """What the engine needs from a model family."""

    # (params, tokens [1, S], positions [1, S]) -> (logits [1, S, V],
    #  kvs: list of (k, v) [1, S, Hk, D] per layer)
    prefill_with_kv: Callable
    # (params, token [B], cache) -> (logits [B, V], cache)
    decode_step: Callable
    num_layers: int
    num_kv_heads: int
    head_dim: int
    eos_token: int | None = None


class InferenceEngine:
    def __init__(self, params, adapter: ModelAdapter, *, max_batch: int = 8,
                 capacity: int = 2048, kv_mode: str = "none",
                 cache_dtype=torch.bfloat16,
                 sampling: SamplingParams | None = None, rng_seed: int = 0,
                 device=None, prefill_chunk_size: int | None = None,
                 spec=None, mesh=None, lora_bank=None, decode_burst: int = 1):
        """device: where the cache lives and the steps run (default: the
        card); it must be where ``params`` are."""
        unported = {
            "prefill_chunk_size": prefill_chunk_size is not None,
            "spec": spec is not None,
            "mesh": mesh is not None,
            "lora_bank": lora_bank is not None,
            "decode_burst": decode_burst != 1,
        }
        for name, used in unported.items():
            if used:
                raise NotImplementedError(f"{name} is not ported yet")
        self.device = resolve_device(device)
        self.params = params
        self.adapter = adapter
        self.capacity = capacity
        self.sampling = sampling or SamplingParams()
        self.sched = ContinuousBatchingScheduler(max_batch)
        self.cache = KVCache.create(
            adapter.num_layers, max_batch, capacity, adapter.num_kv_heads,
            adapter.head_dim, dtype=cache_dtype, mode=kv_mode,
            device=self.device,
        )
        self.generator = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.next_token = np.zeros((max_batch,), np.int64)
        # host mirror of cache.length (prefill sets it, decode advances every
        # slot), so the loop never reads the lengths back from the device
        self._host_lens = np.zeros((max_batch,), np.int64)
        self.metrics = EngineMetrics(kv_capacity=max_batch * capacity)

    def submit(self, prompt, max_tokens=64) -> Request:
        return self.sched.submit(prompt, max_tokens, self.adapter.eos_token)

    def cancel(self, req: Request) -> bool:
        return self.sched.cancel(req)

    def run(self, max_steps: int = 10_000) -> None:
        """Drive until all submitted work completes."""
        steps = 0
        while self.sched.has_work and steps < max_steps:
            steps += 1
            for req in self.sched.admit():
                self._do_prefill(req)
            if self.sched.active:
                self._do_decode_step()

    def _prefill_one(self, tokens, slot: int, true_len: int):
        """Run the model on one padded prompt, write its KV into ``slot``
        and return the logits at its last real token."""
        positions = torch.arange(tokens.shape[1], device=self.device)[None]
        logits_all, kvs = self.adapter.prefill_with_kv(
            self.params, tokens, positions)
        for layer, (k, v) in enumerate(kvs):
            _insert_slot_kv(self.cache, layer, slot, k[0], v[0])
        self.cache.set_length(slot, true_len)
        return logits_all[0, true_len - 1]

    def _do_prefill(self, req: Request):
        t0 = time.perf_counter()
        bucket = min(bucket_length(len(req.prompt)), self.capacity)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, : len(req.prompt)] = req.prompt
        logits = self._prefill_one(
            torch.from_numpy(toks).to(self.device), req.slot, len(req.prompt))
        tok = int(sample(logits[None], self.generator, self.sampling)[0])
        self._host_lens[req.slot] = len(req.prompt)
        self.metrics.record_prefill(len(req.prompt), time.perf_counter() - t0)
        req.generated.append(tok)
        if len(req.generated) >= req.max_tokens or (
            req.eos_token is not None and tok == req.eos_token
        ):
            self.sched.complete(req)
            self.metrics.completed_requests += 1
        else:
            self.next_token[req.slot] = tok

    def _do_decode_step(self):
        t0 = time.perf_counter()
        slots = self.sched.active_slots()
        logits, self.cache = self.adapter.decode_step(
            self.params, torch.from_numpy(self.next_token).to(self.device),
            self.cache)
        toks = sample(logits, self.generator, self.sampling).cpu().numpy()
        self._host_lens += 1  # decode appends for every batch slot
        self.metrics.record_decode(len(slots), time.perf_counter() - t0)
        self.metrics.kv_tokens_in_use = int(
            sum(self._host_lens[s] for s in self.sched.active_slots()))
        for slot in slots:
            tok = int(toks[slot])
            if not self.sched.step_done(slot, tok):
                self.next_token[slot] = tok
                continue
            self.metrics.completed_requests += 1


def _insert_slot_kv(cache: KVCache, layer: int, slot: int, k, v) -> KVCache:
    """Write a full prompt's KV [S, Hk, D] into (layer, slot) of the cache,
    quantizing per (token, head), in place."""
    return cache.insert_prompt(layer, slot, k, v)

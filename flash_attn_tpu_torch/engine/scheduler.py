"""Continuous-batching scheduler: a copy of flash_attn_tpu/engine/scheduler.py
(pure host logic), kept in the port so that it imports nothing of the JAX
package.

Requests arrive at any time and join the running batch as slots free up:
- a fixed number of sequence slots (max_batch); decode always runs the
  full slot batch (inactive slots are masked by kv_length),
- prefill runs per request, padded to a few bucket lengths,
- the engine asks the scheduler what to do next; all device work happens
  in the model adapter's prefill and decode functions.
"""

from __future__ import annotations

import collections
import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np


@dataclass
class Request:
    uid: int
    prompt: list[int]
    max_tokens: int
    eos_token: Optional[int] = None
    # filled by the engine:
    generated: list[int] = field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    adapter: int = 0  # LoRA adapter index (multi-adapter serving)
    cancelled: bool = False


def bucket_length(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)):
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 8192) * 8192


class ContinuousBatchingScheduler:
    """Tracks slots and queues; the engine asks it what to do next."""

    def __init__(self, max_batch: int):
        self.max_batch = max_batch
        self.waiting: collections.deque[Request] = collections.deque()
        self.active: dict[int, Request] = {}  # slot -> request
        self.free_slots = list(range(max_batch))
        self._uid = itertools.count()

    def submit(self, prompt, max_tokens, eos_token=None, adapter=0) -> Request:
        req = Request(next(self._uid), list(prompt), max_tokens, eos_token,
                      adapter=adapter)
        self.waiting.append(req)
        return req

    def admit(self, can_admit=None) -> list[Request]:
        """Move waiting requests into free slots; returns newly admitted
        requests (engine must prefill them).

        can_admit: optional callback(req) -> bool for resource-gated
        admission (e.g. the paged engine checks KV page availability);
        admission stops at the first refusal (FIFO order preserved)."""
        admitted = []
        while self.waiting and self.free_slots:
            if can_admit is not None and not can_admit(self.waiting[0]):
                break
            req = self.waiting.popleft()
            req.slot = self.free_slots.pop(0)
            self.active[req.slot] = req
            admitted.append(req)
        return admitted

    def active_slots(self) -> list[int]:
        return sorted(self.active)

    def complete(self, req: Request):
        req.done = True
        if req.slot is not None:
            self.free_slots.append(req.slot)
            self.free_slots.sort()
            del self.active[req.slot]
            req.slot = None

    def step_done(self, slot: int, token: int) -> bool:
        """Record a generated token; returns True if the request finished."""
        req = self.active[slot]
        req.generated.append(token)
        if (
            req.cancelled
            or len(req.generated) >= req.max_tokens
            or (req.eos_token is not None and token == req.eos_token)
        ):
            self.complete(req)
            return True
        return False

    def cancel(self, req: Request) -> bool:
        """Cancel a request: waiting ones leave the queue immediately;
        active ones finish at the next decode step (their slot is released
        through the engine's normal completion path so KV bookkeeping
        stays in one place).  Returns True if newly cancelled."""
        if req.done or req.cancelled:
            return False
        req.cancelled = True
        if req.slot is None:
            try:
                self.waiting.remove(req)
            except ValueError:
                pass
            req.done = True
        return True

    @property
    def has_work(self):
        return bool(self.waiting or self.active)

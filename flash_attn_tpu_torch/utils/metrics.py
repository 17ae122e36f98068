"""Engine observability: tokens/s, per-phase step times, KV occupancy.

A copy of flash_attn_tpu/utils/metrics.py, kept in the port so that it
imports nothing of the JAX package.  Plain structured logging, a dict per
window.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field

logger = logging.getLogger("flash_attn_tpu_torch")


@dataclass
class EngineMetrics:
    window_start: float = field(default_factory=time.perf_counter)
    prefill_tokens: int = 0
    decode_tokens: int = 0
    prefill_seconds: float = 0.0
    decode_seconds: float = 0.0
    steps: int = 0
    kv_tokens_in_use: int = 0
    kv_capacity: int = 0
    completed_requests: int = 0
    # speculative decoding: emitted = accepted drafts + the correction
    # token per verify step; proposed = drafts offered
    spec_emitted: int = 0
    spec_proposed: int = 0
    spec_steps: int = 0

    def record_prefill(self, tokens: int, seconds: float):
        self.prefill_tokens += tokens
        self.prefill_seconds += seconds

    def record_decode(self, tokens: int, seconds: float):
        self.decode_tokens += tokens
        self.decode_seconds += seconds
        self.steps += 1

    def record_spec(self, emitted: int, proposed: int):
        self.spec_emitted += emitted
        self.spec_proposed += proposed
        self.spec_steps += 1

    def snapshot(self) -> dict:
        elapsed = time.perf_counter() - self.window_start
        return {
            "elapsed_s": round(elapsed, 3),
            "decode_tokens_per_s": round(self.decode_tokens / elapsed, 2) if elapsed else 0.0,
            "prefill_tokens_per_s": round(self.prefill_tokens / max(self.prefill_seconds, 1e-9), 2),
            "decode_step_ms": round(1e3 * self.decode_seconds / max(self.steps, 1), 3),
            "kv_occupancy": round(self.kv_tokens_in_use / max(self.kv_capacity, 1), 4),
            "completed_requests": self.completed_requests,
            "spec_tokens_per_step": round(
                self.spec_emitted / max(self.spec_steps, 1), 3
            ),
            "spec_draft_acceptance": round(
                max(self.spec_emitted - self.spec_steps, 0)
                / max(self.spec_proposed, 1),
                4,
            ),
        }

    def log(self):
        logger.info("engine_metrics %s", json.dumps(self.snapshot()))

    def reset(self):
        self.__init__()

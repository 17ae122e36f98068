"""Token sampling: greedy / temperature / top-k / top-p.

Port of flash_attn_tpu/engine/sampler.py.  Greedy is an argmax and
matches the JAX sampler exactly; the stochastic modes draw from a
``torch.Generator`` and so give other tokens than ``jax.random`` for the
same seed.  Nothing is read back to the host, so the engine's captured
decode bodies sample inside their CUDA graphs.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0            # 0 => disabled
    top_p: float = 1.0        # 1 => disabled
    max_tokens: int = 128


def sample(logits: torch.Tensor, generator: torch.Generator | None,
           params: SamplingParams) -> torch.Tensor:
    """logits [B, V] -> tokens [B] (int64, on logits' device)."""
    if params.temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / params.temperature
    if params.top_k > 0:
        kth = torch.topk(logits, params.top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest set with cumulative prob >= top_p; cutoff = last kept logit
        keep = cum - probs < params.top_p
        cutoff = torch.where(keep, sorted_logits,
                             torch.full_like(sorted_logits, float("inf")))
        logits = logits.masked_fill(logits < cutoff.amin(-1, keepdim=True),
                                    float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # torch.multinomial's own one-sample path (argmax of p / q, q ~ Exp(1)),
    # without its checks that read the probabilities back to the host: the
    # same tokens from the same generator, and capturable in a CUDA graph
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, dim=-1)

"""Perplexity-delta harness: the model-quality cost of KV and weight
quantization, as the teacher-forced NLL of a continuation.

Port of flash_attn_tpu/utils/ppl.py.  KV quantization acts only on the
decode path (quantize on append, dequantize in the kernel), so
``decode_nll`` scores a continuation token by token through ``prefill``
and ``decode_step`` with the cache in each mode, not through the
full-sequence forward, which never touches the cache.  Everything runs
under ``torch.no_grad()`` on the params' device: on the card the decode
steps run K1 + K2 and the prefill K4; on the CPU their plain versions.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


def _device(tree) -> torch.device | None:
    """The device of the first tensor in a params tree (dicts, lists and
    the quantized weights' dataclasses)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if isinstance(tree, dict):
        items = tree.values()
    elif isinstance(tree, (list, tuple)):
        items = tree
    elif dataclasses.is_dataclass(tree):
        items = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    else:
        items = ()
    for item in items:
        dev = _device(item)
        if dev is not None:
            return dev
    return None


def _tokens(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.long, device=device)


@torch.no_grad()
def decode_nll(params, cfg, prompt, continuation, *, kv_mode="none", module=None) -> float:
    """Mean negative log-likelihood (nats a token) of ``continuation``
    given ``prompt``, decoding with the KV cache in ``kv_mode`` ("none":
    the cache in the model's dtype; "int8"; "fp8").

    prompt, continuation: 1-D int sequences; module: a model module with
    ``make_cache``, ``prefill`` and ``decode_step`` of the gpt2.py
    signature (default flash_attn_tpu_torch.models.gpt2)."""
    if module is None:
        from flash_attn_tpu_torch.models import gpt2 as module

    dev = _device(params)
    prompt = _tokens(prompt, dev)[None]
    cont = [int(t) for t in continuation]
    capacity = prompt.shape[1] + len(cont) + 1
    cache = module.make_cache(cfg, 1, capacity, mode=kv_mode, device=dev)
    logits, cache = module.prefill(params, prompt, cfg, cache)
    nll = 0.0
    for t in cont:
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll -= float(logp[0, t])
        logits, cache = module.decode_step(params, _tokens([t], dev), cfg, cache)
    return nll / max(len(cont), 1)


def kv_ppl_delta(params, cfg, prompt, continuation, *, modes=("int8", "fp8"),
                 module=None) -> dict:
    """Perplexity (e^nll) per KV mode and its delta against the float
    cache: {mode: {"nll", "ppl", "delta_ppl"}}, "none" first."""
    base = decode_nll(params, cfg, prompt, continuation, kv_mode="none", module=module)
    out = {"none": {"nll": base, "ppl": math.exp(base), "delta_ppl": 0.0}}
    for mode in modes:
        nll = decode_nll(params, cfg, prompt, continuation, kv_mode=mode, module=module)
        out[mode] = {"nll": nll, "ppl": math.exp(nll),
                     "delta_ppl": math.exp(nll) - math.exp(base)}
    return out


@torch.no_grad()
def forward_nll(params, cfg, tokens, *, forward_fn=None) -> float:
    """Teacher-forced mean NLL over a full sequence (the weight-quant
    harness: run with float and with quantized params and compare).
    ``forward_fn(params, tokens [1, S]) -> logits``; default the port's
    ``gpt2.forward``."""
    if forward_fn is None:
        from flash_attn_tpu_torch.models import gpt2

        def forward_fn(p, t):
            return gpt2.forward(p, t, cfg)
    tokens = _tokens(tokens, _device(params))[None]
    logp = torch.log_softmax(forward_fn(params, tokens).float(), dim=-1)
    picked = torch.gather(logp[0, :-1], -1, tokens[0, 1:, None])
    return float(-picked.mean())

"""Training utilities: cross-entropy (dense and chunked), the train step
(global-norm clipping, AdamW, gradient accumulation, rematerialisation)
and the tiny-LM recipe.

Port of flash_attn_tpu/utils/train.py in plain PyTorch; the attention
backward inside the forward is K9 + K10.  optax's
``chain(clip_by_global_norm(clip), adamw(lr, weight_decay=wd))`` is
written out with its formulas and roundings: b1 0.9, b2 0.999, eps 1e-8,
decay on every leaf, moments made in the params' dtype (``mu_dtype=None``)
and promoted as optax promotes them (fp32 once an fp32 gradient, as
``accum_steps`` makes, reaches a bf16 moment).  Params are updated in
place, leaf by leaf, so no whole-model temporary exists.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from flash_attn_tpu_torch._device import resolve_device

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    accum_steps: int = 1
    remat: bool = True  # checkpoint each block of the forward


def cross_entropy(logits, targets, mask=None):
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def _chunk_nll(xc, head, tc, mc):
    logits = xc.float() @ head.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, tc[..., None])[..., 0]
    return ((lse - picked) * mc).sum()


def chunked_cross_entropy(x, head, targets, mask=None, chunk: int = 1024):
    """Cross-entropy straight from hidden states, never materialising the
    full [B, S, V] fp32 logits: each ``chunk`` of positions computes its
    logits, reduces them to a sum of nll, and is checkpointed, so the
    backward recomputes one chunk's logits at a time.  Gradients flow to
    both ``x`` and ``head``.

    x: [B, S, H]; head: [H, V] (``params['tok_emb'].T`` when tied);
    targets [B, S] int; mask [B, S] optional.  Returns the mean nll over
    unmasked positions."""
    B, S, _ = x.shape
    c = min(chunk, S)
    pad = (-S) % c
    mask = (torch.ones((B, S), dtype=torch.float32, device=x.device)
            if mask is None else mask.float())
    targets = targets.long()
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    total = x.new_zeros((), dtype=torch.float32)
    for i in range(0, x.shape[1], c):
        total = total + checkpoint(_chunk_nll, x[:, i:i + c], head, targets[:, i:i + c],
                                   mask[:, i:i + c], use_reentrant=False)
    return total / torch.clamp(mask.sum(), min=1.0)


def named_leaves(params, prefix: str = "") -> list:
    """(name, tensor) of the trainable tensors of a params tree, in JAX's
    leaf order (dict keys sorted).  Keys that start with "_" hold derived
    caches (the serving path's ``_lm_head_f32``) and are skipped."""
    if isinstance(params, dict):
        return [leaf for key in sorted(params) if not key.startswith("_")
                for leaf in named_leaves(params[key], f"{prefix}{key}.")]
    if isinstance(params, (list, tuple)):
        return [leaf for i, item in enumerate(params)
                for leaf in named_leaves(item, f"{prefix}{i}.")]
    return [(prefix[:-1], params)]


def param_leaves(params) -> list:
    return [t for _, t in named_leaves(params)]


def loss_and_grads(forward_fn: Callable, params, tokens, targets, mask=None, *,
                   remat: bool = True, accum_steps: int = 1):
    """(loss, grads in ``param_leaves`` order), as the JAX step's
    ``value_and_grad``.  With ``accum_steps`` n the batch splits into n
    microbatches whose gradients sum, each divided by n, into fp32 (the
    JAX step's fp32 accumulator)."""
    leaves = param_leaves(params)
    if accum_steps == 1:
        loss = cross_entropy(forward_fn(params, tokens, remat=remat), targets, mask)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))
    n = accum_steps
    toks = tokens.reshape(n, -1, *tokens.shape[1:])
    tgts = targets.reshape(n, -1, *targets.shape[1:])
    msks = (torch.ones(toks.shape, dtype=torch.float32, device=tokens.device)
            if mask is None else mask.reshape(n, -1, *mask.shape[1:]))
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    for tok, tgt, msk in zip(toks, tgts, msks):
        part = cross_entropy(forward_fn(params, tok, remat=remat), tgt, msk)
        for acc, g in zip(grads, torch.autograd.grad(part, leaves)):
            acc.add_(g / n)
        loss = loss + part.detach() / n
    return loss, grads


def global_norm(grads):
    """optax.global_norm: each leaf's sum of squares in its own dtype
    (summed in fp32, then rounded to it), summed over leaves, square root."""
    return torch.sqrt(sum(g.float().square().sum().to(g.dtype) for g in grads))


@functools.lru_cache(maxsize=64)
def _rounded(x: float, dtype) -> float:
    """A Python constant as JAX uses it against an array of ``dtype``: a
    weak-typed scalar takes the array's dtype first (0.1 is 0.10009765625
    in bf16).  The value returned is exact in ``dtype``, so torch's
    elementwise ops, which compute low precision in fp32, see that value."""
    return torch.tensor(x, dtype=torch.float32).to(dtype).item()


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """optax.clip_by_global_norm in place: every leaf becomes
    g / norm * max_norm when norm >= max_norm (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  Returns the norm before clipping."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * _rounded(max_norm, g.dtype)))
    return norm


def adamw_init(leaves) -> dict:
    return {"count": 0, "mu": [torch.zeros_like(p) for p in leaves],
            "nu": [torch.zeros_like(p) for p in leaves]}


@torch.no_grad()
def adamw_update(leaves, grads, state, lr: float, weight_decay: float):
    """optax.adamw, one step, in place and rounded as optax rounds: each
    moment in the promotion of its gradient's and its own dtype (a new,
    wider tensor replaces it in ``state`` when they differ), every
    operation rounded to its operands' dtype with the constants in that
    dtype, the bias corrections 1 - b**t formed in fp32:
    mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu,
    u = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd p, p = p + (-lr) u."""
    state["count"] += 1
    t = state["count"]
    bc1 = float(1.0 - torch.tensor(ADAM_B1) ** t)
    bc2 = float(1.0 - torch.tensor(ADAM_B2) ** t)
    for i, (p, g) in enumerate(zip(leaves, grads)):
        dt = torch.promote_types(g.dtype, state["mu"][i].dtype)
        mu = state["mu"][i] = state["mu"][i].to(dt)
        nu = state["nu"][i] = state["nu"][i].to(dt)
        g = g.to(dt)
        mu.mul_(_rounded(ADAM_B1, dt)).add_(g * _rounded(1.0 - ADAM_B1, dt))
        nu.mul_(_rounded(ADAM_B2, dt)).add_(g.square().mul_(_rounded(1.0 - ADAM_B2, dt)))
        u = (mu / _rounded(bc1, dt)).div_(
            (nu / _rounded(bc2, dt)).sqrt_().add_(_rounded(ADAM_EPS, dt)))
        u.add_(p * _rounded(weight_decay, p.dtype)).mul_(_rounded(-lr, dt))
        p.add_(u)


def make_train_step(forward_fn: Callable, tcfg: TrainConfig):
    """forward_fn(params, tokens, *, remat) -> logits [B, S, V].

    Returns (init_fn(params) -> opt_state,
             step_fn(params, opt_state, tokens, targets, mask=None) ->
                 (params, opt_state, metrics {"loss", "grad_norm"})).
    ``init_fn`` makes every leaf require grad; ``step_fn`` updates the
    params and the state in place.  ``grad_norm`` is the norm before
    clipping."""

    def init_fn(params):
        leaves = param_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        return adamw_init(leaves)

    def step_fn(params, opt_state, tokens, targets, mask=None):
        loss, grads = loss_and_grads(forward_fn, params, tokens, targets, mask,
                                     remat=tcfg.remat, accum_steps=tcfg.accum_steps)
        gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
        adamw_update(param_leaves(params), grads, opt_state, tcfg.learning_rate,
                     tcfg.weight_decay)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return init_fn, step_fn


def train_tiny_lm(cfg, corpus, steps, seed: int = 0, *, batch=16, seqlen=128,
                  learning_rate=3e-3, params=None):
    """Train a small Llama on a 1-D token corpus with fixed pre-cropped
    batches.  Deterministic: the crops come from numpy ``default_rng(0)``
    exactly as in the JAX recipe.  Starts from ``init_params(cfg, seed)``
    on the card, or from ``params`` (for example bridged from the JAX
    package's ``init_params``, as the parity test does) on their device.
    Returns (params, losses [steps] fp32)."""
    from flash_attn_tpu_torch.models import llama

    if params is None:
        params = llama.init_params(cfg, seed, device=resolve_device(None))
    dev = param_leaves(params)[0].device
    rng = np.random.default_rng(0)
    starts = rng.integers(0, len(corpus) - seqlen - 1, (steps, batch))
    data = np.stack([
        np.stack([corpus[s:s + seqlen + 1] for s in row]) for row in starts
    ])  # [steps, batch, seqlen + 1]
    data = torch.from_numpy(data.astype(np.int64)).to(dev)

    def fwd(p, tokens, remat):
        return llama.forward(p, tokens, cfg, remat=remat)

    init_fn, step_fn = make_train_step(fwd, TrainConfig(learning_rate=learning_rate))
    opt_state = init_fn(params)
    losses = []
    for batch_ in data:
        params, opt_state, m = step_fn(params, opt_state, batch_[:, :-1], batch_[:, 1:])
        losses.append(m["loss"])
    return params, torch.stack(losses)

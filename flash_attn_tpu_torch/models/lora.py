"""Multi-adapter LoRA for serving: port of flash_attn_tpu/models/lora.py.

LoRA factorizes a weight update as ``W' = W + (alpha/r) * A @ B`` with
A [K, r], B [r, N], r << min(K, N).  Many adapters share one set of
(possibly quantized) base weights; each request selects an adapter, and
a batched decode step applies per-slot deltas through a gathered bmm:
the base projection stays one kernel call (K3, K5, K6, K7 or a float
matmul) and the delta adds two thin rank-r products.  JAX's delta is
plain jnp, so the port's is plain PyTorch (cuBLAS on the card).

Shapes:
  single adapter:  A [K, r], B [r, N]
  stacked bank:    A [n, K, r], B [n, r, N]  (``stack_adapters``)
  per-slot select: ids [B] into the bank's leading axis
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.ops.matmul import weight_kn

LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def init_lora(params, rank: int, generator: torch.Generator, *, alpha: float | None = None,
              targets=LORA_TARGETS, dtype=None):
    """Fresh LoRA tree over ``params['blocks']`` (unfused names), on
    ``generator``'s device: A ~ N(0, 1/r), B = 0 (the delta starts at
    exactly zero).  Each leaf takes ``dtype``, else its weight's own dtype,
    else fp32 for a quantized weight, which has none.  Returns
    {"blocks": [{name: (A, B)}], "scaling": alpha/r}."""
    dev = generator.device
    blocks = []
    for blk in params["blocks"]:
        entry = {}
        for name in targets:
            K, N = weight_kn(blk[name])
            d = dtype or (blk[name].dtype if isinstance(blk[name], torch.Tensor)
                          else torch.float32)
            A = torch.randn((K, rank), generator=generator, device=dev, dtype=d) * rank ** -0.5
            entry[name] = (A, torch.zeros((rank, N), device=dev, dtype=d))
        blocks.append(entry)
    return {"blocks": blocks, "scaling": float(alpha if alpha is not None else rank) / rank}


def stack_adapters(adapters: list):
    """Stack same-structure LoRA trees into a serving bank: leaves (A, B)
    -> (A [n, K, r], B [n, r, N]).  All adapters must share rank,
    targets, and scaling."""
    if not adapters:
        raise ValueError("need at least one adapter")
    scals = {a["scaling"] for a in adapters}
    if len(scals) != 1:
        raise ValueError(f"adapters disagree on scaling: {scals}")
    first = adapters[0]["blocks"]
    layout = [{name: tuple(t.shape for t in ab) for name, ab in blk.items()} for blk in first]
    for a in adapters[1:]:
        other = [{name: tuple(t.shape for t in ab) for name, ab in blk.items()}
                 for blk in a["blocks"]]
        if other != layout:
            raise ValueError("adapters disagree on blocks, targets or ranks")
    blocks = [{name: tuple(torch.stack([a["blocks"][i][name][j] for a in adapters])
                           for j in (0, 1))
               for name in blk}
              for i, blk in enumerate(first)]
    return {"blocks": blocks, "scaling": scals.pop()}


def lora_delta(x, ab, ids, scaling):
    """LoRA delta for a projection: x [..., K] -> [..., N].

    ab = (A, B); 2-D leaves apply one adapter to the whole batch; 3-D
    leaves (a stacked bank) gather per-slot adapters by ``ids`` [B] (x
    [B, t, K]) and run batched thin matmuls.  ids may also be a scalar
    index into a bank (the whole batch uses that adapter: the prefill
    case).  A and B are cast to x's dtype before the products."""
    A, B = ab
    dt = x.dtype
    if A.ndim == 3:
        if ids is None:
            raise ValueError("stacked LoRA bank needs adapter ids")
        if not isinstance(ids, torch.Tensor) or ids.ndim == 0:
            A, B = A[ids], B[ids]
        else:
            Ab = A[ids].to(dt)  # [B, K, r]
            Bb = B[ids].to(dt)  # [B, r, N]
            return torch.matmul(torch.matmul(x, Ab), Bb) * scaling
    return ((x @ A.to(dt)) @ B.to(dt)) * scaling


def merge_lora(params, lora):
    """Fold a single (unstacked, float-base) LoRA into the base weights:
    the zero-overhead single-adapter deployment and the oracle for the
    batched delta."""
    out = dict(params)
    out["blocks"] = []
    for blk, lblk in zip(params["blocks"], lora["blocks"]):
        nb = dict(blk)
        for name, (A, B) in lblk.items():
            w = blk[name]
            if not isinstance(w, torch.Tensor):
                raise ValueError(
                    f"merge_lora needs float base weights, got {type(w)} "
                    f"for {name}; serve quantized bases unmerged instead")
            nb[name] = (w.float() + lora["scaling"] * (A.float() @ B.float())).to(w.dtype)
        out["blocks"].append(nb)
    return out


def lora_tensors(lora) -> list:
    """Every A and B of a LoRA tree or bank (none for None)."""
    if lora is None:
        return []
    return [t for blk in lora["blocks"] for ab in blk.values() for t in ab]


def cast_lora(lora, dtype):
    """The tree or bank with every leaf in ``dtype`` (leaves already in it
    are shared): a bank cast once to the activations' dtype gives the
    values ``lora_delta``'s cast at each call gives."""
    return {"blocks": [{name: tuple(t.to(dtype) for t in ab) for name, ab in blk.items()}
                       for blk in lora["blocks"]],
            "scaling": lora["scaling"]}

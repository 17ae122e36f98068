"""Top-k routed mixture of experts: the router, the dense oracle and
expert parallelism over a mesh axis.

Port of flash_attn_tpu/parallel/moe.py (``router_topk``,
``moe_ffn_reference``, ``moe_ffn_ep``, ``make_moe_ffn``,
``moe_ffn_ep_a2a``, ``make_moe_ffn_a2a``), the expert-parallel forms in
the mesh's single-process form: each rank of the axis holds E / n
experts.  ``moe_ffn_ep`` computes every token's router weights on every
rank, each rank its experts' share for all tokens, and one ``psum``
combines them.  ``moe_ffn_ep_a2a`` takes each rank's own tokens, gives
each (token, choice) a slot in its expert's capacity buffer (token-major;
a slot at or past the capacity drops, GShard's rule), sends the buffers
to the experts' ranks with one ``all_to_all`` and the results back with
another.  Plain torch, as JAX's are plain jnp.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flash_attn_tpu_torch.parallel.mesh import (
    EXPERT_AXIS,
    TENSOR_AXIS,
    all_to_all,
    psum,
    shard_views,
)


def router_topk(logits: torch.Tensor, k: int) -> torch.Tensor:
    """logits [T, E] -> weights [T, E], nonzero only at each row's top k,
    softmaxed over them.  Ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them: a stable descending sort keeps equal
    logits in index order (``torch.topk`` promises no order on ties).
    Differentiable as JAX's: the gradient reaches the selected logits
    through the softmax and is zero at the others."""
    top = _top_k(logits, k)
    w = torch.softmax(torch.gather(logits, -1, top), dim=-1)
    return torch.zeros_like(logits).scatter(-1, top, w)


def _top_k(logits, k):
    """The indices of each row's k largest logits, ties to the lower index."""
    return torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]


def _experts(h, w_gate, w_up, w_down):
    """SwiGLU of fp32 rows h [E, T, H] through each of E experts -> [E, T, H]."""
    gate = torch.einsum("eth,ehf->etf", h, w_gate.float())
    up = torch.einsum("eth,ehf->etf", h, w_up.float())
    return torch.einsum("etf,efh->eth", F.silu(gate) * up, w_down.float())


def moe_ffn_reference(x, router_w, w_gate, w_up, w_down, *, top_k: int):
    """Dense oracle, everything in fp32: x [T, H]; router_w [H, E]; w_gate,
    w_up [E, H, F], w_down [E, F, H] -> [T, H] in x's dtype."""
    h = x.float()
    combine = router_topk(h @ router_w.float(), top_k)  # [T, E]
    outs = torch.stack([
        (torch.nn.functional.silu(h @ w_gate[e].float()) * (h @ w_up[e].float()))
        @ w_down[e].float()
        for e in range(router_w.shape[1])])  # [E, T, H]
    return torch.einsum("te,eth->th", combine, outs).to(x.dtype)


def moe_ffn_ep(x, router_w, w_gate, w_up, w_down, *, mesh, axis_name: str, top_k: int):
    """The shard-local EP body, every rank's expert slice a list in rank
    order: x [T, H] and router_w [H, E] the same on every rank; w_gate[r],
    w_up[r] [E_loc, H, F] and w_down[r] [E_loc, F, H] rank r's experts.
    Returns [T, H] in x's dtype (the psum over ranks, rank 0's copy)."""
    devs = mesh.axis_devices(axis_name)
    e_loc = w_gate[0].shape[0]
    combine = router_topk(x.float() @ router_w.float(), top_k)  # [T, E]
    local = []
    for r, d in enumerate(devs):
        mine = combine[:, r * e_loc:(r + 1) * e_loc].to(d)
        h = x.float().to(d)
        outs = _experts(h.expand(e_loc, *h.shape), w_gate[r], w_up[r], w_down[r])
        local.append(torch.einsum("te,eth->th", mine, outs))
    return psum(mesh, local, axis_name)[0].to(x.device, x.dtype)


def make_moe_ffn(mesh, *, axis_name: str = TENSOR_AXIS, top_k: int = 2):
    """``moe_ffn_ep`` on global tensors: fn(x, router_w, w_gate, w_up,
    w_down) with the experts' weights [E, ...] split on E over
    ``axis_name`` (views where the ranks share their device)."""
    def fn(x, router_w, w_gate, w_up, w_down):
        split = _expert_split(mesh, axis_name)
        return moe_ffn_ep(x, router_w, split(w_gate), split(w_up), split(w_down), mesh=mesh,
                          axis_name=axis_name, top_k=top_k)

    return fn


def _expert_split(mesh, axis_name):
    def split(w):
        return shard_views(mesh, w, (axis_name,) + (None,) * (w.ndim - 1))

    return split


def moe_ffn_ep_a2a(x, router_w, w_gate, w_up, w_down, *, mesh, axis_name: str, top_k: int,
                   capacity: int):
    """The capacity / all_to_all EP body, every rank's argument a list in
    rank order: x[r] [T_loc, H] rank r's tokens; w_gate[r], w_up[r],
    w_down[r] its experts [E_loc, ...]; router_w [H, E] the same on every
    rank.  Returns each rank's output [T_loc, H] in x's dtype, a list."""
    devs = mesh.axis_devices(axis_name)
    n = len(devs)
    e_loc = w_gate[0].shape[0]
    e_glob = router_w.shape[1]
    if e_glob != n * e_loc:
        raise ValueError(f"{e_glob} experts do not split {e_loc} a rank over {n} ranks")
    routes, bufs = [], []
    for r, d in enumerate(devs):
        xr = x[r].to(d)
        t_loc, hidden = xr.shape
        logits = xr.float() @ router_w.float().to(d)
        topi = _top_k(logits, top_k)  # [T, k]
        wts = torch.softmax(torch.gather(logits, -1, topi), dim=-1)
        # each (t, k)'s slot in its expert's buffer, token-major
        eid = topi.reshape(-1)
        onehot = F.one_hot(eid, e_glob)
        slot = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=1)
        keep = slot < capacity
        slot_safe = torch.where(keep, slot, torch.full_like(slot, capacity))
        # one spare slot takes the dropped (t, k)s and is cut off
        buf = torch.zeros((e_glob, capacity + 1, hidden), dtype=xr.dtype, device=d)
        buf[eid, slot_safe] = xr.repeat_interleave(top_k, dim=0)
        bufs.append(buf[:, :capacity].reshape(n, e_loc, capacity, hidden))
        routes.append((eid, slot_safe, keep, wts, t_loc, hidden))
    # each expert's slots from every rank on its home rank
    homes = all_to_all(mesh, bufs, split_dim=0, concat_dim=0, axis=axis_name)
    backs = []
    for r in range(n):
        toks = homes[r].transpose(0, 1).reshape(e_loc, n * capacity, -1)
        out = _experts(toks.float(), w_gate[r], w_up[r], w_down[r]).to(x[r].dtype)
        backs.append(out.reshape(e_loc, n, capacity, -1).transpose(0, 1))
    backs = all_to_all(mesh, backs, split_dim=0, concat_dim=0, axis=axis_name)
    ys = []
    for r, (eid, slot_safe, keep, wts, t_loc, hidden) in enumerate(routes):
        out = backs[r].reshape(e_glob, capacity, hidden)
        out = torch.cat([out, torch.zeros_like(out[:, :1])], dim=1)  # the dropped slot reads 0
        taken = out[eid, slot_safe].float()
        w_eff = wts.reshape(-1) * keep
        y = (taken * w_eff[:, None]).reshape(t_loc, top_k, hidden).sum(dim=1)
        ys.append(y.to(x[r].dtype))
    return ys


def make_moe_ffn_a2a(mesh, *, axis_name: str = EXPERT_AXIS, top_k: int = 2,
                     capacity: int | None = None, capacity_factor: float = 1.25,
                     tokens_per_device: int | None = None, num_experts: int | None = None):
    """``moe_ffn_ep_a2a`` on global tensors: fn(x, router_w, w_gate, w_up,
    w_down) with x [T, H] split on T and the experts' weights on E over
    ``axis_name``; returns [T, H].  ``capacity`` defaults to
    ceil(T_loc * top_k / E) * capacity_factor (GShard's convention)."""
    del tokens_per_device, num_experts

    def fn(x, router_w, w_gate, w_up, w_down):
        split = _expert_split(mesh, axis_name)
        xs = split(x)
        cap = capacity
        if cap is None:
            cap = int(-(-xs[0].shape[0] * top_k // router_w.shape[1]) * capacity_factor) or 1
        ys = moe_ffn_ep_a2a(xs, router_w, split(w_gate), split(w_up), split(w_down),
                            mesh=mesh, axis_name=axis_name, top_k=top_k, capacity=cap)
        return torch.cat([y.to(x.device) for y in ys], dim=0)

    return fn

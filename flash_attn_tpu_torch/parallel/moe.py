"""Top-k routed mixture of experts: the router and the dense oracle.

Port of flash_attn_tpu/parallel/moe.py:21-42 (``router_topk``,
``moe_ffn_reference``).  The expert-parallel forms (``moe_ffn_ep``,
``moe_ffn_ep_a2a``, ``make_moe_ffn``) need more than one card and are
not ported yet.
"""

from __future__ import annotations

import torch


def router_topk(logits: torch.Tensor, k: int) -> torch.Tensor:
    """logits [T, E] -> weights [T, E], nonzero only at each row's top k,
    softmaxed over them.  Ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them: a stable descending sort keeps equal
    logits in index order (``torch.topk`` promises no order on ties)."""
    top = torch.sort(logits, dim=-1, descending=True, stable=True).indices[:, :k]
    w = torch.softmax(torch.gather(logits, -1, top), dim=-1)
    return torch.zeros_like(logits).scatter(-1, top, w)


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

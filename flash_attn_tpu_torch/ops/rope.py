"""Rotary position embeddings (rotate-half, Llama / HF NEOX style).

Port of flash_attn_tpu/ops/rope.py.  cos/sin carry the angle tables,
shape [..., S, D/2], broadcast over heads.  The math runs in fp32 and the
result is cast back to the input dtype.
"""

from __future__ import annotations

import torch


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32):
    """positions [...] -> cos/sin [..., head_dim // 2]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def rope_rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [..., S, H, D]; cos/sin [..., S, D/2] (broadcast over heads)."""
    d2 = x.shape[-1] // 2
    xf1 = x[..., :d2].float()
    xf2 = x[..., d2:].float()
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)


def rope_unrotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """Inverse rotation (R is orthogonal: R^-1 = R(-angle)).  Used by the
    attention backward to pull dq back through an in-kernel q rotation."""
    return rope_rotate(x, cos, -sin)

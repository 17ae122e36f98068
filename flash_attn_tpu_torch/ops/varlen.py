"""Varlen (ragged, packed batch) helpers: integer glue at the API edge.

Port of flash_attn_tpu/ops/varlen.py.  A packed batch is addressed by
``cu_seqlens``, int32 prefix sums of length b + 1, or by segment ids over
the packed token axis: equal ids attend to each other, id 0 marks
padding.  These helpers convert between the two, so callers keep their
cu_seqlens while K4 sees segment ids.
"""

from __future__ import annotations

import numpy as np
import torch


def cu_seqlens_to_segment_ids(cu_seqlens: torch.Tensor, total: int) -> torch.Tensor:
    """[b+1] int32 prefix sums -> [total] int32 segment ids (1-based; 0 =
    pad): tokens in [cu[i], cu[i+1]) get id i + 1, tokens at or past
    cu[-1] get 0."""
    cu = cu_seqlens.to(torch.int32)
    pos = torch.arange(total, dtype=torch.int32, device=cu.device)
    ids = (pos[:, None] >= cu[None, 1:]).sum(dim=1, dtype=torch.int32) + 1
    return torch.where(pos < cu[-1], ids, torch.zeros_like(ids))


def segment_ids_to_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """[total] ids -> each token's position within its run of equal ids
    (JAX's lax.scan, written as cumulative sums: a run starts where the id
    changes, and a token's position is its index less its run's start)."""
    ids = segment_ids.to(torch.int32)
    idx = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    starts = torch.ones_like(ids, dtype=torch.bool)
    starts[1:] = ids[1:] != ids[:-1]
    run = torch.cumsum(starts.to(torch.int32), dim=0) - 1
    return idx - idx[starts][run]


def seqlens_to_cu_seqlens(seqlens: torch.Tensor) -> torch.Tensor:
    """[b] lengths -> [b+1] cumulative prefix sums."""
    seqlens = seqlens.to(torch.int32)
    zero = torch.zeros((1,), dtype=torch.int32, device=seqlens.device)
    return torch.cat([zero, torch.cumsum(seqlens, dim=0, dtype=torch.int32)])


def pack_sequences(seqs, total: int, head_shape):
    """Pack a list of [s_i, *head_shape] arrays into ([total, *head_shape],
    cu_seqlens, segment_ids), as CPU tensors: a host-side helper for tests
    and data preparation."""
    arrs = [np.asarray(s) for s in seqs]
    lens = [a.shape[0] for a in arrs]
    cu = np.zeros(len(arrs) + 1, np.int32)
    cu[1:] = np.cumsum(lens)
    if cu[-1] > total:
        raise ValueError(f"sequences total {cu[-1]} exceed capacity {total}")
    packed = np.zeros((total, *head_shape), arrs[0].dtype)
    seg = np.zeros(total, np.int32)
    for i, a in enumerate(arrs):
        packed[cu[i]:cu[i + 1]] = a
        seg[cu[i]:cu[i + 1]] = i + 1
    return torch.from_numpy(packed), torch.from_numpy(cu), torch.from_numpy(seg)

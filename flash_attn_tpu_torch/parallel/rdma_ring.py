"""The ring run by one kernel: K11 (``csrc/ring_attn.cu``).

Port of flash_attn_tpu/parallel/rdma_ring.py (``rdma_ring_attention``,
``make_rdma_ring_attention``): forward only, contiguous layout.  JAX runs
one pallas_call a device whose grid walks the ring's steps and pushes the
KV shard to the right neighbour by remote DMA; the port runs the ranks of
one card, n logical ranks, in one cooperative launch of K11, the rank a
coordinate of its work, each rank's KV double buffer in device memory and
the push a device-local copy.  Ranks on more than one device raise:
peer pointers across cards wait for a machine with more than one.

Everything is fp32 (the inputs are taken to fp32, products at fp32
accuracy: ``Precision.HIGHEST`` in JAX, three TF32 passes on the card's
tensor cores in K11), merged by the LSE rule of rdma_ring.py:168-201, and
the output comes back in q's dtype.  CPU shards run the plain version,
``ring_attn_plain``: a loop over ranks and steps in fp32 with the same
merge, independent of K11; CUDA shards launch K11 or raise.
"""

from __future__ import annotations

import ctypes

import torch

from flash_attn_tpu_torch import _build
from flash_attn_tpu_torch.parallel.mesh import SEQUENCE_AXIS, shard, unshard

NEG_INF = float("-inf")
# K11's key tile (csrc/ring_attn.cu kKeys): a slot pads each shard's
# sequence to a multiple of it
KEY_TILE = 64


def ring_attn_plain(qs, ks, vs, causal: bool, scale: float):
    """Plain PyTorch version of K11: each rank's queries against every
    rank's KV shard, step by step around the ring, merged in fp32 as
    rdma_ring.py:168-201 merges.  qs: n tensors [B, S_loc, H, D]; ks, vs:
    n tensors [B, S_loc, Hk, D].  Returns n outputs in q's dtype."""
    n = len(qs)
    B, s_loc, H, D = qs[0].shape
    group = H // ks[0].shape[2]
    rows = torch.arange(s_loc, device=qs[0].device)[:, None]
    diag = torch.arange(s_loc, device=qs[0].device)[None, :] <= rows
    outs = []
    for my in range(n):
        q = qs[my].float().transpose(1, 2)  # [B, H, S_loc, D]
        acc = torch.zeros((B, H, s_loc, D), dtype=torch.float32, device=q.device)
        lse = torch.full((B, H, s_loc, 1), NEG_INF, device=q.device)
        for t in range(n):
            src = (my - t) % n
            if causal and src > my:
                continue
            k = ks[src].float().repeat_interleave(group, dim=2).transpose(1, 2)
            v = vs[src].float().repeat_interleave(group, dim=2).transpose(1, 2)
            s = torch.matmul(q, k.transpose(-1, -2)) * scale
            if causal and src == my:
                s = s.masked_fill(~diag, NEG_INF)
            m = s.amax(dim=-1, keepdim=True)
            alive = m > NEG_INF
            m_safe = torch.where(alive, m, torch.zeros_like(m))
            p = torch.where(alive, torch.exp(s - m_safe), torch.zeros_like(s))
            l = p.sum(dim=-1, keepdim=True)
            o = torch.matmul(p, v)  # unnormalised
            live = alive & (l > 0)
            lse_i = torch.where(live, m_safe + torch.log(torch.clamp(l, min=1e-38)),
                                torch.full_like(l, NEG_INF))
            either = (lse > NEG_INF) | live
            lse_new = torch.where(either, torch.logaddexp(lse, lse_i), lse)
            w_prev = torch.where(lse > NEG_INF, torch.exp(lse - lse_new), torch.zeros_like(l))
            w_i = torch.where(live, torch.exp(m_safe - lse_new), torch.zeros_like(l))
            acc = acc * w_prev + o * w_i
            lse = lse_new
        outs.append(acc.transpose(1, 2).to(qs[my].dtype))
    return outs


def _check_cuda(qs, ks, vs):
    n = len(qs)
    dev = qs[0].device
    if any(x.device != dev for x in (*qs, *ks, *vs)):
        raise ValueError("K11 runs the ranks of one card: its shards are on more than one "
                         "device (peer pointers across cards are not ported)")
    dtype = qs[0].dtype
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K11 takes bf16 or fp32 shards, got {dtype}")
    B, s_loc, H, D = qs[0].shape
    Hk = ks[0].shape[2]
    if D not in (64, 128):
        raise ValueError(f"K11 takes head_dim 64 or 128, got {D}")
    if H % Hk:
        raise ValueError(f"num_heads {H} not divisible by num_heads_k {Hk}")
    for x, shape in ((qs, (B, s_loc, H, D)), (ks, (B, s_loc, Hk, D)), (vs, (B, s_loc, Hk, D))):
        if len(x) != n:
            raise ValueError("K11 takes one q, k and v shard a rank")
        for t in x:
            if (tuple(t.shape) != shape or t.dtype != dtype or not t.is_contiguous()
                    or t.data_ptr() % 16):
                raise ValueError(f"K11 takes contiguous, 16-byte aligned {dtype} shards of "
                                 f"shape {shape}")


def ring_attn_cuda(qs, ks, vs, causal: bool, scale: float):
    """Launch K11 once for the whole ring (replaces
    flash_attn_tpu/parallel/rdma_ring.py:_kernel; bound by operations,
    three TF32 passes on the tensor cores, see csrc/ring_attn.cu).
    Returns n outputs in q's dtype.  ``.grid`` holds the last launch's
    (blocks, blocks an SM)."""
    _check_cuda(qs, ks, vs)
    n = len(qs)
    B, s_loc, H, D = qs[0].shape
    Hk = ks[0].shape[2]
    dev = qs[0].device
    outs = [torch.empty_like(q) for q in qs]
    ptrs = torch.tensor([t.data_ptr() for t in (*qs, *ks, *vs, *outs)], dtype=torch.int64,
                        device=dev)
    # each rank's two slots: K and V^T as TF32 hi and lo planes, 4 B Hk s_pad
    # D floats a slot (csrc/ring_attn.cu, stage)
    s_pad = -(-s_loc // KEY_TILE) * KEY_TILE
    slots = torch.empty((n, 2, 4, B, Hk, s_pad, D), dtype=torch.float32, device=dev)
    acc = torch.empty((n, B, H, s_loc, D), dtype=torch.float32, device=dev)
    lse = torch.empty((n, B, H, s_loc), dtype=torch.float32, device=dev)
    counters = torch.empty((2 * n * n,), dtype=torch.int32, device=dev)
    info = (ctypes.c_int * 2)()
    p = _build.ptr
    rc = _build.lib().fatt_ring_attn(
        p(ptrs), p(slots), p(acc), p(lse), p(counters), n, B, s_loc, H, Hk, D,
        int(qs[0].dtype == torch.bfloat16), int(causal), float(scale), info, _build.stream())
    _build.check(rc, "fatt_ring_attn")
    ring_attn_cuda.launches += 1
    ring_attn_cuda.grid = (info[0], info[1])
    return outs


ring_attn_cuda.launches = 0
ring_attn_cuda.grid = None


def rdma_ring_attention(qs, ks, vs, *, causal: bool = False, scale: float | None = None,
                        block_q: int = 128):
    """The ranks' shards in, the ranks' output shards out (the body JAX
    runs under shard_map).  qs: n tensors [B, S_loc, H, D]; ks, vs: n
    tensors [B, S_loc, Hk, D].  S_loc must be a multiple of
    min(block_q, S_loc), as JAX requires (K11's own tile is 64 rows and
    takes any S_loc).  Forward only."""
    s_loc, D = qs[0].shape[1], qs[0].shape[3]
    bq = min(block_q, s_loc)
    if s_loc % bq:
        raise ValueError(f"S_loc {s_loc} not divisible by block_q {bq}")
    scale = D ** -0.5 if scale is None else float(scale)
    on_card = [x.is_cuda for x in (*qs, *ks, *vs)]
    if any(on_card) and not all(on_card):
        raise ValueError("rdma ring: shards on the CPU and on the card")
    if all(on_card):
        return ring_attn_cuda(qs, ks, vs, causal, scale)
    return ring_attn_plain(qs, ks, vs, causal, scale)


def make_rdma_ring_attention(mesh, *, axis_name: str = SEQUENCE_AXIS, causal: bool = False,
                             scale: float | None = None, block_q: int = 128):
    """fn(q, k, v) on global [B, S, H, D] / [B, S, Hk, D] tensors split
    over ``axis_name``: forward only, contiguous layout."""
    spec = (None, axis_name, None, None)

    def fn(q, k, v):
        qs, ks, vs = (shard(mesh, x, spec) for x in (q, k, v))
        outs = rdma_ring_attention(qs, ks, vs, causal=causal, scale=scale, block_q=block_q)
        return unshard(mesh, outs, spec, q.device)

    return fn

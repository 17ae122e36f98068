"""Paged KV-cache pool and paged decode attention.

Port of flash_attn_tpu/engine/paged.py:PagedKVPool.  The pool holds
fixed-size pages in the heads-major layout [num_pages, Hk, page, D]; each
sequence owns a row of the block table [max_pages] of page ids, and
attention reads the pages through the table (K8, ops/paged_decode.py)
without gathering them.  The JAX pool is a functional pytree; this one is
updated IN PLACE: ``assign_pages``, ``set_lengths``, ``set_length``,
``advance`` and the appends mutate the buffers and return ``self``.

  k_pages, v_pages: L lists of [num_pages, Hk, page, D] (int8 /
                    float8_e4m3fn / model dtype); page 0 is the null page
  k_scale, v_scale: L lists of [num_pages, Hk, page] fp32 in natural
                    position order (None for mode 'none')
  block_table:      [B, max_pages] int32 page ids (0 = unassigned)
  length:           [B] int32 tokens in cache

The appends are plain PyTorch (quantize, then an indexed write), as the
JAX appends are XLA scatters.  A page index past the table's end is
clamped to its last entry, as JAX's gather clamps it: the engine advances
every slot each decode step, and an idle slot (table row all zeros) whose
length has run past its capacity then writes onto the null page.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from flash_attn_tpu_torch._device import resolve_device
from flash_attn_tpu_torch.engine.kv_cache import store_dtype
from flash_attn_tpu_torch.ops.paged_decode import paged_flash_decode
from flash_attn_tpu_torch.ops.quant import quantize_kv


def _bytes(t):
    """A view that indexed writes take for every storage type (fp8 as
    bytes)."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


@dataclass
class PagedKVPool:
    k_pages: list
    v_pages: list
    k_scale: list | None
    v_scale: list | None
    block_table: torch.Tensor
    length: torch.Tensor
    mode: str = "none"

    @property
    def page_size(self) -> int:
        return self.k_pages[0].shape[2]

    @property
    def num_pages(self) -> int:
        return self.k_pages[0].shape[0]

    @property
    def max_pages(self) -> int:
        return self.block_table.shape[1]

    @classmethod
    def create(cls, num_layers, num_pages, page_size, batch, max_pages,
               num_kv_heads, head_dim, dtype=torch.bfloat16, mode: str = "none",
               device=None):
        """Zeroed pool on ``device`` (default: the card)."""
        dev = resolve_device(device)
        store = store_dtype(mode, dtype)
        shape = (num_pages, num_kv_heads, page_size, head_dim)
        k = [torch.zeros(shape, dtype=store, device=dev) for _ in range(num_layers)]
        v = [torch.zeros(shape, dtype=store, device=dev) for _ in range(num_layers)]
        ks = vs = None
        if mode != "none":
            sshape = (num_pages, num_kv_heads, page_size)
            ks = [torch.ones(sshape, device=dev) for _ in range(num_layers)]
            vs = [torch.ones(sshape, device=dev) for _ in range(num_layers)]
        table = torch.zeros((batch, max_pages), dtype=torch.int32, device=dev)
        length = torch.zeros((batch,), dtype=torch.int32, device=dev)
        return cls(k, v, ks, vs, table, length, mode)

    # -- host-side bookkeeping (the engine's allocator owns the free list) --

    def assign_pages(self, slot: int, page_ids) -> "PagedKVPool":
        """Install page ids at the start of ``slot``'s table row.  On the
        card the ids go from pinned memory without a sync, so a release
        does not wait for the decode burst in flight (on one stream the
        write lands after it)."""
        ids = torch.as_tensor(list(page_ids), dtype=torch.int32)
        if self.block_table.is_cuda:
            ids = ids.pin_memory()
        self.block_table[slot, :len(ids)] = ids.to(self.block_table.device, non_blocking=True)
        return self

    def set_lengths(self, lengths) -> "PagedKVPool":
        self.length.copy_(torch.as_tensor(lengths, dtype=torch.int32))
        return self

    def set_length(self, slot: int, value: int) -> "PagedKVPool":
        self.length[slot] = value
        return self

    def advance(self, t: int = 1) -> "PagedKVPool":
        self.length += t
        return self

    # -- device-side writes --

    def _write(self, layer, pages, offs, kq, ks, vq, vs):
        """Write quantized [N, Hk, D] rows (and [N, Hk, 1] scales) at
        (pages[i], offs[i]) of layer ``layer``."""
        for buf, new in ((self.k_pages[layer], kq), (self.v_pages[layer], vq)):
            # the advanced indices (pages, offs) around ':' put N in front
            _bytes(buf)[pages, :, offs] = _bytes(new.to(buf.dtype))
        if ks is not None:
            self.k_scale[layer][pages, :, offs] = ks[..., 0].float()
            self.v_scale[layer][pages, :, offs] = vs[..., 0].float()

    def append_token(self, layer: int, new_k, new_v) -> "PagedKVPool":
        """Write one token per sequence, new_k/new_v [B, Hk, D], at
        position ``length`` of each (page = table[length // page], offset
        = length % page).  Does not advance ``length``."""
        kq, ks, vq, vs = quantize_kv(new_k, new_v, self.mode)
        length = self.length.long()
        idx = torch.clamp(length // self.page_size, max=self.max_pages - 1)
        rows = torch.arange(self.block_table.shape[0], device=length.device)
        pages = self.block_table[rows, idx].long()
        self._write(layer, pages, length % self.page_size, kq, ks, vq, vs)
        return self

    def append_prefill(self, layer: int, slot: int, new_k, new_v,
                       start: int) -> "PagedKVPool":
        """Write a whole segment for one slot: new_k/new_v [T, Hk, D] at
        positions [start, start + T) of sequence ``slot``."""
        kq, ks, vq, vs = quantize_kv(new_k, new_v, self.mode)
        pos = start + torch.arange(new_k.shape[0], device=self.block_table.device)
        idx = torch.clamp(pos // self.page_size, max=self.max_pages - 1)
        pages = self.block_table[slot, idx].long()
        self._write(layer, pages, pos % self.page_size, kq, ks, vq, vs)
        return self

    # -- correctness oracles --

    def _gather_scales(self, buf, table):
        """[..., mp] table -> [..., mp * page, Hk] scales."""
        picked = buf[table.long()]  # [..., mp, Hk, page]
        moved = picked.transpose(-1, -2)  # [..., mp, page, Hk]
        return moved.reshape(*moved.shape[:-3], -1, moved.shape[-1])

    def _gather_pages(self, buf, table):
        """[..., mp] table -> [..., mp * page, Hk, D] stored values."""
        picked = _bytes(buf)[table.long()]  # [..., mp, Hk, page, D]
        moved = picked.transpose(-3, -2)  # [..., mp, page, Hk, D]
        out = moved.reshape(*moved.shape[:-4], -1, *moved.shape[-2:])
        return out.view(buf.dtype) if buf.dtype == torch.float8_e4m3fn else out

    def gather_slot(self, layer: int, slot: int, dtype=torch.float32):
        """One slot's contiguous dequantized KV [1, mp * page, Hk, D]."""
        table = self.block_table[slot]
        k = self._gather_pages(self.k_pages[layer], table).float()
        v = self._gather_pages(self.v_pages[layer], table).float()
        if self.mode != "none":
            k = k * self._gather_scales(self.k_scale[layer], table)[..., None]
            v = v * self._gather_scales(self.v_scale[layer], table)[..., None]
        return k.to(dtype)[None], v.to(dtype)[None]

    def gather_layer(self, layer: int):
        """Contiguous views of every sequence: k, v [B, mp * page, Hk, D]
        as stored, scales [B, mp * page, Hk, 1] (None for mode 'none')."""
        k = self._gather_pages(self.k_pages[layer], self.block_table)
        v = self._gather_pages(self.v_pages[layer], self.block_table)
        if self.mode == "none":
            return k, v, None, None
        ks = self._gather_scales(self.k_scale[layer], self.block_table)[..., None]
        vs = self._gather_scales(self.v_scale[layer], self.block_table)[..., None]
        return k, v, ks, vs


def paged_decode_attention(pool: PagedKVPool, layer: int, q, *,
                           kv_length=None, scale=None, window=None,
                           softmax_mode=None, logit_softcap=None):
    """q [B, H, D] -> out [B, H, D] attending to the paged cache through
    K8 (no gather).  kv_length defaults to ``pool.length``."""
    return paged_flash_decode(
        q, pool.k_pages[layer], pool.v_pages[layer], pool.block_table,
        pool.length if kv_length is None else kv_length,
        k_scale=None if pool.k_scale is None else pool.k_scale[layer],
        v_scale=None if pool.v_scale is None else pool.v_scale[layer],
        scale=scale, window=window, softmax_mode=softmax_mode,
        logit_softcap=logit_softcap)

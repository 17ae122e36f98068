"""KV-cache state: per-layer BHSD caches with optional INT8/FP8
quantize-on-append.

Port of flash_attn_tpu/engine/kv_cache.py:KVCache.  The JAX cache is a
functional pytree; this one is updated IN PLACE: ``append``,
``insert_at``, ``advance`` and ``set_length`` mutate the buffers and
return ``self`` so that call sites read like the JAX ones.

  k, v:             L lists of [B, Hk, S, D] (int8 / float8_e4m3fn / model dtype)
  k_scale, v_scale: L lists of [B, Hk, S] fp32 in natural position order
                    (None for mode 'none')
  length:           [B] int32 valid entries per sequence
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from flash_attn_tpu_torch._device import resolve_device
from flash_attn_tpu_torch.ops.kv_append import kv_append_token
from flash_attn_tpu_torch.ops.quant import quantize_kv

_STORE = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def store_dtype(mode: str, dtype) -> torch.dtype:
    """The element type a cache of ``mode`` stores: int8 or fp8 for the
    quantized modes, ``dtype`` for 'none'."""
    if mode == "none":
        return dtype
    if mode not in _STORE:
        raise ValueError(f"unknown kv cache mode {mode!r}")
    return _STORE[mode]


@dataclass
class KVCache:
    k: list
    v: list
    k_scale: list | None
    v_scale: list | None
    length: torch.Tensor
    mode: str = "none"

    @property
    def num_layers(self) -> int:
        return len(self.k)

    @property
    def capacity(self) -> int:
        return self.k[0].shape[2]

    @classmethod
    def create(cls, num_layers, batch, capacity, num_kv_heads, head_dim,
               dtype=torch.bfloat16, mode: str = "none", device=None):
        """Zeroed cache on ``device`` (default: the card)."""
        dev = resolve_device(device)
        store = store_dtype(mode, dtype)
        shape = (batch, num_kv_heads, capacity, head_dim)
        k = [torch.zeros(shape, dtype=store, device=dev) for _ in range(num_layers)]
        v = [torch.zeros(shape, dtype=store, device=dev) for _ in range(num_layers)]
        ks = vs = None
        if mode != "none":
            sshape = (batch, num_kv_heads, capacity)
            ks = [torch.ones(sshape, device=dev) for _ in range(num_layers)]
            vs = [torch.ones(sshape, device=dev) for _ in range(num_layers)]
        length = torch.zeros((batch,), dtype=torch.int32, device=dev)
        return cls(k, v, ks, vs, length, mode)

    def append(self, layer: int, new_k: torch.Tensor,
               new_v: torch.Tensor) -> "KVCache":
        """Insert [B, T, Hk, D] entries at position ``length`` of every
        sequence, in place.  Does not advance ``length``: call advance()
        once after all layers.  T == 1 (the decode path) runs K2, which
        skips sequences whose length has reached the capacity.  T > 1 (the
        verify step) quantizes with plain PyTorch and reproduces, on
        purpose, what JAX's append does to a sequence that does not fit (an
        idle slot keeps advancing): the values land at the start clamped to
        capacity - T, as ``dynamic_update_slice`` clamps it, while each
        scale goes to its own position and is dropped past the capacity, as
        JAX's scatter drops it.  No length is read back to the host."""
        ks = None if self.k_scale is None else self.k_scale[layer]
        vs = None if self.v_scale is None else self.v_scale[layer]
        if new_k.shape[1] == 1:
            kv_append_token(
                self.k[layer], self.v[layer], ks, vs,
                new_k[:, 0].contiguous(), new_v[:, 0].contiguous(),
                self.length, mode=self.mode)
            return self
        B, t = new_k.shape[:2]
        cap = self.capacity
        kq, ksn, vq, vsn = quantize_kv(new_k, new_v, self.mode)
        dev = self.length.device
        start = self.length.long()[:, None]
        steps = torch.arange(t, device=dev)[None]
        rows = torch.arange(B, device=dev)[:, None]
        vpos = torch.clamp(start, 0, cap - t) + steps  # [B, T], distinct per row
        for buf, new in ((self.k[layer], kq), (self.v[layer], vq)):
            if buf.dtype == torch.float8_e4m3fn:
                buf.view(torch.uint8)[rows, :, vpos] = new.view(torch.uint8)
            else:
                buf[rows, :, vpos] = new.to(buf.dtype)
        if ks is not None:
            # a dropped scale is written to the last position instead, with
            # the value that position gets (or already holds), so that no
            # two writes to one place differ
            last = torch.clamp(start + steps, max=cap - 1)
            src = torch.clamp(last - start, 0, t - 1)
            keep_old = (start >= cap)[..., None]
            for buf, new in ((ks, ksn), (vs, vsn)):
                val = torch.gather(new[..., 0], 1, src[..., None].expand(B, t, new.shape[2]))
                buf[rows, :, last] = torch.where(keep_old, buf[:, None, :, cap - 1], val)
        return self

    def _put(self, layer, slot, start, kq, vq, ks, vs):
        """Write one sequence's quantized [T, Hk, D] entries (and [T, Hk, 1]
        scales) at ``start``; either pair may be None."""
        for buf, new in ((self.k[layer], kq), (self.v[layer], vq)):
            if new is None:
                continue
            dst = buf[slot, :, start:start + new.shape[0]]
            if buf.dtype == torch.float8_e4m3fn:
                dst.view(torch.uint8).copy_(new.transpose(0, 1).view(torch.uint8))
            else:
                dst.copy_(new.transpose(0, 1))
        if ks is not None:
            t = ks.shape[0]
            self.k_scale[layer][slot, :, start:start + t] = ks[..., 0].transpose(0, 1)
            self.v_scale[layer][slot, :, start:start + t] = vs[..., 0].transpose(0, 1)

    def insert_prompt(self, layer: int, slot: int, k: torch.Tensor,
                      v: torch.Tensor) -> "KVCache":
        """Quantize a whole prompt's [S, Hk, D] K/V and write it at
        position 0 of ``slot`` (the engine's prefill write), in place."""
        kq, ks, vq, vs = quantize_kv(k, v, self.mode)
        self._put(layer, slot, 0, kq, vq, ks, vs)
        return self

    def insert_at(self, layer: int, slot: int, k: torch.Tensor, v: torch.Tensor,
                  start: int) -> "KVCache":
        """Quantize one sequence's [T, Hk, D] K/V and write it at ``start``
        of ``slot`` (the chunked prefill's write), in place; ``length`` is
        left to the caller.  As JAX's ``dynamic_update_slice`` does, values
        that do not fit land at a start clamped to capacity - T, while each
        scale goes to its own position and is dropped past the capacity."""
        kq, ks, vq, vs = quantize_kv(k, v, self.mode)
        t, cap = kq.shape[0], self.capacity
        self._put(layer, slot, min(max(start, 0), cap - t), kq, vq, None, None)
        if ks is not None:
            n = max(0, min(t, cap - start))
            self._put(layer, slot, start, None, None, ks[:n], vs[:n])
        return self

    def scatter_rows(self, layer: int, slots: torch.Tensor, positions: torch.Tensor,
                     kq, vq, ks, vs) -> "KVCache":
        """Write quantized rows [N, Hk, D] (scales [N, Hk, 1]) to (slots[i],
        positions[i]), in place: the packed prefill's write of its real
        rows."""
        for buf, new in ((self.k[layer], kq), (self.v[layer], vq)):
            if buf.dtype == torch.float8_e4m3fn:
                buf.view(torch.uint8)[slots, :, positions] = new.view(torch.uint8)
            else:
                buf[slots, :, positions] = new.to(buf.dtype)
        if ks is not None:
            self.k_scale[layer][slots, :, positions] = ks[..., 0]
            self.v_scale[layer][slots, :, positions] = vs[..., 0]
        return self

    def slot_kv_float(self, layer: int, slot: int, dtype=torch.bfloat16):
        """Dequantized [1, S_cap, Hk, D] copies of one slot's K and V (the
        chunked prefill's read): the fp32 product of values and scales,
        then a cast to ``dtype``, as JAX forms them."""
        def get(buf, scale):
            x = buf[slot:slot + 1].float()
            if scale is not None:
                x = x * scale[slot:slot + 1, :, :, None]
            return x.to(dtype).transpose(1, 2).contiguous()

        ks = None if self.k_scale is None else self.k_scale[layer]
        vs = None if self.v_scale is None else self.v_scale[layer]
        return get(self.k[layer], ks), get(self.v[layer], vs)

    def advance(self, t: int = 1) -> "KVCache":
        self.length += t
        return self

    def set_length(self, slot: int, value: int) -> "KVCache":
        self.length[slot] = value
        return self

    def layer(self, i: int):
        """(k, v, k_scale, v_scale) of layer i: the buffers themselves."""
        ks = None if self.k_scale is None else self.k_scale[i]
        vs = None if self.v_scale is None else self.v_scale[i]
        return self.k[i], self.v[i], ks, vs

"""Inference engines: continuous batching over prefill (one prompt, a
packed batch of prompts, or chunks) and a batched decode step, or bursts
of decode steps.

Port of flash_attn_tpu/engine/engine.py for the plain paths, packed and
chunked prefill, decode bursts and greedy speculative decoding:
``InferenceEngine`` (a contiguous KV cache, with n-gram or draft-model
speculation through the model's ``decode_multi``) and
``PagedInferenceEngine`` (a paged KV pool, admission gated by the native
page allocator, optional automatic prefix caching).  ``InferenceEngine``
packs the prompts it admits in one step into one varlen prefill (the
model's ``prefill_packed``) when there are two or more and they fit the
capacity, and with ``prefill_chunk_size`` feeds a long prompt through
``prefill_chunk`` in pieces with decode steps for the other slots in
between; otherwise, and always in ``PagedInferenceEngine``, it prefills
one prompt per call, padded to its bucket.  Both decode one token (or one
verify round) for every slot per step, or ``decode_burst`` tokens per
dispatch (idle slots are masked by kv_length and ignored by the
scheduler).  A burst chains the next one off its last tokens on the card
before the host reads it back, as JAX chains off its device-resident
carry.  LoRA banks and meshes are still to port and raise
``NotImplementedError``.

The bodies JAX jits (the decode step, the burst, the draft scan, the
verify step) are ``GraphBody``s (engine/_graph.py): replayed from CUDA
graphs on the card, plain calls on the CPU and under ``disable_graphs()``.
The KV caches and pool are updated in place, so every replay finds them
where it was captured.  Prefill runs eagerly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from flash_attn_tpu_torch._device import resolve_device
from flash_attn_tpu_torch.engine._graph import GraphBody, tensor_versions
from flash_attn_tpu_torch.engine.kv_cache import KVCache
from flash_attn_tpu_torch.engine.paged import PagedKVPool
from flash_attn_tpu_torch.engine.prefix_cache import PrefixCache
from flash_attn_tpu_torch.engine.sampler import SamplingParams, sample
from flash_attn_tpu_torch.engine.scheduler import (
    ContinuousBatchingScheduler,
    Request,
    bucket_length,
)
from flash_attn_tpu_torch.ops.quant import quantize_kv
from flash_attn_tpu_torch.runtime.abi import PagePool
from flash_attn_tpu_torch.utils.metrics import EngineMetrics


@dataclass
class SpecConfig:
    """Speculative decoding, greedy only (flash_attn_tpu/engine/engine.py:
    34-63): each round proposes ``num_draft`` tokens per slot and verifies
    [current token, drafts] in ONE ``decode_multi`` call; the longest
    draft prefix that agrees with the greedy argmax is accepted, plus the
    model's own correction token, so greedy output is unchanged.

    Drafts come from an n-gram lookup in the request's history (prompt +
    generated) by default, or from a draft model over the same vocabulary
    when ``draft_params`` and ``draft_adapter`` are set: the engine keeps
    the draft's own KV cache (unquantized), prefills it at admission and
    runs num_draft + 1 greedy draft steps per round (the last appends the
    last draft's KV, so both caches hold the same K + 1 new entries and
    roll back to the same length)."""

    num_draft: int = 4
    ngram: int = 2
    draft_params: object = None
    draft_adapter: object = None  # ModelAdapter of the draft model


def _ngram_draft(history: list[int], n: int, k: int) -> list[int]:
    """Prompt-lookup draft: continue the most recent prior occurrence of
    the trailing n-gram; the fallback repeats the last token."""
    if len(history) > n:
        pat = history[-n:]
        for j in range(len(history) - n - 1, -1, -1):
            if history[j:j + n] == pat:
                cont = history[j + n:j + n + k]
                if cont:
                    return (cont + [cont[-1]] * k)[:k]
    return [history[-1]] * k


@dataclass
class ModelAdapter:
    """What the engine needs from a model family."""

    # (params, tokens [1, S], positions [1, S]) -> (logits [1, S, V],
    #  kvs: list of (k, v) [1, S, Hk, D] per layer)
    prefill_with_kv: Callable
    # (params, token [B], cache) -> (logits [B, V], cache)
    decode_step: Callable
    num_layers: int
    num_kv_heads: int
    head_dim: int
    eos_token: int | None = None
    # speculative verify step: (params, tokens [B, T], cache) -> (logits
    # [B, T, V], cache); appends all T tokens' KV and advances by T
    decode_multi: Callable | None = None
    # chunked prefill: (params, tokens [1, C], cache, slot, start) ->
    # (logits [1, C, V], cache), the chunk's KV written at [start, start+C)
    prefill_chunk: Callable | None = None
    # packed prefill: (params, tokens [1, T], positions [1, T], segment_ids
    # [1, T]) -> (logits [1, T, V], kvs: list of (k, v) [1, T, Hk, D])
    prefill_packed: Callable | None = None
    # paged decode: (params, token [B], pool: PagedKVPool) -> (logits
    # [B, V], pool), used by PagedInferenceEngine
    decode_step_paged: Callable | None = None
    # prefix-cache suffix prefill: (params, tokens [1, C], pool, slot,
    # start) -> (logits [1, C, V], pool)
    prefill_suffix_paged: Callable | None = None


class InferenceEngine:
    def __init__(self, params, adapter: ModelAdapter, *, max_batch: int = 8,
                 capacity: int = 2048, kv_mode: str = "none",
                 cache_dtype=torch.bfloat16,
                 sampling: SamplingParams | None = None, rng_seed: int = 0,
                 device=None, prefill_chunk_size: int | None = None,
                 spec=None, mesh=None, lora_bank=None, decode_burst: int = 1):
        """device: where the caches live and the steps run (default: the
        card); it must be where ``params`` (and a draft's params) are.
        spec: a SpecConfig; it speculates when sampling is greedy.
        decode_burst: decode up to this many tokens per slot in one
        dispatch (flash_attn_tpu/engine/engine.py:137-147): a burst fires
        only when nothing waits and every active slot has one burst of KV
        headroom; a slot that ends mid-burst discards its tail.
        prefill_chunk_size: feed prompts longer than this through the
        model's ``prefill_chunk`` in pieces of this size, a decode step for
        the other slots between pieces (JAX's fix for head-of-line
        blocking); None unless the adapter has ``prefill_chunk``."""
        if spec is not None:
            _check_spec(spec, adapter, mesh, prefill_chunk_size)
        unported = {"mesh": mesh is not None, "lora_bank": lora_bank is not None}
        for name, used in unported.items():
            if used:
                raise NotImplementedError(f"{name} is not ported yet")
        self.decode_burst = max(1, int(decode_burst))
        if self.decode_burst > 1 and spec is not None:
            raise ValueError("decode_burst does not compose with speculative decoding")
        self.device = resolve_device(device)
        self.params = params
        self.adapter = adapter
        self.capacity = capacity
        self.sampling = sampling or SamplingParams()
        self.sched = ContinuousBatchingScheduler(max_batch)
        self.cache = KVCache.create(
            adapter.num_layers, max_batch, capacity, adapter.num_kv_heads,
            adapter.head_dim, dtype=cache_dtype, mode=kv_mode,
            device=self.device,
        )
        self.spec = spec
        self.draft_cache = None
        if spec is not None and spec.draft_adapter is not None:
            da = spec.draft_adapter
            # the draft's own cache, unquantized (the draft is small; its
            # exactness keeps acceptance high)
            self.draft_cache = KVCache.create(
                da.num_layers, max_batch, capacity, da.num_kv_heads,
                da.head_dim, dtype=cache_dtype, mode="none", device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.next_token = np.zeros((max_batch,), np.int64)
        # host mirror of cache.length (prefill sets it, decode advances every
        # slot), so the loop never reads the lengths back from the device
        self._host_lens = np.zeros((max_batch,), np.int64)
        self.metrics = EngineMetrics(kv_capacity=max_batch * capacity)
        # one chained in-flight burst: (its tokens, slot -> request at dispatch)
        self._inflight = None
        self._readback = _BurstReadback((self.decode_burst, max_batch), self.device)
        # chunked prefill bounds how long a prompt stalls the decode batch;
        # slots mid-way through it take no decode tokens
        self.prefill_chunk_size = (
            prefill_chunk_size if adapter.prefill_chunk is not None else None)
        self._prefilling: set[int] = set()
        self.packed_prefills = 0  # calls of the packed prefill
        draft_params = self.spec.draft_params if self.draft_cache is not None else None

        def body(fn, stochastic=True):
            return GraphBody(
                fn, self.device,
                buffers=lambda: _cache_buffers(self.cache) + _cache_buffers(self.draft_cache),
                watch=lambda: tensor_versions(self.params, draft_params),
                generator=self.generator if stochastic and self.sampling.temperature > 0 else None)

        self._decode_jit = body(self._decode_batch)
        self._burst_jit = body(self._decode_burst_body)
        self._draft_scan_jit = body(self._draft_scan, stochastic=False)
        self._verify_jit = body(self._verify, stochastic=False)

    # --- the bodies JAX jits, captured on the card ---

    def _decode_batch(self, tokens):
        """One decode step for every slot: tokens [B] -> sampled [B].  With
        a draft model under greedy sampling (speculation fell back to a
        plain step) the draft cache takes the same tokens, so both caches
        stay in lockstep (JAX's ``_draft_sync_jit``)."""
        logits, self.cache = self.adapter.decode_step(self.params, tokens, self.cache)
        if self.draft_cache is not None and self.sampling.temperature == 0.0:
            _, self.draft_cache = self.spec.draft_adapter.decode_step(
                self.spec.draft_params, tokens, self.draft_cache)
        return sample(logits, self.generator, self.sampling)

    def _decode_burst_body(self, tokens):
        """decode_burst steps, each feeding its sampled tokens to the next
        (JAX's lax.scan): tokens [B] -> sampled [burst, B]."""
        toks = []
        for _ in range(self.decode_burst):
            logits, self.cache = self.adapter.decode_step(self.params, tokens, self.cache)
            tokens = sample(logits, self.generator, self.sampling)
            toks.append(tokens)
        return torch.stack(toks)

    def _draft_scan(self, tokens):
        """num_draft + 1 greedy draft decode steps from ``tokens`` [B]:
        returns the drafts [B, K].  The last step's logits are discarded;
        it appends the last draft's KV, so the draft cache holds the same
        K + 1 new entries as the verified target cache."""
        drafts = []
        for _ in range(self.spec.num_draft + 1):
            logits, self.draft_cache = self.spec.draft_adapter.decode_step(
                self.spec.draft_params, tokens, self.draft_cache)
            tokens = torch.argmax(logits, dim=-1)
            drafts.append(tokens)
        return torch.stack(drafts[:-1], dim=1)

    def _verify(self, tok_in):
        """The verify step: [current, drafts] [B, K+1] through one
        decode_multi -> the greedy tokens [B, K+1]."""
        logits, self.cache = self.adapter.decode_multi(self.params, tok_in, self.cache)
        return torch.argmax(logits, dim=-1)

    # --- host loop ---

    def submit(self, prompt, max_tokens=64) -> Request:
        return self.sched.submit(prompt, max_tokens, self.adapter.eos_token)

    def cancel(self, req: Request) -> bool:
        return self.sched.cancel(req)

    def run(self, max_steps: int = 10_000) -> None:
        """Drive until all submitted work completes."""
        steps = 0
        while self.sched.has_work and steps < max_steps:
            steps += 1
            if self._inflight is not None and not self.sched.active:
                # every request of the in-flight burst has completed or
                # been cancelled: its tokens are dead (its appends are
                # already booked in _host_lens)
                self._inflight = None
            admitted = self.sched.admit()
            if (len(admitted) >= 2 and self.adapter.prefill_packed is not None
                    and self.prefill_chunk_size is None
                    and sum(len(r.prompt) for r in admitted) <= self.capacity):
                # several prompts through one varlen prefill
                self._do_prefill_packed(admitted)
            else:
                for req in admitted:
                    self._do_prefill(req)
            if self.sched.active:
                self._do_decode_step()

    def _prefill_one(self, tokens, slot: int, true_len: int):
        """Run the model on one padded prompt, write its KV into ``slot``
        and return the logits at its last real token.  With a draft model
        its cache gets the prompt's KV and length too."""
        positions = torch.arange(tokens.shape[1], device=self.device)[None]
        logits_all, kvs = self.adapter.prefill_with_kv(
            self.params, tokens, positions)
        for layer, (k, v) in enumerate(kvs):
            _insert_slot_kv(self.cache, layer, slot, k[0], v[0])
        self.cache.set_length(slot, true_len)
        self._draft_prefill(tokens, slot, true_len)
        return logits_all[0, true_len - 1]

    def _draft_prefill(self, tokens, slot: int, true_len: int):
        """With a draft model: its cache gets the padded prompt's KV and
        length (its first proposal comes from its decode step, seeded by
        the target's first token)."""
        if self.draft_cache is None:
            return
        positions = torch.arange(tokens.shape[1], device=self.device)[None]
        _, kvs = self.spec.draft_adapter.prefill_with_kv(
            self.spec.draft_params, tokens, positions)
        for layer, (k, v) in enumerate(kvs):
            _insert_slot_kv(self.draft_cache, layer, slot, k[0], v[0])
        self.draft_cache.set_length(slot, true_len)

    def _padded(self, tokens, bucket: int) -> torch.Tensor:
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :len(tokens)] = tokens
        return torch.from_numpy(toks).to(self.device)

    def _do_prefill(self, req: Request):
        t0 = time.perf_counter()
        if self.prefill_chunk_size is not None and len(req.prompt) > self.prefill_chunk_size:
            logits = self._chunked_prefill(req)
        else:
            bucket = min(bucket_length(len(req.prompt)), self.capacity)
            logits = self._prefill_one(self._padded(req.prompt, bucket), req.slot,
                                       len(req.prompt))
        tok = int(sample(logits[None], self.generator, self.sampling)[0])
        self._host_lens[req.slot] = len(req.prompt)
        self.metrics.record_prefill(len(req.prompt), time.perf_counter() - t0)
        self._first_token(req, tok)

    def _first_token(self, req: Request, tok: int):
        """Record a request's first generated token (from its prefill)."""
        req.generated.append(tok)
        if len(req.generated) >= req.max_tokens or (
            req.eos_token is not None and tok == req.eos_token
        ):
            self.sched.complete(req)
            self.metrics.completed_requests += 1
        else:
            self.next_token[req.slot] = tok

    def _do_prefill_packed(self, reqs):
        """Pack the prompts of ``reqs`` into one varlen prefill call: one
        [1, bucket] row, segment ids 1, 2, ... a prompt and positions
        restarting at 0 a prompt (0 for padding).  The draft cache, if any,
        is still filled one request per call."""
        t0 = time.perf_counter()
        self.packed_prefills += 1
        total = sum(len(r.prompt) for r in reqs)
        bucket = min(bucket_length(total), self.capacity)
        tokens = np.zeros((1, bucket), np.int64)
        segids = np.zeros((1, bucket), np.int32)
        positions = np.zeros((1, bucket), np.int32)
        slot_map = np.zeros((total,), np.int64)  # (slot, position) of each real row
        ends = np.zeros((self.next_token.shape[0],), np.int64)
        off = 0
        for i, r in enumerate(reqs):
            n = len(r.prompt)
            tokens[0, off:off + n] = r.prompt
            segids[0, off:off + n] = i + 1
            positions[0, off:off + n] = np.arange(n)
            slot_map[off:off + n] = r.slot
            ends[i] = off + n
            off += n
        last = self._prefill_packed_body(tokens, positions, segids, slot_map, ends)
        for r in reqs:
            self.cache.set_length(r.slot, len(r.prompt))
            self._draft_prefill(
                self._padded(r.prompt, min(bucket_length(len(r.prompt)), self.capacity)),
                r.slot, len(r.prompt))
        toks = [int(sample(last[i][None], self.generator, self.sampling)[0])
                for i in range(len(reqs))]
        self.metrics.record_prefill(total, time.perf_counter() - t0)
        for req, tok in zip(reqs, toks):
            self._host_lens[req.slot] = len(req.prompt)
            self._first_token(req, tok)

    def _prefill_packed_body(self, tokens, positions, segids, slot_map, ends):
        """The model on the packed row; each layer's K/V quantized once and
        its real rows (the first len(slot_map)) written to (slot_map,
        position); the padding rows are dropped, as JAX's ``mode="drop"``
        drops them.  Returns the logits at each request's last row,
        [max_b, V] (entries past the requests read row 0, as JAX's
        ``max(ends - 1, 0)``)."""
        dev = self.device
        logits_all, kvs = self.adapter.prefill_packed(
            self.params, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(positions).to(dev), torch.from_numpy(segids).to(dev))
        n = len(slot_map)
        slots = torch.from_numpy(slot_map).to(dev)
        pos = torch.from_numpy(positions[0, :n].astype(np.int64)).to(dev)
        for layer, (k, v) in enumerate(kvs):
            kq, ks, vq, vs = quantize_kv(k[0, :n], v[0, :n], self.cache.mode)
            self.cache.scatter_rows(layer, slots, pos, kq, vq, ks, vs)
        return logits_all[0, torch.from_numpy(np.maximum(ends - 1, 0)).to(dev)]

    def _chunked_prefill(self, req: Request):
        """Feed the prompt through ``prefill_chunk`` in pieces of
        prefill_chunk_size, a decode step for the other active slots
        between pieces, so a long prompt does not block decoding.

        The device length stays at the chunk frontier, so a decode step in
        between appends its token for this slot inside the range the next
        chunk rewrites (every chunk writes its whole padded [start, start +
        C)), and the final set_length masks the tail."""
        C = self.prefill_chunk_size
        prompt, slot = req.prompt, req.slot
        self._prefilling.add(slot)
        pos = 0
        logits = None
        while pos < len(prompt):
            chunk = prompt[pos:pos + C]
            logits_all, self.cache = self.adapter.prefill_chunk(
                self.params, self._padded(chunk, C), self.cache, slot, pos)
            logits = logits_all[0, len(chunk) - 1]
            self.cache.set_length(slot, pos + len(chunk))
            self._host_lens[slot] = pos + len(chunk)
            pos += len(chunk)
            if pos < len(prompt):
                self._do_decode_step()
        self.cache.set_length(slot, len(prompt))
        self._host_lens[slot] = len(prompt)
        self._prefilling.discard(slot)
        return logits

    def _update_kv_metric(self):
        self.metrics.kv_tokens_in_use = int(
            sum(self._host_lens[s] for s in self.sched.active_slots()))

    def _decode_slots(self) -> list[int]:
        """The active slots that take decode tokens: not those mid-way
        through a chunked prefill (their KV is not complete)."""
        return [s for s in self.sched.active_slots() if s not in self._prefilling]

    def _do_decode_step(self):
        t0 = time.perf_counter()
        slots = self._decode_slots()
        if self._inflight is not None:
            # a chained burst is already on the card: chain the next one
            # off its last tokens when that cannot hurt, then read this one
            # back.  Its tokens hold for every slot whose request is the
            # one it was dispatched for (snapshot guard); others discard.
            toks, snap = self._inflight
            self._inflight = None
            if self._can_speculate():
                self._speculate(toks)
            self._process_burst(toks, snap, t0)
            return
        if not slots:
            return
        if self.spec is not None and self.sampling.temperature == 0.0:
            # verify appends K+1 KV entries before acceptance is known: fall
            # back to plain decode when any slot lacks the headroom (the
            # clamped append would overwrite live context)
            if all(int(self._host_lens[s]) + self.spec.num_draft + 1 <= self.capacity
                   for s in slots):
                self._do_spec_decode_step(slots, t0)
                return
        if self.decode_burst > 1 and self._burst_ok(slots):
            toks = self._dispatch_burst(_host_tokens(self.next_token))
            snap = {s: self.sched.active[s] for s in slots}
            if self._can_speculate():
                # dispatch burst i+1 before reading burst i back: its last
                # tokens continue every slot that stays active, so the card
                # computes while the host books burst i
                self._speculate(toks)
            self._process_burst(toks, snap, t0)
            return
        toks = self._decode_jit(_host_tokens(self.next_token)).cpu().numpy()
        self._host_lens += 1  # decode appends for every batch slot
        self.metrics.record_decode(len(slots), time.perf_counter() - t0)
        self._update_kv_metric()
        for slot in slots:
            tok = int(toks[slot])
            if not self.sched.step_done(slot, tok):
                self.next_token[slot] = tok
                continue
            self.metrics.completed_requests += 1

    def _dispatch_burst(self, tokens):
        """Enqueue one burst and the copy of its tokens to the host; the
        host length mirror advances at once (the burst appends for every
        batch slot)."""
        toks = self._readback.start(self._burst_jit(tokens))
        self._host_lens += self.decode_burst
        return toks

    def _speculate(self, toks):
        snap = {s: self.sched.active[s] for s in self._decode_slots()}
        # chain off the burst's last tokens on the card: no host round trip
        self._inflight = (self._dispatch_burst(toks.dev[-1]), snap)

    def _can_speculate(self) -> bool:
        """Chain another burst only when it cannot hurt: nothing waits for
        a slot, no chunked prefill is mid-way, some slot still has token
        budget, and every active slot has one more burst of KV headroom.
        A burst chained for slots that then complete costs discarded tokens
        and masked KV: at most one burst of device time."""
        if self.decode_burst <= 1 or self.sched.waiting or self._prefilling:
            return False
        slots = self.sched.active_slots()
        if not slots:
            return False
        if not any(len(self.sched.active[s].generated) < self.sched.active[s].max_tokens
                   for s in slots):
            return False
        return all(int(self._host_lens[s]) + self.decode_burst <= self.capacity
                   for s in slots)

    def _process_burst(self, toks, snap, t0):
        toks = self._readback.wait(toks)  # [burst, B]: waits for this burst alone
        consumed = 0
        for slot, req in snap.items():
            if self.sched.active.get(slot) is not req:
                continue  # the slot was released or reassigned since dispatch
            for i in range(self.decode_burst):
                tok = int(toks[i, slot])
                consumed += 1
                if self.sched.step_done(slot, tok):
                    # EOS or max_tokens mid-burst: the tail is discarded (its
                    # KV is masked by length once the slot is reused)
                    self.metrics.completed_requests += 1
                    break
                self.next_token[slot] = tok
        self.metrics.record_decode(consumed, time.perf_counter() - t0)
        self._update_kv_metric()

    def _burst_ok(self, slots) -> bool:
        """Burst only when it cannot hurt latency or correctness: nothing
        waits (admission is not delayed), no chunked prefill is mid-way,
        and every active slot has one burst of KV headroom.  A slot whose
        budget runs out mid-burst discards its tail."""
        if self.sched.waiting or self._prefilling:
            return False
        return all(int(self._host_lens[s]) + self.decode_burst <= self.capacity
                   for s in slots)

    def _do_spec_decode_step(self, slots, t0):
        """One speculative round: K drafts per slot, ONE decode_multi over
        [current, drafts], then the accepted prefix plus the model's
        correction token per slot (greedy-exact); both caches roll back to
        the context each slot consumed."""
        K = self.spec.num_draft
        max_b = self.next_token.shape[0]
        tok_in = np.zeros((max_b, K + 1), np.int64)
        tok_in[:, 0] = self.next_token
        if self.draft_cache is not None:
            drafts = self._draft_scan_jit(_host_tokens(self.next_token)).cpu().numpy()
        else:
            drafts = np.zeros((max_b, K), np.int64)
            for s in slots:
                req = self.sched.active[s]
                drafts[s] = _ngram_draft(req.prompt + req.generated, self.spec.ngram, K)
        tok_in[:, 1:] = drafts
        lens_before = self._host_lens.copy()
        greedy = self._verify_jit(_host_tokens(tok_in)).cpu().numpy()  # [B, K+1]
        self._host_lens += K + 1  # decode_multi advanced every slot
        self.metrics.record_decode(len(slots), time.perf_counter() - t0)
        self._update_kv_metric()
        # active slots roll back to their consumed context; the over-appended
        # KV is overwritten by the next append
        new_len = self._host_lens.copy()
        for s in slots:
            n_acc = 0
            while n_acc < K and drafts[s, n_acc] == greedy[s, n_acc]:
                n_acc += 1
            emitted = [int(t) for t in drafts[s, :n_acc]] + [int(greedy[s, n_acc])]
            self.metrics.record_spec(len(emitted), K)
            done = False
            for tok in emitted:
                if self.sched.step_done(s, tok):
                    done = True
                    self.metrics.completed_requests += 1
                    break
            # the cache holds context for everything but the newest token
            new_len[s] = lens_before[s] + n_acc + 1
            if not done:
                self.next_token[s] = emitted[-1]
        lengths = torch.tensor(new_len, dtype=torch.int32, device=self.device)
        self.cache.length.copy_(lengths)
        if self.draft_cache is not None:
            self.draft_cache.length.copy_(lengths)
        self._host_lens = new_len


class PagedInferenceEngine:
    """Continuous batching over a paged KV pool (engine/paged.py), with the
    native page allocator (runtime/abi.py) gating admission: a request is
    admitted only when pages for its prompt + max_tokens are free, and its
    pages return to the free list at completion.

    With ``prefix_cache`` (engine/prefix_cache.py) full prompt pages are
    shared: after its prefill a request donates them to the cache, owned
    by the pseudo-slot ``max_batch``, and a later request whose prompt
    starts with the same pages points its table at them and prefills only
    its suffix (the model's ``prefill_suffix_paged``).  Unreferenced cache
    pages are evicted, oldest first, when admission runs short."""

    def __init__(self, params, adapter: ModelAdapter, *, max_batch: int = 8,
                 capacity: int = 2048, page_size: int = 128,
                 num_pages: int | None = None, kv_mode: str = "none",
                 cache_dtype=torch.bfloat16,
                 sampling: SamplingParams | None = None, rng_seed: int = 0,
                 prefix_cache: bool = False, decode_burst: int = 1,
                 device=None):
        """device: where the pool lives and the steps run (default: the
        card); it must be where ``params`` are.  num_pages defaults to
        max_batch full sequences plus the null page.  decode_burst: as
        InferenceEngine's; admission acquires pages for the prompt plus
        max_tokens rounded up to whole bursts, so every burst, the
        request's last included, stays inside the slot's own pages."""
        if adapter.decode_step_paged is None:
            raise ValueError("adapter has no decode_step_paged")
        if prefix_cache and adapter.prefill_suffix_paged is None:
            raise ValueError("prefix_cache needs adapter.prefill_suffix_paged")
        self.device = resolve_device(device)
        self.params = params
        self.adapter = adapter
        self.page_size = page_size
        self.max_pages = -(-capacity // page_size)
        num_pages = num_pages or (max_batch * self.max_pages + 1)
        self.alloc = PagePool(num_pages)
        self.pool = PagedKVPool.create(
            adapter.num_layers, num_pages, page_size, max_batch,
            self.max_pages, adapter.num_kv_heads, adapter.head_dim,
            dtype=cache_dtype, mode=kv_mode, device=self.device)
        self.sampling = sampling or SamplingParams()
        self.sched = ContinuousBatchingScheduler(max_batch)
        self.generator = torch.Generator(device=self.device).manual_seed(rng_seed)
        self.next_token = np.zeros((max_batch,), np.int64)
        # host mirrors (no device reads on the hot path): pool.length, and
        # each slot's allocated token capacity (pages * page_size)
        self._host_lens = np.zeros((max_batch,), np.int64)
        self._slot_cap = np.zeros((max_batch,), np.int64)
        self.metrics = EngineMetrics(kv_capacity=(num_pages - 1) * page_size)
        self._pending_pages: dict[int, list[int]] = {}
        self.decode_burst = max(1, int(decode_burst))
        self._inflight = None
        self._readback = _BurstReadback((self.decode_burst, max_batch), self.device)

        def body(fn):
            return GraphBody(
                fn, self.device, buffers=lambda: _pool_buffers(self.pool),
                watch=lambda: tensor_versions(self.params),
                generator=self.generator if self.sampling.temperature > 0 else None)

        self._decode_jit = body(self._decode_batch)
        self._burst_jit = body(self._decode_burst_body)
        self.prefix = None
        if prefix_cache:
            self.prefix = PrefixCache(page_size)
            self.cache_slot = max_batch
            self._pending_prefix: dict[int, tuple] = {}
            self._slot_prefix: dict[int, tuple] = {}
            self._slot_pages: dict[int, list[int]] = {}
            self._slot_refs: dict[int, tuple] = {}

    # --- the bodies JAX jits, captured on the card ---

    def _decode_batch(self, tokens):
        """One paged decode step for every slot: tokens [B] -> sampled [B]."""
        logits, self.pool = self.adapter.decode_step_paged(self.params, tokens, self.pool)
        return sample(logits, self.generator, self.sampling)

    def _decode_burst_body(self, tokens):
        """decode_burst paged steps: tokens [B] -> sampled [burst, B]."""
        toks = []
        for _ in range(self.decode_burst):
            logits, self.pool = self.adapter.decode_step_paged(self.params, tokens, self.pool)
            tokens = sample(logits, self.generator, self.sampling)
            toks.append(tokens)
        return torch.stack(toks)

    # --- host loop ---

    def submit(self, prompt, max_tokens=64) -> Request:
        return self.sched.submit(prompt, max_tokens, self.adapter.eos_token)

    def cancel(self, req: Request) -> bool:
        return self.sched.cancel(req)

    def run(self, max_steps: int = 10_000) -> None:
        """Drive until all submitted work completes."""
        steps = 0
        while self.sched.has_work and steps < max_steps:
            steps += 1
            if self._inflight is not None and not self.sched.active:
                self._inflight = None  # all its requests are gone
            for req in self.sched.admit(self._can_admit):
                self._admit_pages(req)
                self._do_prefill(req)
            if self.sched.active:
                self._do_decode_step()

    def _pages_needed(self, req: Request) -> int:
        total = len(req.prompt) + req.max_tokens
        if self.decode_burst > 1:
            # the decode budget rounded up to whole bursts: the last burst
            # overshoots max_tokens (its tail discarded) but must still land
            # inside the slot's own pages
            gen = -(-req.max_tokens // self.decode_burst) * self.decode_burst
            total = len(req.prompt) + gen
        return -(-total // self.page_size)

    def _can_admit(self, req: Request) -> bool:
        """Acquire the request's pages now, against the slot the scheduler
        will give it (free_slots[0]), so a second admission in the same
        round sees the smaller free list.  Cached prefix pages are reused
        (and referenced here, so an eviction in the same round cannot free
        them); if the free list falls short, unreferenced cache entries are
        evicted LRU."""
        if not self.sched.free_slots:
            return False
        slot = self.sched.free_slots[0]
        cached_pages, cached_len = [], 0
        if self.prefix is not None:
            cached_pages, cached_len = self.prefix.lookup(req.prompt)
            self.prefix.ref(req.prompt, len(cached_pages))
        need = self._pages_needed(req) - len(cached_pages)
        pages = self.alloc.acquire(slot, need)
        if pages is None and self.prefix is not None:
            self.prefix.evict(need - self.alloc.free_count, self.alloc)
            pages = self.alloc.acquire(slot, need)
        if pages is None:
            if self.prefix is not None:
                self.prefix.unref(req.prompt, len(cached_pages))
            return False
        self._pending_pages[req.uid] = cached_pages + pages
        if self.prefix is not None:
            self._pending_prefix[req.uid] = (len(cached_pages), cached_len)
        return True

    def _admit_pages(self, req: Request):
        pages = self._pending_pages.pop(req.uid)
        self.pool.assign_pages(req.slot, pages)
        self._slot_cap[req.slot] = len(pages) * self.page_size
        if self.prefix is not None:
            self._slot_prefix[req.slot] = self._pending_prefix.pop(req.uid)
            self._slot_pages[req.slot] = pages

    def _release(self, slot: int):
        if self.prefix is not None:
            n_ref, prompt = self._slot_refs.pop(slot, (0, ()))
            self.prefix.unref(prompt, n_ref)
            self._slot_prefix.pop(slot, None)
            self._slot_pages.pop(slot, None)
        self.alloc.release_slot(slot)
        # zero the table row, so the decode appends of the now idle slot
        # land on the null page, never on pages acquired by another slot
        self.pool.assign_pages(slot, [0] * self.max_pages)
        self.pool.set_length(slot, 0)
        self._host_lens[slot] = 0
        self._slot_cap[slot] = 0

    def _prefill_tokens(self, tokens, bucket: int):
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :len(tokens)] = tokens
        return torch.from_numpy(toks).to(self.device)

    def _do_prefill(self, req: Request):
        t0 = time.perf_counter()
        n_cached, cached_len = (self._slot_prefix.get(req.slot, (0, 0))
                                if self.prefix is not None else (0, 0))
        if cached_len > 0:
            # prefix-cache hit: prefill only the suffix; a bucket longer
            # than the suffix writes its padding past the prompt, where
            # decode overwrites it, or onto the null page
            suffix = req.prompt[cached_len:]
            bucket = min(bucket_length(len(suffix)),
                         self.max_pages * self.page_size - cached_len)
            logits_all, self.pool = self.adapter.prefill_suffix_paged(
                self.params, self._prefill_tokens(suffix, bucket), self.pool,
                req.slot, cached_len)
            logits = logits_all[0, len(suffix) - 1]
            n_tokens = len(suffix)
        else:
            bucket = min(bucket_length(len(req.prompt)), self.max_pages * self.page_size)
            positions = torch.arange(bucket, device=self.device)[None]
            logits_all, kvs = self.adapter.prefill_with_kv(
                self.params, self._prefill_tokens(req.prompt, bucket), positions)
            for layer, (k, v) in enumerate(kvs):
                self.pool.append_prefill(layer, req.slot, k[0], v[0], 0)
            logits = logits_all[0, len(req.prompt) - 1]
            n_tokens = len(req.prompt)
        self.pool.set_length(req.slot, len(req.prompt))
        if self.prefix is not None:
            # donate the prompt's full pages to the cache and hold one
            # reference per full-prefix entry for the request's lifetime
            full = max(0, (len(req.prompt) - 1) // self.page_size)
            self.prefix.insert(req.prompt, self._slot_pages[req.slot][:full],
                               self.alloc, self.cache_slot)
            self.prefix.ref(req.prompt, full)
            self.prefix.unref(req.prompt, n_cached)
            self._slot_refs[req.slot] = (full, tuple(req.prompt))
        tok = int(sample(logits[None], self.generator, self.sampling)[0])
        self.metrics.record_prefill(n_tokens, time.perf_counter() - t0)
        self._host_lens[req.slot] = len(req.prompt)
        req.generated.append(tok)
        if len(req.generated) >= req.max_tokens or (
            req.eos_token is not None and tok == req.eos_token
        ):
            slot = req.slot
            self.sched.complete(req)
            self._release(slot)
            self.metrics.completed_requests += 1
        else:
            self.next_token[req.slot] = tok

    def _do_decode_step(self):
        t0 = time.perf_counter()
        slots = self.sched.active_slots()
        if self._inflight is not None:
            toks, snap = self._inflight
            self._inflight = None
            if self._can_speculate():
                self._speculate(toks)
            # a release in here lands, on the card's one stream, after the
            # burst just chained, as JAX's functional table update does
            self._process_burst(toks, snap, t0)
            return
        if not slots:
            return
        if self.decode_burst > 1 and self._burst_ok(slots):
            toks = self._dispatch_burst(_host_tokens(self.next_token))
            snap = {s: self.sched.active[s] for s in slots}
            if self._can_speculate():
                self._speculate(toks)
            self._process_burst(toks, snap, t0)
            return
        toks = self._decode_jit(_host_tokens(self.next_token)).cpu().numpy()
        self._host_lens += 1  # decode appends for every batch slot
        self.metrics.record_decode(len(slots), time.perf_counter() - t0)
        self._update_kv_metric()
        for slot in slots:
            tok = int(toks[slot])
            if not self.sched.step_done(slot, tok):
                self.next_token[slot] = tok
                continue
            self._release(slot)
            self.metrics.completed_requests += 1

    def _dispatch_burst(self, tokens):
        toks = self._readback.start(self._burst_jit(tokens))
        self._host_lens += self.decode_burst
        return toks

    def _speculate(self, toks):
        snap = dict(self.sched.active)
        self._inflight = (self._dispatch_burst(toks.dev[-1]), snap)

    def _can_speculate(self) -> bool:
        """Chain a burst off the last one's tokens on the card only when
        nothing waits for a slot, some slot still has budget, and every
        active slot's pages cover one more burst."""
        if self.decode_burst <= 1 or self.sched.waiting:
            return False
        slots = self.sched.active_slots()
        if not slots:
            return False
        if not any(len(self.sched.active[s].generated) < self.sched.active[s].max_tokens
                   for s in slots):
            return False
        return all(int(self._host_lens[s]) + self.decode_burst <= int(self._slot_cap[s])
                   for s in slots)

    def _process_burst(self, toks, snap, t0):
        toks = self._readback.wait(toks)  # [burst, B]
        consumed = 0
        for slot, req in snap.items():
            if self.sched.active.get(slot) is not req:
                continue
            for i in range(self.decode_burst):
                tok = int(toks[i, slot])
                consumed += 1
                if self.sched.step_done(slot, tok):
                    self._release(slot)
                    self.metrics.completed_requests += 1
                    break
                self.next_token[slot] = tok
        self.metrics.record_decode(consumed, time.perf_counter() - t0)
        self._update_kv_metric()

    def _update_kv_metric(self):
        self.metrics.kv_tokens_in_use = int(
            sum(self._host_lens[s] for s in self.sched.active_slots()))

    def _burst_ok(self, slots) -> bool:
        """Burst whenever nothing waits and every active slot's pages cover
        one more burst (see _pages_needed for why they always cover the
        last one)."""
        if self.sched.waiting:
            return False
        return all(int(self._host_lens[s]) + self.decode_burst <= int(self._slot_cap[s])
                   for s in slots)


class _BurstTokens(NamedTuple):
    dev: torch.Tensor  # [burst, B] on the device (a graph's static output)
    host: torch.Tensor | None  # its pinned host copy (the card only)
    event: object  # recorded after that copy


class _BurstReadback:
    """Two pinned host buffers for burst tokens.  Each burst's tokens are
    copied to one without a sync, behind an event, so reading burst i back
    waits for burst i alone, not for burst i+1 queued behind it; the copy
    is queued before the next replay overwrites the graph's output."""

    def __init__(self, shape, device):
        self.bufs = None
        if device.type == "cuda":
            self.bufs = [torch.empty(shape, dtype=torch.int64, pin_memory=True)
                         for _ in range(2)]
        self.turn = 0

    def start(self, dev: torch.Tensor) -> _BurstTokens:
        if self.bufs is None:
            return _BurstTokens(dev, None, None)
        host = self.bufs[self.turn]
        self.turn ^= 1
        host.copy_(dev, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _BurstTokens(dev, host, event)

    @staticmethod
    def wait(toks: _BurstTokens) -> np.ndarray:
        if toks.host is None:
            return toks.dev.numpy()
        toks.event.synchronize()
        return toks.host.numpy()


def _host_tokens(toks: np.ndarray) -> torch.Tensor:
    """A copy of host tokens (the host overwrites its array after the
    step), which a body moves to its device without a sync."""
    return torch.tensor(toks, dtype=torch.int64)


def _cache_buffers(cache) -> list:
    """The tensors a decode body updates in place in a KVCache."""
    if cache is None:
        return []
    return [*cache.k, *cache.v, *(cache.k_scale or ()), *(cache.v_scale or ()), cache.length]


def _pool_buffers(pool) -> list:
    """The tensors a decode body updates in place in a PagedKVPool."""
    return [*pool.k_pages, *pool.v_pages, *(pool.k_scale or ()), *(pool.v_scale or ()),
            pool.block_table, pool.length]


def _check_spec(spec: SpecConfig, adapter: ModelAdapter, mesh, prefill_chunk_size):
    """The JAX engine's constructor checks for speculative decoding
    (flash_attn_tpu/engine/engine.py:162-182)."""
    if adapter.decode_multi is None:
        raise ValueError("spec decoding needs adapter.decode_multi")
    da = spec.draft_adapter
    if da is None:
        return
    if da.prefill_with_kv is None or da.decode_step is None:
        raise ValueError("draft-model speculation needs the draft adapter's "
                         "prefill_with_kv and decode_step")
    if mesh is not None:
        raise ValueError("draft-model speculation does not compose with sharded KV yet")
    if prefill_chunk_size is not None:
        raise ValueError("draft-model speculation does not compose with chunked prefill yet")


def _insert_slot_kv(cache: KVCache, layer: int, slot: int, k, v) -> KVCache:
    """Write a full prompt's KV [S, Hk, D] into (layer, slot) of the cache,
    quantizing per (token, head), in place."""
    return cache.insert_prompt(layer, slot, k, v)

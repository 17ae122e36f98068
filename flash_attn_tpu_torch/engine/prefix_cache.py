"""Automatic prefix caching over the paged KV pool (vLLM-style).

A copy of flash_attn_tpu/engine/prefix_cache.py (pure host logic), kept in
the port so that it imports nothing of the JAX package.

Requests that share a prompt prefix reuse the prefix's KV pages instead of
recomputing them: the block table of a new request points at the cached
pages for the shared prefix, and prefill runs only on the divergent suffix.

- Only FULLY-WRITTEN pages are shared, keyed by the hash of the entire
  token prefix up to that page's end (so a page's key commits to everything
  before it: two prompts share page i only if they agree on all of
  tokens[0 : (i+1)*page_size]).
- Shared pages are read-only by construction: decode appends write at
  position ``length``, which always lands in a private page because sharing
  stops at the last full prompt page.  No copy-on-write machinery needed.
- Ownership: cached pages belong to a reserved allocator pseudo-slot
  (``cache_slot``), so a request's ``release_slot`` never frees them.  A
  per-entry refcount tracks active readers; eviction (LRU over refs==0
  entries) returns pages via ``PagePool.release_pages``.
- Insertion: after a request's prefill, its full prompt pages are donated
  to the cache (``PagePool.transfer``) unless an identical prefix is
  already cached.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field


def _key(tokens) -> bytes:
    """Hash of a token prefix (content-addressed page key)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(b",".join(str(int(t)).encode() for t in tokens))
    return h.digest()


@dataclass
class _Entry:
    page_id: int
    refs: int = 0
    stamp: int = 0  # LRU clock


@dataclass
class PrefixCache:
    """Content-addressed map: full-page token prefix -> resident page id."""

    page_size: int
    entries: dict = field(default_factory=dict)  # key -> _Entry
    _clock: int = 0
    hits: int = 0
    misses: int = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def lookup(self, prompt) -> tuple[list[int], int]:
        """Longest cached page chain for ``prompt``.

        Returns (page_ids, cached_len).  Refcounts are NOT taken — call
        ``ref`` once the request is actually admitted.  Never returns the
        final page even if the whole prompt is page-aligned and cached:
        the last token's logits must be recomputed, so at least one prompt
        token always remains for the suffix prefill.
        """
        ps = self.page_size
        full = max(0, (len(prompt) - 1) // ps)  # usable full pages
        pages, i = [], 0
        while i < full:
            e = self.entries.get(_key(prompt[: (i + 1) * ps]))
            if e is None:
                break
            pages.append(e.page_id)
            i += 1
        if pages:
            self.hits += 1
        else:
            self.misses += 1
        return pages, i * ps

    def ref(self, prompt, num_pages: int) -> None:
        ps = self.page_size
        now = self._tick()
        for i in range(num_pages):
            e = self.entries[_key(prompt[: (i + 1) * ps])]
            e.refs += 1
            e.stamp = now

    def unref(self, prompt, num_pages: int) -> None:
        ps = self.page_size
        for i in range(num_pages):
            e = self.entries.get(_key(prompt[: (i + 1) * ps]))
            if e is not None and e.refs > 0:
                e.refs -= 1

    def insert(self, prompt, page_ids, alloc, cache_slot: int) -> int:
        """Donate a request's full prompt pages to the cache.

        ``page_ids`` is the request's block-table prefix (one id per full
        prompt page, in order).  Pages whose key is already cached are left
        with the request (they'll be freed at its release).  Returns the
        number of pages donated.
        """
        ps = self.page_size
        full = max(0, (len(prompt) - 1) // ps)
        donated = []
        now = self._tick()
        for i in range(min(full, len(page_ids))):
            key = _key(prompt[: (i + 1) * ps])
            if key in self.entries:
                continue
            self.entries[key] = _Entry(page_ids[i], refs=0, stamp=now)
            donated.append(page_ids[i])
        if donated:
            alloc.transfer(donated, cache_slot)
        return len(donated)

    def evict(self, n_pages: int, alloc) -> int:
        """Free up to ``n_pages`` pages from unreferenced entries, oldest
        first.  Returns the number actually freed."""
        victims = sorted(
            (item for item in self.entries.items() if item[1].refs == 0),
            key=lambda item: item[1].stamp,
        )
        freed = []
        for key, e in victims:
            if len(freed) >= n_pages:
                break
            freed.append(e.page_id)
            del self.entries[key]
        if freed:
            alloc.release_pages(freed)
        return len(freed)

    @property
    def resident_pages(self) -> int:
        return len(self.entries)

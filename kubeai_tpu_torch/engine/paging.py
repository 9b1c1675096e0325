"""Host-side paged-KV allocator: block tables, refcounts, prefix cache.

The port's own copy of kubeai_tpu/engine/paging.py (the port imports
nothing of the JAX package). The parked-page API is left out until KV
park and restore are ported (ROADMAP queue 1, item 8).

The KV pool is one flat [L*P, page, 2*Kv, h] tensor; this module keeps
the host bookkeeping in LOGICAL pages 0..P-1 (layer-agnostic):

- **Page 0 is the trash page** — never allocated. Block-table entries
  default to 0, so padded prefill positions and post-finish decode
  overruns land there instead of on live pages.
- **Content addressing** is an exact chain digest: sha256 over
  (parent_digest, page tokens, adapter signature).
- **Full pages only** are shared, so shared pages are never written.
- **Eviction**: refcount-0 pages with registered content stay in an LRU
  "cached" set for future prefix hits; allocation evicts the oldest when
  the free list is empty.

Thread model: called only from the engine scheduler thread.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold n_tokens."""
    return -(-n_tokens // page_size)


class PagePool:
    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is reserved)")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: list[int] = list(range(num_pages - 1, 0, -1))  # LIFO
        self._ref = [0] * num_pages
        self._by_digest: dict[bytes, int] = {}
        self._digest_of: dict[int, bytes] = {}
        self._cached: "OrderedDict[int, None]" = OrderedDict()  # LRU, oldest first
        self.evictions = 0

    # -- capacity ----------------------------------------------------------

    def available(self) -> int:
        """Pages allocatable right now (free + evictable)."""
        return len(self._free) + len(self._cached)

    def used(self) -> int:
        return self.num_pages - 1 - self.available()

    def cached_pages(self) -> int:
        return len(self._cached)

    # -- digests -----------------------------------------------------------

    @staticmethod
    def _digest(parent: bytes, tokens: list[int], sig) -> bytes:
        h = hashlib.sha256(parent)
        h.update(repr(sig).encode())
        h.update(b"|")
        h.update(",".join(map(str, tokens)).encode())
        return h.digest()

    def chain_digests(self, token_ids: list[int], sig) -> list[bytes]:
        """Digest per FULL page of token_ids (partial tail excluded)."""
        ps = self.page_size
        out = []
        parent = b""
        for i in range(len(token_ids) // ps):
            parent = self._digest(parent, token_ids[i * ps : (i + 1) * ps], sig)
            out.append(parent)
        return out

    # -- prefix matching ---------------------------------------------------

    def match_prefix(self, token_ids: list[int], sig) -> list[int]:
        """Claim (ref++) the longest chain of resident full pages that
        prefix token_ids, strictly shorter than the prompt (at least one
        token must be prefilled so last-token logits exist)."""
        ps = self.page_size
        max_full = (len(token_ids) - 1) // ps
        claimed: list[int] = []
        parent = b""
        for i in range(max_full):
            parent = self._digest(parent, token_ids[i * ps : (i + 1) * ps], sig)
            page = self._by_digest.get(parent)
            if page is None:
                break
            claimed.append(page)
        for page in claimed:
            if self._ref[page] == 0:
                self._cached.pop(page, None)
            self._ref[page] += 1
        return claimed

    # -- allocation --------------------------------------------------------

    def allocate(self, n: int) -> list[int]:
        """Allocate n private pages (ref=1, no content). Raises if the
        pool can't satisfy it — callers check available() first."""
        if n > self.available():
            raise RuntimeError(f"KV pool exhausted: need {n}, have {self.available()}")
        out = []
        for _ in range(n):
            if self._free:
                page = self._free.pop()
            else:
                page, _ = self._cached.popitem(last=False)
                self._unregister(page)
                self.evictions += 1
            self._ref[page] = 1
            out.append(page)
        return out

    def _unregister(self, page: int) -> None:
        d = self._digest_of.pop(page, None)
        if d is not None and self._by_digest.get(d) == page:
            del self._by_digest[d]

    # -- registration ------------------------------------------------------

    def register_chain(self, token_ids: list[int], sig, pages: list[int]) -> list[int]:
        """Content-register the full pages of token_ids held in *pages*.
        Already-registered pages and digests keep their first mapping.
        Returns the NEWLY registered pages."""
        fresh: list[int] = []
        for digest, page in zip(self.chain_digests(token_ids, sig), pages):
            if page in self._digest_of or digest in self._by_digest:
                continue
            self._by_digest[digest] = page
            self._digest_of[page] = digest
            fresh.append(page)
        return fresh

    def unregister_pages(self, pages: list[int]) -> None:
        """Drop content registration (the pages keep their refcounts)."""
        for page in pages:
            self._unregister(page)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    # -- release -----------------------------------------------------------

    def release(self, pages: list[int]) -> None:
        """Drop one reference per page. Refcount-0 pages go to the LRU
        cached set if content-registered, else back to the free list."""
        for page in pages:
            self._ref[page] -= 1
            if self._ref[page] < 0:
                raise RuntimeError(f"double release of page {page}")
            if self._ref[page] == 0:
                if page in self._digest_of:
                    self._cached[page] = None
                    self._cached.move_to_end(page)
                else:
                    self._free.append(page)

"""Paged KV-cache management (vLLM-style block allocator).

Pure-Python page tables + free list drive both (a) real storage arrays that
the Pallas ``paged_attention`` kernel consumes and (b) byte-level accounting
in the cluster simulator.  Invariants (hypothesis-tested):
  * every owned page has a positive reference count equal to its table
    occurrences plus its pin count;
  * distinct owned pages + free pages == total (a shared page counts ONCE);
  * freeing a request drops one reference per page — a page returns to the
    free list only when its LAST reference (table or pin) goes.

Refcounted sharing (v6, the prefix-cache substrate): ``allocate`` may seed
a table with pages another table already owns (``shared=``), so a common
prefix's pages are stored once and referenced by every request using them.
``pin``/``unpin`` add references *outside* any table — the prefix cache
pins matched pages for the duration of a prefill or a remote fetch so
eviction (``free`` of the owning table) cannot release them mid-use.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import numpy as np


class OutOfPages(RuntimeError):
    pass


@dataclasses.dataclass
class PageTableEntry:
    pages: List[int]
    tokens: int = 0


class PagedAllocator:
    def __init__(self, num_pages: int, page_size: int):
        assert num_pages > 0 and page_size > 0
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self.tables: Dict[int, PageTableEntry] = {}
        # page -> live references: one per table occurrence + one per pin.
        # A page is on the free list iff it has no entry here.
        self._refs: Dict[int, int] = {}
        self._pins: Dict[int, int] = {}

    # ------------------------------------------------------------- queries
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        """Distinct owned pages (a shared page counts once)."""
        return self.num_pages - len(self._free)

    def used_tokens(self) -> int:
        """Logical tokens across tables (shared pages count per table)."""
        return sum(t.tokens for t in self.tables.values())

    def pages_needed(self, tokens: int) -> int:
        return math.ceil(tokens / self.page_size)

    def can_allocate(self, tokens: int) -> bool:
        return self.pages_needed(tokens) <= self.free_pages

    def ref_count(self, page: int) -> int:
        """Live references on a page (0 = free)."""
        return self._refs.get(page, 0)

    def pin_count(self, page: int) -> int:
        return self._pins.get(page, 0)

    def shared_pages(self) -> int:
        """Pages referenced by more than one table."""
        counts: Dict[int, int] = {}
        for t in self.tables.values():
            for p in t.pages:
                counts[p] = counts.get(p, 0) + 1
        return sum(1 for c in counts.values() if c > 1)

    # ----------------------------------------------------------- lifecycle
    def allocate(self, req_id: int, tokens: int,
                 shared: Sequence[int] = ()) -> List[int]:
        """Build ``req_id``'s page table.  ``shared`` pages (already owned
        by another table or a pin) lead the table and are re-referenced,
        not re-allocated — only the suffix draws fresh pages."""
        if req_id in self.tables:
            raise KeyError(f"request {req_id} already has a page table")
        need = self.pages_needed(tokens)
        head = list(shared)[:need]
        for p in head:
            if self._refs.get(p, 0) <= 0:
                raise KeyError(f"shared page {p} is not owned")
        fresh_need = need - len(head)
        if fresh_need > len(self._free):
            raise OutOfPages(
                f"need {fresh_need} pages, have {len(self._free)}")
        for p in head:
            self._refs[p] += 1
        fresh = [self._free.pop() for _ in range(fresh_need)]
        for p in fresh:
            self._refs[p] = 1
        pages = head + fresh
        self.tables[req_id] = PageTableEntry(pages=pages, tokens=tokens)
        return pages

    def append(self, req_id: int, tokens: int = 1) -> List[int]:
        """Extend a sequence; returns newly allocated pages (possibly [])."""
        entry = self.tables[req_id]
        new_total = entry.tokens + tokens
        need = self.pages_needed(new_total) - len(entry.pages)
        if need > len(self._free):
            raise OutOfPages(f"need {need} pages, have {len(self._free)}")
        fresh = [self._free.pop() for _ in range(need)]
        for p in fresh:
            self._refs[p] = 1
        entry.pages.extend(fresh)
        entry.tokens = new_total
        return fresh

    def _unref(self, page: int) -> bool:
        """Drop one reference; True if the page was RELEASED to the pool."""
        n = self._refs[page] - 1
        if n > 0:
            self._refs[page] = n
            return False
        del self._refs[page]
        self._free.append(page)
        return True

    def free(self, req_id: int) -> int:
        """Drop the table; returns how many pages were actually RELEASED
        (shared or pinned pages survive until their last reference goes)."""
        entry = self.tables.pop(req_id, None)
        if entry is None:
            return 0
        return sum(1 for p in entry.pages if self._unref(p))

    # ----------------------------------------------------------- pinning
    def pin(self, page: int) -> None:
        """Add a table-independent reference (prefix cache: hold a matched
        page across a prefill/fetch so eviction cannot release it)."""
        if self._refs.get(page, 0) <= 0:
            raise KeyError(f"cannot pin free page {page}")
        self._refs[page] += 1
        self._pins[page] = self._pins.get(page, 0) + 1

    def unpin(self, page: int) -> bool:
        """Drop a pin; True if that was the page's last reference."""
        n = self._pins.get(page, 0)
        if n <= 0:
            raise KeyError(f"page {page} is not pinned")
        if n == 1:
            del self._pins[page]
        else:
            self._pins[page] = n - 1
        return self._unref(page)

    def page_table(self, req_id: int) -> List[int]:
        return list(self.tables[req_id].pages)

    def check_invariants(self) -> None:
        occurrences: Dict[int, int] = {}
        for t in self.tables.values():
            for p in t.pages:
                occurrences[p] = occurrences.get(p, 0) + 1
        owned = set(self._refs)
        # refcounts reconcile exactly: table occurrences + pins, all > 0
        for p, r in self._refs.items():
            assert r == occurrences.get(p, 0) + self._pins.get(p, 0) > 0, \
                (p, r, occurrences.get(p, 0), self._pins.get(p, 0))
        assert set(occurrences) <= owned, "table references a free page"
        assert set(self._pins) <= owned, "pin references a free page"
        # shared pages count exactly once against capacity
        assert len(owned) + len(self._free) == self.num_pages, \
            (len(owned), len(self._free), self.num_pages)
        assert owned.isdisjoint(self._free)


class PagedKVStore:
    """Physical page-pool storage for one attention layer group —
    the layout the Pallas paged_attention kernel reads.

    k/v: [num_pages, page_size, kv_heads, head_dim]
    """

    def __init__(self, num_pages: int, page_size: int, kv_heads: int,
                 head_dim: int, dtype=np.float32):
        self.allocator = PagedAllocator(num_pages, page_size)
        shape = (num_pages, page_size, kv_heads, head_dim)
        self.k = np.zeros(shape, dtype)
        self.v = np.zeros(shape, dtype)

    def write_prompt(self, req_id: int, k: np.ndarray, v: np.ndarray,
                     shared_pages: Sequence[int] = ()):
        """k/v: [S, kv_heads, head_dim].  ``shared_pages`` (a matched
        prefix, owned elsewhere) already hold their data — only the
        suffix pages are written."""
        S = k.shape[0]
        pages = self.allocator.allocate(req_id, S, shared=shared_pages)
        ps = self.allocator.page_size
        n_shared = min(len(shared_pages), len(pages))
        for i, p in enumerate(pages):
            if i < n_shared:
                continue
            lo, hi = i * ps, min((i + 1) * ps, S)
            self.k[p, : hi - lo] = k[lo:hi]
            self.v[p, : hi - lo] = v[lo:hi]
        return pages

    def append_token(self, req_id: int, k: np.ndarray, v: np.ndarray):
        """k/v: [kv_heads, head_dim] for one new token."""
        entry = self.allocator.tables[req_id]
        pos = entry.tokens
        self.allocator.append(req_id, 1)
        page = entry.pages[pos // self.allocator.page_size]
        off = pos % self.allocator.page_size
        self.k[page, off] = k
        self.v[page, off] = v

    def gather(self, req_id: int) -> tuple:
        """Densify a request's K/V: [tokens, kv_heads, head_dim]."""
        entry = self.allocator.tables[req_id]
        ps = self.allocator.page_size
        ks, vs = [], []
        remaining = entry.tokens
        for p in entry.pages:
            n = min(ps, remaining)
            ks.append(self.k[p, :n])
            vs.append(self.v[p, :n])
            remaining -= n
        return np.concatenate(ks, 0), np.concatenate(vs, 0)

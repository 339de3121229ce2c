"""Per-instance prefix cache: bucketed index + refcounted page pool.

One :class:`PrefixCache` lives on each serving instance.  It owns a
private :class:`~repro_torch.serving.kvcache.PagedAllocator` (one page per
indexed block, the block hash as the allocator req_id) and a flat dict
of :class:`Block` records forming a forest via parent links — the
bucketed equivalent of a radix tree over page-aligned prefixes (see
``repro_torch.cache.index``).

Lifecycle of a block:
  * ``insert_chain`` indexes a request's full-page blocks after prefill
    (or after a remote fetch lands), drawing pages from the pool —
    evicting per policy when full, but only LEAF blocks with no pins
    (evicting an interior block would orphan its children's chains);
  * ``acquire`` pins a request's longest match for the duration of its
    prefill (``release`` unpins) — pinned blocks cannot be evicted, so
    a prefill never loses pages it planned to reuse, including under
    eviction pressure from a concurrent remote fetch;
  * ``pin_chain``/``unpin_chain`` do the same for a remote fetch's
    source blocks while they stream out.

Occupancy is charged to the OWNING instance's KV ledger through the
``on_delta`` hook (+/- tokens per page drawn/released), and inserts are
additionally gated by ``room_fn`` (the instance's free-KV signal) so the
cache never pushes the instance ledger past capacity.  Eviction scans
are O(blocks) — fine at simulator scale; a heap is a drop-in upgrade.

Counters are CUMULATIVE across ``clear()`` (an instance fault wipes the
pages, not the telemetry).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.cache.index import request_block_hashes


def _paged_allocator():
    # Imported lazily: repro_torch.serving.simulator imports repro_torch.cache at
    # module level (SimInstance owns a PrefixCache), so a module-level
    # import of repro_torch.serving.kvcache here would be circular whenever
    # repro_torch.cache is imported first.
    from repro_torch.serving.kvcache import PagedAllocator
    return PagedAllocator


@dataclasses.dataclass
class Block:
    """One indexed prefix block: a full page of cached KV."""
    hash: int
    page: int
    parent: Optional[int]        # previous block's hash (None = chain root)
    created: float
    last_used: float
    hits: int = 0
    children: int = 0            # blocks whose parent is this one
    pins: int = 0                # live acquire/fetch references


class EvictionPolicy:
    """Victim ordering over evictable blocks (smaller key evicts first)."""

    name = "lru"

    def victim_key(self, blk: Block, now: float):
        return blk.last_used

    def expired(self, blk: Block, now: float) -> bool:
        return False


class LruPolicy(EvictionPolicy):
    name = "lru"


class LfuPolicy(EvictionPolicy):
    name = "lfu"

    def victim_key(self, blk: Block, now: float):
        return (blk.hits, blk.last_used)


class TtlPolicy(EvictionPolicy):
    name = "ttl"

    def __init__(self, ttl_s: float = 30.0):
        self.ttl_s = float(ttl_s)

    def expired(self, blk: Block, now: float) -> bool:
        return now - blk.last_used > self.ttl_s


class NullPrefixCache:
    """Disabled tier: matches nothing, stores nothing — the ``none``
    registry entry and the default everywhere (bit-compatible with v5)."""

    enabled = False
    name = "none"

    def __init__(self, **_ignored):
        pass

    def match_tokens(self, req) -> int:
        return 0

    def acquire(self, req, now: float) -> int:
        return 0

    def release(self, req) -> None:
        pass

    def insert(self, req, now: float) -> int:
        return 0

    def insert_chain(self, hashes, now: float, have_from: int = 0) -> int:
        return 0

    def match_chain(self, hashes) -> int:
        return 0

    def pin_chain(self, hashes) -> bool:
        return False

    def unpin_chain(self, hashes) -> None:
        pass

    def evict_tokens(self, need: int, now: float) -> int:
        return 0

    def tokens(self) -> int:
        return 0

    def clear(self) -> None:
        pass

    def check_invariants(self) -> None:
        pass

    def stats(self) -> Dict:
        return {"policy": self.name, "tokens": 0, "blocks": 0}


class PrefixCache:
    """Prefix index + page pool behind one eviction policy."""

    enabled = True

    def __init__(self, policy: Optional[EvictionPolicy] = None,
                 capacity_tokens: int = 1 << 20, page_tokens: int = 64,
                 on_delta: Optional[Callable[[int], None]] = None,
                 room_fn: Optional[Callable[[], int]] = None):
        self.policy = policy or LruPolicy()
        self.name = self.policy.name
        self.page_tokens = max(1, int(page_tokens))
        self.capacity_pages = max(1, int(capacity_tokens) // self.page_tokens)
        self.on_delta = on_delta
        self.room_fn = room_fn
        self.alloc = _paged_allocator()(self.capacity_pages,
                                        self.page_tokens)
        self.blocks: Dict[int, Block] = {}
        self._pinned: Dict[int, Tuple[int, ...]] = {}   # req_id -> hashes
        # cumulative telemetry (survives clear())
        self.requests = 0
        self.request_hits = 0
        self.matched_tokens = 0
        self.prompt_tokens = 0
        self.inserts = 0
        self.evictions = 0
        self.expired = 0
        self.insert_skips = 0
        self.orphan_skips = 0

    # ------------------------------------------------------------- lookup
    def hashes(self, req) -> Tuple[int, ...]:
        return request_block_hashes(req, self.page_tokens)

    def match_chain(self, hashes: Sequence[int]) -> int:
        """Longest indexed prefix of ``hashes``, in TOKENS (pure probe)."""
        n = 0
        for h in hashes:
            if h not in self.blocks:
                break
            n += 1
        return n * self.page_tokens

    def match_tokens(self, req) -> int:
        return self.match_chain(self.hashes(req))

    # ---------------------------------------------------------- reuse path
    def acquire(self, req, now: float) -> int:
        """Pin ``req``'s longest match for the duration of its prefill and
        return the usable cached tokens (capped at ``prompt_len - 1`` —
        at least one token must run through prefill to emit the first
        output token).  Counts the request in the hit-rate telemetry."""
        if req.req_id in self._pinned:
            self.release(req)
        hashes = self.hashes(req)
        matched: List[int] = []
        for h in hashes:
            if h not in self.blocks:
                break
            matched.append(h)
        usable = min(len(matched) * self.page_tokens,
                     max(0, req.prompt_len - 1))
        self.requests += 1
        self.prompt_tokens += req.prompt_len
        self.matched_tokens += usable
        if usable > 0:
            self.request_hits += 1
        for h in matched:
            self._touch(self.blocks[h], now)
            self._pin(h)
        self._pinned[req.req_id] = tuple(matched)
        return usable

    def release(self, req) -> None:
        for h in self._pinned.pop(req.req_id, ()):
            self._unpin(h)

    def insert(self, req, now: float) -> int:
        """Index a request's blocks after its prefill completed (all full
        pages of the prompt are now materialized locally)."""
        return self.insert_chain(self.hashes(req), now)

    # --------------------------------------------------------- chain verbs
    def insert_chain(self, hashes: Sequence[int], now: float,
                     have_from: int = 0) -> int:
        """Index ``hashes`` in chain order, touching blocks already
        present and allocating pages for the rest.  ``have_from`` is the
        first position whose DATA the caller holds (a remote fetch lands
        only the tail): a missing block below it breaks the chain — the
        landed tail is orphaned and nothing is inserted past the break.
        Returns newly inserted blocks."""
        hashes = tuple(hashes)
        protect = set(hashes)
        inserted = 0
        for k, h in enumerate(hashes):
            blk = self.blocks.get(h)
            if blk is not None:
                self._touch(blk, now)
                continue
            if k < have_from:
                self.orphan_skips += 1
                break
            if not self._make_room(now, protect):
                self.insert_skips += 1
                break
            page = self.alloc.allocate(h, self.page_tokens)[0]
            self.blocks[h] = Block(hash=h, page=page,
                                   parent=hashes[k - 1] if k else None,
                                   created=now, last_used=now)
            if k:
                self.blocks[hashes[k - 1]].children += 1
            if self.on_delta is not None:
                self.on_delta(self.page_tokens)
            self.inserts += 1
            inserted += 1
        return inserted

    def pin_chain(self, hashes: Sequence[int]) -> bool:
        """Pin a contiguous chain segment (remote fetch source side); all
        blocks must still be indexed — False (no pins taken) otherwise."""
        hashes = tuple(hashes)
        if any(h not in self.blocks for h in hashes):
            return False
        for h in hashes:
            self._pin(h)
        return True

    def unpin_chain(self, hashes: Sequence[int]) -> None:
        for h in hashes:
            self._unpin(h)

    # ------------------------------------------------------------ eviction
    def _evictable(self, blk: Block) -> bool:
        return blk.children == 0 and blk.pins == 0

    def _evict_one(self, now: float, protect: set) -> bool:
        """Evict per policy: TTL-expired leaves first, then the policy's
        victim ordering over evictable leaves outside ``protect``."""
        cands = [b for b in self.blocks.values()
                 if self._evictable(b) and b.hash not in protect]
        if not cands:
            return False
        dead = [b for b in cands if self.policy.expired(b, now)]
        victim = dead[0] if dead else min(
            cands, key=lambda b: self.policy.victim_key(b, now))
        self._drop(victim, expired=bool(dead))
        return True

    def _drop(self, blk: Block, expired: bool = False) -> None:
        del self.blocks[blk.hash]
        if blk.parent is not None and blk.parent in self.blocks:
            self.blocks[blk.parent].children -= 1
        released = self.alloc.free(blk.hash)
        assert released == 1, (blk.hash, released)
        if self.on_delta is not None:
            self.on_delta(-self.page_tokens)
        self.evictions += 1
        if expired:
            self.expired += 1

    def _make_room(self, now: float, protect: set) -> bool:
        """Room for ONE new page: pool space and (when wired) instance KV
        headroom — evicting until both hold or nothing evictable is left."""
        while True:
            pool_ok = self.alloc.free_pages > 0
            room_ok = self.room_fn is None \
                or self.room_fn() >= self.page_tokens
            if pool_ok and room_ok:
                return True
            if not self._evict_one(now, protect):
                return False

    def evict_tokens(self, need: int, now: float) -> int:
        """Best-effort: release at least ``need`` cached tokens (instance
        under KV pressure from real requests).  Returns tokens freed."""
        freed = 0
        while freed < need and self._evict_one(now, set()):
            freed += self.page_tokens
        return freed

    def sweep(self, now: float) -> int:
        """Evict every TTL-expired evictable block (no-op for lru/lfu)."""
        n = 0
        while True:
            dead = [b for b in self.blocks.values()
                    if self._evictable(b) and self.policy.expired(b, now)]
            if not dead:
                return n
            self._drop(dead[0], expired=True)
            n += 1

    # ----------------------------------------------------------- plumbing
    def _touch(self, blk: Block, now: float) -> None:
        blk.last_used = now
        blk.hits += 1

    def _pin(self, h: int) -> None:
        blk = self.blocks[h]
        blk.pins += 1
        self.alloc.pin(blk.page)

    def _unpin(self, h: int) -> None:
        blk = self.blocks.get(h)
        if blk is None:
            return               # cache was cleared (instance fault) —
        blk.pins -= 1            # the pages are gone, nothing to unpin
        assert blk.pins >= 0, (h, blk.pins)
        self.alloc.unpin(blk.page)

    def tokens(self) -> int:
        """Cached tokens currently occupying pages (what on_delta charged)."""
        return self.alloc.used_pages * self.page_tokens

    def clear(self) -> None:
        """Drop all cached state (instance fault).  The owner zeroes its
        KV ledger wholesale, so no on_delta is emitted here; counters are
        cumulative and survive."""
        self.alloc = _paged_allocator()(self.capacity_pages,
                                        self.page_tokens)
        self.blocks = {}
        self._pinned = {}

    def check_invariants(self) -> None:
        self.alloc.check_invariants()
        assert len(self.blocks) == self.alloc.used_pages
        for blk in self.blocks.values():
            assert blk.children == sum(
                1 for b in self.blocks.values() if b.parent == blk.hash)
            assert blk.pins == self.alloc.pin_count(blk.page)

    def stats(self) -> Dict:
        return {
            "policy": self.name,
            "tokens": self.tokens(),
            "blocks": len(self.blocks),
            "capacity_tokens": self.capacity_pages * self.page_tokens,
            "requests": self.requests,
            "request_hits": self.request_hits,
            "matched_tokens": self.matched_tokens,
            "prompt_tokens": self.prompt_tokens,
            "hit_rate": (self.matched_tokens / self.prompt_tokens
                         if self.prompt_tokens else 0.0),
            "inserts": self.inserts,
            "evictions": self.evictions,
            "expired": self.expired,
            "insert_skips": self.insert_skips,
            "orphan_skips": self.orphan_skips,
        }


__all__ = ["Block", "EvictionPolicy", "LruPolicy", "LfuPolicy", "TtlPolicy",
           "NullPrefixCache", "PrefixCache"]

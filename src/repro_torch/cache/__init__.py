# Prefix cache (v6): KV reuse as a first-class tier.
#
#   index.py    — page-aligned chained block hashing over prompt tokens
#                 (the bucketed prefix index: block hash -> cached page).
#   prefix.py   — per-instance PrefixCache over a refcounted
#                 PagedAllocator, with sweepable eviction policies.
#   registry.py — make_cache(name, **knobs) on the shared repro_torch.registry
#                 helper (lru | lfu | ttl | none).
#
# The cache is a *tier*, not a correctness feature: `none` (the default
# everywhere) is bit-compatible with a v5 cluster, and every other policy
# only changes WHERE prefill work happens and how much of it recomputes.
from repro_torch.cache.index import request_block_hashes
from repro_torch.cache.prefix import (Block, EvictionPolicy, LfuPolicy, LruPolicy,
                                NullPrefixCache, PrefixCache, TtlPolicy)
from repro_torch.cache.registry import list_caches, make_cache, register_cache

__all__ = [
    "Block", "EvictionPolicy", "LruPolicy", "LfuPolicy", "TtlPolicy",
    "NullPrefixCache", "PrefixCache", "request_block_hashes",
    "list_caches", "make_cache", "register_cache",
]

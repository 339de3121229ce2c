"""Cache registry: construct an eviction-policy-bearing prefix cache by
name, on the shared :mod:`repro_torch.registry` helper::

    from repro_torch.cache import make_cache

    make_cache("lru", capacity_tokens=1 << 16, page_tokens=64)
    make_cache("ttl", ttl_s=10.0)
    make_cache("none")            # disabled tier (NullPrefixCache)

Unknown names raise the unified :class:`repro_torch.registry.UnknownNameError`
(a ``ValueError``) listing what IS registered; unknown knobs raise
``TypeError`` naming the accepted set — the same shapes as
``make_policy`` / ``make_traffic`` / ``make_topology``.
"""
from __future__ import annotations

from typing import List

from repro_torch.cache.prefix import (LfuPolicy, LruPolicy, NullPrefixCache,
                                PrefixCache, TtlPolicy)
from repro_torch.registry import Registry

_REG = Registry("cache")

_CACHE_KNOBS = ("capacity_tokens", "page_tokens", "on_delta", "room_fn")


def register_cache(name: str, factory, knobs: tuple = ()) -> None:
    _REG.register(name, factory, knobs=knobs)


def list_caches() -> List[str]:
    return _REG.names()


def make_cache(name: str, **knobs):
    """Build the prefix cache registered as ``name`` with the given knobs."""
    return _REG.make(name, **knobs)


def _none(**_ignored) -> NullPrefixCache:
    return NullPrefixCache()


def _lru(**knobs) -> PrefixCache:
    return PrefixCache(LruPolicy(), **knobs)


def _lfu(**knobs) -> PrefixCache:
    return PrefixCache(LfuPolicy(), **knobs)


def _ttl(ttl_s: float = 30.0, **knobs) -> PrefixCache:
    return PrefixCache(TtlPolicy(ttl_s), **knobs)


register_cache("none", _none, knobs=_CACHE_KNOBS)
register_cache("lru", _lru, knobs=_CACHE_KNOBS)
register_cache("lfu", _lfu, knobs=_CACHE_KNOBS)
register_cache("ttl", _ttl, knobs=_CACHE_KNOBS + ("ttl_s",))

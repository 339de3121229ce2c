"""Page-aligned chained block hashing: the prefix-index key space.

A prompt's token ids are split into ``page_tokens``-sized blocks; block
``k``'s key is ``crc32(block_k_bytes, key_{k-1})`` — the chained seed
makes each key a digest of the WHOLE prefix up to and including its
block, so two prompts share key ``k`` iff their first ``(k+1) * page``
tokens are identical.  That is what lets the index be a flat bucketed
dict (hash -> cached page) instead of a token-level radix tree: walking
a request's key chain until the first miss IS the longest-prefix match,
and chain order is recoverable from the parent link each key carries.

Only FULL pages are hashed — a partial tail block is never indexed, so a
cached block always maps to exactly one allocator page of real KV.

``request_block_hashes`` memoizes per request object and page size: the
cluster probes every instance's index per routing decision, and the
token array never changes after arrival.
"""
from __future__ import annotations

import zlib
from typing import Tuple

import numpy as np


def block_hashes(tokens, page_tokens: int) -> Tuple[int, ...]:
    """Chained crc32 keys over full ``page_tokens`` blocks of ``tokens``."""
    page = max(1, int(page_tokens))
    arr = np.ascontiguousarray(np.asarray(tokens, dtype=np.int64))
    n = arr.shape[0] // page if arr.ndim == 1 else 0
    out = []
    h = 0
    for k in range(n):
        h = zlib.crc32(arr[k * page:(k + 1) * page].tobytes(), h)
        out.append(h)
    return tuple(out)


def request_block_hashes(req, page_tokens: int) -> Tuple[int, ...]:
    """Block-hash chain of ``req.prompt_tokens`` (() when the request
    carries no token ids — nothing page-aligned to index).  Memoized on
    the request object, keyed by page size."""
    toks = getattr(req, "prompt_tokens", None)
    if toks is None:
        return ()
    memo = getattr(req, "_prefix_hash_memo", None)
    if memo is not None and memo[0] == page_tokens:
        return memo[1]
    # hash at most prompt_len tokens: the simulator's accounting unit is
    # prompt_len, so an over-long token payload must not index beyond it
    arr = np.asarray(toks)
    limit = min(arr.shape[0], int(getattr(req, "prompt_len", arr.shape[0])))
    hashes = block_hashes(arr[:limit], page_tokens)
    try:
        req._prefix_hash_memo = (page_tokens, hashes)
    except AttributeError:
        pass                      # slotted/frozen request: skip the memo
    return hashes


__all__ = ["block_hashes", "request_block_hashes"]

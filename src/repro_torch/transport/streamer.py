"""Chunked, layer-wise KV streaming over ``memcpy_peer``.

The v2 disaggregation path shipped each request's KV cache as ONE blob:
the destination could not begin decode until the whole cache landed, and
the source held every page for the whole transfer.  A :class:`KVStreamer`
splits the KV into **layer-wise chunks** pipelined over the source's
copy-engine stream, so

  * the destination can admit the request for decode as soon as the first
    chunk lands (the tail streams in underneath the early decode steps);
  * the source frees pages chunk-by-chunk, shrinking the window in which
    a slow link holds KV capacity hostage (parked prefills re-admit
    sooner under memory pressure).

Chunk accounting is in **token-equivalents**: a request's KV is
``layers x tokens``; a chunk is a contiguous group of layers whose bytes
equal a share of the token count, so the cluster's per-token KV ledgers
(``kv_used`` / ``kv_in_transit``) stay integral per chunk.  ``plan``
targets ``chunk_tokens`` token-equivalents per chunk and never splits
finer than one layer group per layer.

``chunk_tokens=0`` (the default) degrades to the one-blob v2 behavior —
a single chunk — so existing deployments are bit-compatible.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional


class KVStreamer:
    def __init__(self, kv_bytes_per_token: float, chunk_tokens: int = 0,
                 n_layers: int = 0):
        self.kv_bytes_per_token = float(kv_bytes_per_token)
        self.chunk_tokens = int(chunk_tokens)
        self.n_layers = int(n_layers)

    # ------------------------------------------------------------ planning
    def plan(self, tokens: int) -> List[int]:
        """Split ``tokens`` token-equivalents into near-even chunks.

        Chunk count = ceil(tokens / chunk_tokens), capped at ``n_layers``
        (KV cannot stream finer than layer granularity).  The sizes sum
        exactly to ``tokens`` so per-chunk accounting conserves pages."""
        tokens = int(tokens)
        if tokens <= 0:
            return [tokens]
        if self.chunk_tokens <= 0 or tokens <= self.chunk_tokens:
            return [tokens]
        n = math.ceil(tokens / self.chunk_tokens)
        if self.n_layers > 0:
            n = min(n, self.n_layers)
        n = max(1, n)
        base, rem = divmod(tokens, n)
        return [base + (1 if i < rem else 0) for i in range(n)]

    # ------------------------------------------------------------- dispatch
    def stream(self, client, dst_daemon, tokens: int, *, path=None,
               vstream: Optional[int] = None, meta: Optional[Dict] = None,
               on_chunk: Callable[[int, int, bool, object], None] = None) \
            -> List[int]:
        """Enqueue one ``memcpy_peer`` per chunk on ``vstream`` (the
        source's copy-engine stream: chunks serialize on the engine and
        pipeline over the link).  ``on_chunk(index, chunk_tokens, is_last,
        future)`` fires as each chunk's op completes — the caller owns the
        per-chunk page accounting.  Returns the chunk plan."""
        chunks = self.plan(tokens)
        last = len(chunks) - 1
        for i, ctoks in enumerate(chunks):
            m = dict(meta or {}, kv_chunk=i, kv_chunks=len(chunks))
            fut = client.memcpy_peer(
                dst_daemon, None, None,
                nbytes=int(ctoks * self.kv_bytes_per_token),
                vstream=vstream, link=path, meta=m)
            if on_chunk is not None:
                fut.add_done_callback(
                    lambda f, i=i, c=ctoks: on_chunk(i, c, i == last, f))
        return chunks

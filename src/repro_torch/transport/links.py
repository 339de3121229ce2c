"""Path-aware link model: multi-segment transfers with processor sharing.

One :class:`LinkModel` owns the whole fabric.  A transfer occupies EVERY
segment on its path (see :mod:`repro_torch.transport.topology`) and its
instantaneous rate is the **minimum over per-segment processor shares**:
each segment splits its bandwidth evenly among the transfers crossing it,
and a flow moves at its tightest segment's share.  Two flows that share
only the spine slow each other down even though their endpoints differ —
the contention the v2 destination-ingress-keyed model could not see.

Pure state machine over a caller-supplied clock, same driving contract as
v2: ``start`` opens a transfer, ``eta`` predicts completion under CURRENT
occupancy, ``poll`` advances progress and reports completion.  Occupancy
changes move every sharing peer's finish time, so drivers re-poll peers
after any start/finish (``LinkDriver`` stepped / ``ThreadedLinkTimer``
threaded, both in :mod:`repro_torch.transport.drivers`).

Paths: ``start`` accepts a single segment key (any hashable — the v2
calling convention, including tuple keys like ``("ingress", "D0")``) or a
multi-segment path as a **list** of segment keys / a tuple of ``(kind,
name)`` segment tuples (what ``Topology.path`` returns).

Stats are kept globally AND per segment (bytes carried, queueing delay
attributed to the bottleneck segment, peak concurrency), so a benchmark
can tell spine contention from ingress contention.
"""
from __future__ import annotations

import os
from typing import Dict, Hashable, List, Optional, Tuple

from repro_torch.transport.topology import DEFAULT_LINK_BW, Topology


def as_path(link) -> Tuple[Hashable, ...]:
    """Normalize a link argument into a tuple of segment keys.

    Lists are always paths; tuples are a path only when every element is
    itself a ``(kind, name)`` segment tuple (a ``Topology.path`` result) —
    otherwise the tuple IS one segment key (v2 used ``("ingress", name)``)."""
    if isinstance(link, list):
        return tuple(link)
    if (isinstance(link, tuple) and link
            and all(isinstance(s, tuple) and len(s) == 2 for s in link)):
        return link
    return (link,)


def seg_key(seg: Hashable) -> str:
    """Stable, JSON-friendly name for one segment ("spine:0", "ingress:D1")."""
    if isinstance(seg, tuple) and len(seg) == 2:
        return f"{seg[0]}:{seg[1]}"
    return str(seg)


class LinkTransfer:
    """One in-flight transfer (identity equality: unique in-flight object).

    ``share`` (default 1.0) is the flow's **demand weight** for weighted
    processor sharing: a flow never moves faster than ``share`` of a
    segment's bandwidth, and contending flows split each segment's
    bandwidth in proportion to their shares.  Link transfers use 1.0 (the
    classic even split); the compute-contention model reuses this machinery
    with fractional shares — an op's compute-boundedness — so a
    bandwidth-bound decode step barely slows a co-located prefill chunk."""

    __slots__ = ("path", "nbytes", "remaining", "start_t", "done_t", "lost",
                 "share")

    def __init__(self, path: Tuple[Hashable, ...], nbytes: float,
                 start_t: float, share: float = 1.0):
        self.path = path
        self.nbytes = float(nbytes)
        self.remaining = float(nbytes)
        self.start_t = start_t
        self.done_t = -1.0
        self.lost = 0.0        # bytes declared lost to a severed segment
        self.share = float(share)

    @property
    def link(self) -> Hashable:
        """Primary (destination-side) segment — the v2 single-link view."""
        return self.path[-1]

    @property
    def elapsed(self) -> float:
        return self.done_t - self.start_t


class _SegStats:
    __slots__ = ("nbytes", "queue_delay_s", "peak_concurrency", "transfers")

    def __init__(self):
        self.nbytes = 0.0
        self.queue_delay_s = 0.0
        self.peak_concurrency = 0
        self.transfers = 0


class LinkModel:
    """Shared multi-segment interconnect with per-segment occupancy."""

    def __init__(self, bw: float = DEFAULT_LINK_BW, latency_s: float = 1e-3,
                 bw_by_link: Optional[Dict[Hashable, float]] = None,
                 topology: Optional[Topology] = None):
        self.bw = float(bw)
        self.latency_s = float(latency_s)
        self.bw_by_link: Dict[Hashable, float] = dict(bw_by_link or {})
        self.topology = topology
        self._active: Dict[LinkTransfer, None] = {}   # insertion-ordered set
        # Incremental per-segment demand: flows indexed by segment,
        # and each segment's share sum maintained on start/retire by
        # re-summing ONLY that segment's flows (the flows that share a
        # segment with the changed path) — never the whole fabric.  The
        # per-segment flow dicts preserve `_active` insertion order, so an
        # incremental re-sum adds the SAME floats in the SAME order as the
        # full `_seg_counts` scan: the maintained counts are bit-identical
        # to a recompute, not merely close.
        self._seg_flows: Dict[Hashable, Dict[LinkTransfer, None]] = {}
        self._counts: Dict[Hashable, float] = {}
        # FLEX_SANITIZE=1: periodically cross-check the incremental counts
        # against a full recompute (exact equality, per the order argument)
        self._sanitize = os.environ.get("FLEX_SANITIZE", "") == "1"
        self._sanitize_tick = 0
        self._last_t: Optional[float] = None
        self.failed_segments: set = set()
        # aggregate stats (benchmarks report transfer-queueing delay)
        self.completed = 0             # DELIVERED transfers only
        self.bytes_moved = 0.0         # bytes that actually crossed links
        self.busy_time = 0.0           # sum of actual transfer durations
        self.queueing_delay = 0.0      # sum of (actual - contention-free)
        self.torn_down = 0             # transfers killed by fail_segment
        self.bytes_lost = 0.0          # their undelivered remainders
        self._seg_stats: Dict[Hashable, _SegStats] = {}

    # ----------------------------------------------------------- bandwidth
    def link_bw(self, seg: Hashable) -> float:
        if seg in self.bw_by_link:
            return self.bw_by_link[seg]
        if self.topology is not None:
            bw = self.topology.segment_bw(seg)
            if bw is not None:
                return bw
        return self.bw

    def _solo_bw(self, path: Tuple[Hashable, ...]) -> float:
        return min(self.link_bw(s) for s in path)

    def ideal_time(self, nbytes: float, link: Hashable = None,
                   share: float = 1.0) -> float:
        """Contention-free reference duration of one transfer (a flow with
        a fractional demand ``share`` peaks at that fraction of the
        bandwidth even alone)."""
        path = as_path(link) if link is not None else None
        bw = self._solo_bw(path) if path else self.bw
        return self.latency_s + nbytes / (bw * min(share, 1.0))

    # ----------------------------------------------------------- occupancy
    def _seg_counts(self) -> Dict[Hashable, float]:
        """Per-segment demand by FULL recompute: the sum of the shares of
        the flows crossing each segment (equal to the flow count when every
        share is 1.0 — the classic even processor split).  The hot paths
        read the incrementally-maintained ``_counts`` instead; this scan
        remains as the FLEX_SANITIZE cross-check's ground truth."""
        counts: Dict[Hashable, float] = {}
        for x in self._active:
            for s in x.path:
                counts[s] = counts.get(s, 0.0) + x.share
        return counts

    def _index_flow(self, x: LinkTransfer) -> None:
        """Register a flow on its segments and refresh exactly those
        segments' demand sums (the flows sharing a segment with ``x``)."""
        for s in x.path:
            flows = self._seg_flows.get(s)
            if flows is None:
                flows = self._seg_flows[s] = {}
            flows[x] = None
            self._counts[s] = sum(f.share for f in flows)

    def _unindex_flow(self, x: LinkTransfer) -> None:
        for s in x.path:
            flows = self._seg_flows.get(s)
            if flows is None:
                continue
            flows.pop(x, None)
            if flows:
                self._counts[s] = sum(f.share for f in flows)
            else:
                del self._seg_flows[s]
                self._counts.pop(s, None)

    def _check_counts(self) -> None:
        """FLEX_SANITIZE cross-check (every 64th mutation): the maintained
        counts must EQUAL a full recompute — same floats, same order."""
        self._sanitize_tick += 1
        if self._sanitize_tick % 64:
            return
        full = self._seg_counts()
        assert full == self._counts, (
            "incremental link demand diverged from full recompute",
            {k: (full.get(k), self._counts.get(k))
             for k in set(full) | set(self._counts)
             if full.get(k) != self._counts.get(k)})

    def _rate(self, x: LinkTransfer, counts: Dict[Hashable, float]) -> float:
        # weighted processor sharing: a segment under-subscribed in total
        # demand gives each flow its full share; oversubscribed, flows
        # split the bandwidth in proportion to their shares
        return min(self.link_bw(s) * x.share / max(counts[s], 1.0)
                   for s in x.path)

    def _bottleneck(self, x: LinkTransfer,
                    counts: Dict[Hashable, float]) -> Hashable:
        return min(x.path, key=lambda s: self.link_bw(s) / max(counts[s], 1.0))

    def active_count(self, seg: Hashable) -> int:
        return len(self._seg_flows.get(seg, ()))

    def active_on(self, seg: Hashable) -> List[LinkTransfer]:
        return list(self._seg_flows.get(seg, ()))

    def active_transfers(self) -> List[LinkTransfer]:
        return list(self._active)

    def _seg(self, seg: Hashable) -> _SegStats:
        st = self._seg_stats.get(seg)
        if st is None:
            st = self._seg_stats[seg] = _SegStats()
        return st

    # ------------------------------------------------------------ dynamics
    def _advance(self, now: float) -> None:
        """Drain progress since the last update at each flow's min share.

        Queueing delay is attributed to each flow's BOTTLENECK segment:
        the extra time to move the bytes it moved this interval, relative
        to its contention-free (solo) rate over the same path."""
        if self.failed_segments:
            for x in self._active:
                if x.remaining > 0 and any(
                        s in self.failed_segments for s in x.path):
                    self._tear_down(x)  # drains at the next poll
        if self._last_t is None:
            self._last_t = now
            return
        dt = now - self._last_t
        self._last_t = max(self._last_t, now)
        if dt <= 0 or not self._active:
            return
        counts = self._counts
        for x in self._active:
            if x.remaining <= 0:
                continue
            rate = self._rate(x, counts)
            moved = min(x.remaining, dt * rate)
            x.remaining -= moved
            if moved <= 0:
                continue
            for s in x.path:
                self._seg(s).nbytes += moved
            solo = self._solo_bw(x.path) * min(x.share, 1.0)
            lost = moved / rate - moved / solo
            if lost > 0:
                self._seg(self._bottleneck(x, counts)).queue_delay_s += lost

    def start(self, link, nbytes: float, now: float,
              share: float = 1.0) -> LinkTransfer:
        self._advance(now)
        x = LinkTransfer(as_path(link), nbytes, now, share=share)
        self._active[x] = None
        self._index_flow(x)
        if self._sanitize:
            self._check_counts()
        for s in x.path:
            st = self._seg(s)
            st.transfers += 1
            st.peak_concurrency = max(st.peak_concurrency,
                                      self.active_count(s))
        return x

    def occupancy(self) -> Dict[Hashable, float]:
        """Per-segment DEMAND: the sum of the shares of the flows crossing
        each segment (equals the integer flow count when every share is
        1.0 — use ``active_count`` for the flow count proper).  A snapshot
        drivers may pass back into ``eta`` to batch-estimate many flows
        without recomputing the sums per call."""
        return dict(self._counts)

    def eta(self, x: LinkTransfer, now: float,
            counts: Optional[Dict[Hashable, float]] = None) -> float:
        """Completion time under CURRENT occupancy (exact if it persists).
        ``counts`` short-circuits the per-call occupancy scan when the
        caller already holds a fresh ``occupancy()`` snapshot."""
        self._advance(now)
        if x not in self._active:
            return max(now, x.done_t)
        if counts is None:
            counts = self._counts
        if x.remaining <= 0:
            return max(x.start_t + self.latency_s, now)
        t_bytes = now + x.remaining / self._rate(x, counts)
        return max(x.start_t + self.latency_s, t_bytes)

    def _tear_down(self, x: LinkTransfer) -> None:
        """Declare a flow's remaining bytes lost (severed segment): it
        drains at the next poll but retires as torn-down, not delivered."""
        x.lost += x.remaining
        x.remaining = 0.0

    def fail_segment(self, seg: Hashable, now: float) -> None:
        """Sever one segment: transfers crossing it tear down (their
        remaining bytes are LOST at the modeling level — the daemon op
        completes so the copy engine is not wedged, and the caller aborts
        the affected streams and re-routes their requests).  Later
        transfers routed over the dead segment tear down the same way, so
        a stale path cannot wedge a copy engine either."""
        self._advance(now)
        self.failed_segments.add(seg)
        for x in self._active:
            if seg in x.path and x.remaining > 0:
                self._tear_down(x)

    def poll(self, x: LinkTransfer, now: float) -> bool:
        """Advance the fabric; True (and retire the transfer) once done."""
        self._advance(now)
        # done-threshold: absolute 1e-3 for byte-denominated transfers (the
        # historical float tolerance), but never more than a ppb of the
        # transfer itself — the compute-contention model denominates work
        # in seconds, where 1e-3 would swallow entire decode steps
        thresh = min(1e-3, max(x.nbytes * 1e-9, 1e-12))
        if x.remaining > thresh \
                or now < x.start_t + self.latency_s - 1e-12:
            return False
        if x not in self._active:
            return False               # stale poll of a retired transfer
        del self._active[x]
        self._unindex_flow(x)
        if self._sanitize:
            self._check_counts()
        x.done_t = now
        if x.lost > 0:
            # torn down by a segment failure: the undelivered remainder is
            # LOST, not moved — keep it out of the delivery aggregates so
            # fault runs don't report lost bytes as throughput
            self.torn_down += 1
            self.bytes_lost += x.lost
            self.bytes_moved += x.nbytes - x.lost
            return True
        self.completed += 1
        self.bytes_moved += x.nbytes
        self.busy_time += x.elapsed
        self.queueing_delay += max(
            0.0, x.elapsed - self.ideal_time(x.nbytes, x.path, x.share))
        return True

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, float]:
        n = max(1, self.completed)
        per_link = {
            seg_key(seg): {
                "bytes": st.nbytes,
                "transfers": st.transfers,
                "queue_delay_s": round(st.queue_delay_s, 6),
                "peak_concurrency": st.peak_concurrency,
            }
            for seg, st in sorted(self._seg_stats.items(),
                                  key=lambda kv: seg_key(kv[0]))
        }
        out = {
            "transfers": self.completed,
            "bytes_moved": self.bytes_moved,
            "transfer_time_mean_s": self.busy_time / n,
            "transfer_queue_delay_mean_s": self.queueing_delay / n,
            "transfer_queue_delay_total_s": self.queueing_delay,
            "peak_link_concurrency": max(
                (st.peak_concurrency for st in self._seg_stats.values()),
                default=0),
            "per_link": per_link,
        }
        if self.torn_down:
            out["transfers_torn_down"] = self.torn_down
            out["bytes_lost"] = self.bytes_lost
        return out

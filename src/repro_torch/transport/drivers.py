"""Drivers gluing the path-aware :class:`LinkModel` onto both drive modes.

The same two drivers also drive the **compute-contention model** (a
``LinkModel`` over per-device ``("flops", name)`` segments with
fractional demand shares): concurrent compute-queue ops on one device
split modeled FLOP throughput exactly like concurrent transfers split a
link, so both drive modes honor execution-queue contention through one
mechanism (``share`` below is the flow's demand weight; 1.0 for plain
link transfers).

Processor-shared segments change EVERY sharing transfer's finish time when
one starts or completes — and with multi-hop paths the blast radius is any
flow crossing any segment of the changed path.  Both drivers therefore
re-poll broadly on occupancy change:

  * :class:`LinkDriver` (stepped) schedules a completion *poll* at each
    transfer's current ETA on the discrete-event loop and re-schedules all
    active transfers whenever one starts or finishes.  Early (stale) polls
    are harmless: ``LinkModel.poll`` just reports not-done and a later
    poll is already queued.
  * :class:`ThreadedLinkTimer` (threaded) blocks the calling copy-engine
    thread until its transfer completes on the shared model — the engine
    IS busy for the duration, exactly like the one-op-per-engine rule —
    re-polling at its current ETA as contending flows stretch it.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict

from repro_torch.transport.links import LinkModel, LinkTransfer


class LinkDriver:
    """Stepped drive: completion polls on the discrete-event loop."""

    def __init__(self, loop, model: LinkModel):
        self.loop = loop
        self.model = model
        self._done_cbs: Dict[LinkTransfer, Callable] = {}

    def start(self, link, nbytes: float, done_cb: Callable,
              share: float = 1.0) -> LinkTransfer:
        x = self.model.start(link, nbytes, self.loop.clock.t, share=share)
        self._done_cbs[x] = done_cb
        self._schedule_polls(x.path)
        return x

    def repoll(self) -> None:
        """Re-evaluate every active transfer's ETA now — call after an
        out-of-band model change (a segment failure, a bandwidth edit)."""
        self._schedule_polls(None)

    def _schedule_polls(self, path) -> None:
        """Re-poll transfers whose ETA may have moved: only flows sharing
        at least one segment with ``path`` (None = all flows).  Occupancy
        is count-based, so a start/finish cannot move the ETA of a flow
        with a disjoint path — scoping keeps event churn linear in the
        number of SHARING flows, not all flows."""
        now = self.loop.clock.t
        segs = None if path is None else set(path)
        counts = self.model.occupancy()   # one scan for the whole batch
        for x in self.model.active_transfers():
            if segs is not None and segs.isdisjoint(x.path):
                continue
            self.loop.at(self.model.eta(x, now, counts),
                         lambda x=x: self._poll(x))

    def _poll(self, x: LinkTransfer) -> None:
        cb = self._done_cbs.get(x)
        if cb is None:
            return                     # already completed via an earlier poll
        if self.model.poll(x, self.loop.clock.t):
            del self._done_cbs[x]
            self._schedule_polls(x.path)   # sharing peers now finish earlier
            cb(x)


class ThreadedLinkTimer:
    """Threaded drive: block the calling engine thread for the
    occupancy-aware duration, re-polling at the current ETA (``scale``
    converts virtual seconds to wall seconds, as in
    ``repro_torch.serving.realtime``).

    ``sleep_overhead_s`` is the calibrated wall overhead each
    ``time.sleep`` adds on this host (timer granularity + scheduler
    wakeup); it is subtracted from every poll sleep so short transfers —
    in particular the compute-contention model's per-op work, whose
    modeled durations rival the sleep overshoot at small time scales —
    do not inflate virtual time."""

    def __init__(self, model: LinkModel, clock, scale: float,
                 sleep_overhead_s: float = 0.0):
        # the shared LinkModel: every mutation/poll runs under _lock (the
        # copy-engine worker threads and fault injectors all route here)
        self.model = model                   # guarded-by: _lock
        self.clock = clock
        self.scale = float(scale)
        self.sleep_overhead_s = float(sleep_overhead_s)
        self._lock = threading.Lock()

    def fail_segment(self, seg, now: float) -> None:
        """Sever a segment under THIS timer's lock — the copy-engine
        threads mutate the shared model under it, so an out-of-band
        caller (the cluster's fault injector runs on another thread) must
        not race their poll/advance iteration."""
        with self._lock:
            self.model.fail_segment(seg, now)

    def transfer(self, link, nbytes: float, share: float = 1.0) -> None:
        with self._lock:
            x = self.model.start(link, nbytes, self.clock.t, share=share)
        while True:
            with self._lock:
                if self.model.poll(x, self.clock.t):
                    return
                eta = self.model.eta(x, self.clock.t)
            # cap the sleep so out-of-band model changes (segment failure,
            # bandwidth edits) are noticed within a bounded wall delay;
            # subtract the per-sleep overshoot so short transfers pace true
            wall = (eta - self.clock.t) * self.scale - self.sleep_overhead_s
            time.sleep(min(wall, 0.05) if wall > 0 else 0)

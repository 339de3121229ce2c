"""Happens-before hazard sanitizer for FlexDaemon dispatch (v7).

Opt in with ``FLEX_SANITIZE=1``: ``connect()`` then builds ONE
:class:`HazardSanitizer` per session, hands it to every daemon, and
``Session.close()`` raises if any hazard went undrained.

**Model.**  Vector clocks keyed by ``(device_id, vstream)``.  Ordering
edges come from exactly the sources the runtime guarantees:

* **same-vstream FIFO** — every completed op increments its stream's
  own component, so program order within a stream is always ordered;
* **event record/wait** — a completing ``RECORD_EVENT`` joins its clock
  into the event's clock (session-scoped negative handles share one
  key across devices); a completing ``WAIT_EVENT`` joins the event's
  clock into its stream;
* **memcpy/memcpy_peer** — the op's completion clock stamps each buffer
  access, and a peer copy's destination write carries the SOURCE op's
  clock onto the destination device's buffer;
* **host observation** — awaiting an op's ``Future`` (``result()``) or
  running its done-callbacks joins the op's clock into a session-wide
  host clock, and every subsequently ENQUEUED op inherits that snapshot:
  host-synchronized chains (await a copy, then launch the consumer; a
  completion callback enqueueing follow-up work) are ordered without
  device events.  Completion alone publishes nothing — two racing
  fire-and-forget writes stay hazardous no matter which finished first.

Two memcpy-layer accesses to the same ``(device, handle)`` where at
least one writes and neither clock dominates the other is a hazard
(``write-write`` / ``read-write``).  ``FREE`` linearizes at its inline
control-op point: the daemon's ``_mem_refs`` gate already forbids
freeing under a pending copy, so any access observed AFTER the free is
a ``free-vs-use`` hazard unconditionally.

**Determinism.**  The stepped drive completes ops single-threaded in
simulated-time order, so the observed linearization — and therefore the
hazard report — is deterministic.  The threaded drive calls in from
per-queue worker threads; the sanitizer serializes them on its own lock
and checks the linearization it observed (best-effort: a racy schedule
may order two unsynchronized ops by luck; rerun to widen coverage).

**Scope.**  The checker validates the EXECUTION IT SAW, not all
executions: a wait whose target event had no records (``wait_target
0``) is vacuously ordered, and read histories are pruned only by a
dominating write (never by later reads), so a read-write race is missed
only if a third, ordering write intervenes.  Overhead is one dict copy
plus an O(history) scan per memcpy completion — zero when disabled
(daemon hooks are ``None``-guarded).
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, NamedTuple, Tuple

from repro_torch.core.api import MemcpyKind, OpType

Clock = Dict[Tuple, int]


def sanitize_enabled() -> bool:
    return os.environ.get("FLEX_SANITIZE", "") not in ("", "0")


def _join(dst: Clock, src: Clock) -> None:
    for k, v in src.items():
        if v > dst.get(k, 0):
            dst[k] = v


class _Access(NamedTuple):
    kind: str            # "r" | "w"
    stream: Tuple        # (device_id, vstream)
    clock: Clock         # completion-time clock (never mutated afterward)
    label: str

    def ordered_before(self, clock: Clock) -> bool:
        return clock.get(self.stream, 0) >= self.clock.get(self.stream, 0)


_KIND_NAMES = {"r": "read", "w": "write"}


class HazardSanitizer:
    """One per session; daemons call the ``on_*`` hooks (see module doc)."""

    def __init__(self):
        self._lk = threading.Lock()          # serializes threaded-drive calls
        self._stream_clock: Dict[Tuple, Clock] = {}
        self._event_clock: Dict[Tuple, Clock] = {}
        self._host: Clock = {}               # joined on future observation
        self._mem: Dict[Tuple, List[_Access]] = {}
        self._freed: Dict[Tuple, str] = {}
        self.hazards: List[str] = []

    def drain(self) -> List[str]:
        """Return and clear the accumulated hazards (tests that PROVOKE a
        hazard drain it so ``Session.close()`` doesn't raise)."""
        with self._lk:
            out, self.hazards = self.hazards, []
            return out

    # ------------------------------------------------------- daemon hooks
    def on_malloc(self, daemon, handle: int) -> None:
        key = (daemon.device_id, handle)
        with self._lk:
            self._mem[key] = []
            self._freed.pop(key, None)       # handles are never reused, but
            #                                  stay safe if that ever changes

    def on_free(self, daemon, handle: int) -> None:
        key = (daemon.device_id, handle)
        with self._lk:
            self._mem.pop(key, None)
            self._freed[key] = f"free(dev{daemon.device_id}, h{handle})"

    def on_enqueue(self, daemon, op) -> None:
        """Called as the op is queued: snapshot the host clock so every
        completion the host has OBSERVED by now orders this op."""
        with self._lk:
            if self._host:
                op.meta["_hb_host"] = dict(self._host)

    def _observe(self, clock: Clock) -> None:
        # Future._hb_observed target: result()/done-callbacks publish the
        # op's clock to the host — the CUDA-style host-sync edge
        with self._lk:
            _join(self._host, clock)

    def on_complete(self, daemon, op) -> None:
        """Called by ``mark_complete`` after the op's effect applied."""
        with self._lk:
            skey = (daemon.device_id, op.vstream)
            clock = dict(self._stream_clock.get(skey, ()))
            host = op.meta.pop("_hb_host", None)
            if host:
                _join(clock, host)
            if op.op == OpType.WAIT_EVENT and op.vhandles:
                ekey = self._event_key(daemon, op.vhandles[0])
                _join(clock, self._event_clock.get(ekey, {}))
            clock[skey] = clock.get(skey, 0) + 1
            self._stream_clock[skey] = clock
            if op.op == OpType.RECORD_EVENT and op.vhandles:
                ekey = self._event_key(daemon, op.vhandles[0])
                _join(self._event_clock.setdefault(ekey, {}), clock)
            label = (f"{op.op.name.lower()}#{op.op_id}"
                     f"@dev{daemon.device_id}/vs{op.vstream}")
            for key, kind in self._buffer_accesses(daemon, op):
                self._check_access(key, kind, skey, clock, label)
            fut = getattr(op, "future", None)
            if fut is not None:
                fut._hb_observed = lambda c=clock: self._observe(c)

    # ---------------------------------------------------------- internals
    @staticmethod
    def _event_key(daemon, vevent: int) -> Tuple:
        # session-scoped events (negative handles) are one key cluster-wide
        return ("shared", vevent) if vevent < 0 else \
            (daemon.device_id, vevent)

    @staticmethod
    def _buffer_accesses(daemon, op) -> List[Tuple[Tuple, str]]:
        out: List[Tuple[Tuple, str]] = []
        dev = daemon.device_id
        if op.op == OpType.MEMCPY and op.vhandles:
            kind = MemcpyKind(op.meta.get("kind", MemcpyKind.D2D))
            if kind == MemcpyKind.H2D:
                out.append(((dev, op.vhandles[0]), "w"))
            elif kind == MemcpyKind.D2H:
                out.append(((dev, op.vhandles[0]), "r"))
            elif len(op.vhandles) == 2:      # D2D: (dst, src)
                out.append(((dev, op.vhandles[0]), "w"))
                out.append(((dev, op.vhandles[1]), "r"))
        elif op.op == OpType.MEMCPY_PEER:
            if op.vhandles:
                out.append(((dev, op.vhandles[0]), "r"))
            dst_daemon = op.meta.get("_dst_daemon")
            dst_handle = op.meta.get("dst_handle")
            if dst_daemon is not None and dst_handle is not None:
                out.append(((dst_daemon.device_id, dst_handle), "w"))
        return out

    def _check_access(self, key: Tuple, kind: str, skey: Tuple,
                      clock: Clock, label: str) -> None:
        if key in self._freed:
            self.hazards.append(
                f"free-vs-use hazard on dev{key[0]} handle {key[1]}: "
                f"{label} after {self._freed[key]}")
            return
        hist = self._mem.setdefault(key, [])
        for prev in hist:
            if (prev.kind == "w" or kind == "w") \
                    and not prev.ordered_before(clock):
                self.hazards.append(
                    f"{_KIND_NAMES[prev.kind]}-{_KIND_NAMES[kind]} hazard "
                    f"on dev{key[0]} handle {key[1]}: {prev.label} and "
                    f"{label} have no happens-before edge")
        if kind == "w":
            # a dominating write supersedes everything it is ordered
            # after; reads never prune reads (a future unordered write
            # must still race BOTH of them)
            hist[:] = [p for p in hist if not p.ordered_before(clock)]
        hist.append(_Access(kind, skey, clock, label))

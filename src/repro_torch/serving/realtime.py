"""Real-time (threaded) drive for the cluster: wall clock instead of DES.

The discrete-event simulator steps daemons by hand (``select_next`` /
``mark_complete``) on a virtual clock.  This module provides the second
drive mode: the SAME cluster, instances, policies, and cost model, but the
daemons run their real dispatch threads (``connect(mode="flex")``) against
a :class:`RealTimeSimBackend` that *blocks* each op's engine thread for its
modeled duration — scaled by ``time_scale`` so a 60-virtual-second run
takes ~``60 * time_scale`` wall seconds.

Why it exists: the control plane (dispatch policies, admission, cluster
routing, role switching) must behave identically whether the daemons are
driven by the stepper or by real threads — that is the dual-drive property
the rest of the repo maintains, now extended to cluster scale.  Timing in
this mode carries real scheduling jitter; tests that assert on it use the
``FLEX_TIMING_SLACK`` knob.

  * :class:`WallClock` — virtual ``now`` derived from the wall clock.
  * :class:`RealTimeLoop` — EventLoop-compatible (``at``/``after``/``run``)
    scheduler that fires events at their scaled wall deadlines while daemon
    threads make progress concurrently.
  * :class:`RealTimeSimBackend` — executes LAUNCH ops as scaled sleeps and
    paces non-launch data ops (the daemon's ``pace`` hook).

The occupancy-aware transfer timing this drive blocks its copy-engine
threads on lives in the KV transport subsystem
(:class:`repro_torch.transport.drivers.ThreadedLinkTimer` — the threaded
analogue of the stepped ``LinkDriver``; its one-release re-export from
this module was removed, import it from ``repro_torch.transport.drivers``).
The same timer class, over a per-device ``("flops", name)`` share model,
paces concurrent compute-queue ops so the threaded drive honors
execution-queue contention exactly like the stepped drive.

Pacing calibration: real dispatch (thread wakeups, queue handoffs, the
sleep syscall itself) adds wall overhead to every op beyond the modeled
``duration * time_scale``.  At small time scales that overhead rivals the
modeled sleep and inflates virtual time, so the backend measures the
per-op overhead once at startup (:func:`calibrate_dispatch_overhead`) and
subtracts it from each pace — larger workloads then stay faithful at
small ``time_scale``.  The measured value is surfaced through
``RealTimeSimBackend.calibration()`` into ``Cluster.run()`` telemetry.
"""
from __future__ import annotations

import heapq
import itertools
import math
import threading
import time
from typing import Callable, List, Optional, Tuple

from repro_torch.core.api import OpDescriptor, OpType, Phase

from repro_torch.transport.drivers import ThreadedLinkTimer


class WallClock:
    """Virtual time derived from the wall clock: ``t`` advances at
    ``1 / scale`` virtual seconds per wall second once started."""

    def __init__(self, scale: float):
        self.scale = float(scale)
        self._t0: Optional[float] = None

    def start(self) -> None:
        if self._t0 is None:
            self._t0 = time.monotonic()

    @property
    def t(self) -> float:
        if self._t0 is None:
            return 0.0
        return (time.monotonic() - self._t0) / self.scale

    def now(self) -> float:
        return self.t


class RealTimeLoop:
    """EventLoop-compatible scheduler over a :class:`WallClock`.

    ``at``/``after`` are thread-safe (daemon callbacks re-arm policy
    ticks); ``run`` fires events at their scaled wall deadlines and returns
    once the heap is empty AND ``idle()`` reports the cluster quiescent
    (daemon threads finish work the loop never sees)."""

    def __init__(self, time_scale: float = 0.05):
        self.scale = float(time_scale)
        self.clock = WallClock(self.scale)
        self._heap: List[Tuple[float, int, Callable]] = []  # guarded-by: _cv
        self._seq = itertools.count()
        self._cv = threading.Condition()

    def at(self, t: float, fn: Callable) -> None:
        with self._cv:
            heapq.heappush(self._heap,
                           (max(t, self.clock.t), next(self._seq), fn))
            self._cv.notify()

    def after(self, dt: float, fn: Callable) -> None:
        self.at(self.clock.t + dt, fn)

    def defer(self, fn: Callable) -> None:
        """Driver-loop hook (v5), the threaded analogue of
        ``EventLoop.defer``: hand ``fn`` to the loop thread at the current
        virtual time.  Closed-loop traffic callbacks run here instead of
        on the daemon engine thread that retired the request — same
        re-entrancy rule as the stepped drive, plus thread confinement."""
        self.at(self.clock.t, fn)

    def run(self, until: float = math.inf,
            idle: Optional[Callable[[], bool]] = None) -> None:
        self.clock.start()
        while True:
            if self.clock.t >= until:
                return                       # virtual-time horizon reached
            with self._cv:
                if not self._heap:
                    if idle is None or idle():
                        return
                    self._cv.wait(0.01)      # daemons still working: poll
                    continue
                t = self._heap[0][0]
                wall_wait = (t - self.clock.t) * self.scale
                if wall_wait > 1e-4:
                    # may be woken early by an at() for a sooner event
                    self._cv.wait(min(wall_wait, 0.05))
                    continue
                _, _, fn = heapq.heappop(self._heap)
            fn()


# process-wide cache: the overhead is a property of this host + Python
# runtime, not of any one cluster, so measure it once
_DISPATCH_OVERHEAD_S: Optional[float] = None
# cap the correction: a wildly contended measurement must not erase real
# modeled durations (pacing is deadline-based, so over-subtraction only
# costs spin-yield time, never early completion — but bound it anyway)
_MAX_OVERHEAD_S = 2e-3


def calibrate_dispatch_overhead(samples: int = 50,
                                force: bool = False) -> float:
    """Measured per-op wall overhead of a paced dispatch on this host.

    Each paced op costs one short ``time.sleep`` whose realized duration
    overshoots the request (timer granularity + scheduler wakeup), plus
    queue handoffs.  The probe times ``samples`` short sleeps and takes
    the median overshoot, clamped to a conservative cap.  Folding this
    into the pacing (subtracting it from every sleep) keeps virtual time
    from inflating at small ``time_scale``."""
    global _DISPATCH_OVERHEAD_S
    if _DISPATCH_OVERHEAD_S is not None and not force:
        return _DISPATCH_OVERHEAD_S
    # probe at a millisecond-scale sleep — the size a typical paced op
    # actually requests — because overshoot varies with the request size
    # (tiny sleeps overshoot far more than their own length)
    req = 1e-3
    overshoots = []
    for _ in range(samples):
        t0 = time.monotonic()
        time.sleep(req)
        overshoots.append(time.monotonic() - t0 - req)
    overshoots.sort()
    med = overshoots[len(overshoots) // 2]
    _DISPATCH_OVERHEAD_S = min(max(med, 0.0), _MAX_OVERHEAD_S)
    return _DISPATCH_OVERHEAD_S


class RealTimeSimBackend:
    """Backend for threaded daemons inside the real-time cluster drive.

    LAUNCH ops block their engine thread for the modeled duration (scaled,
    minus the calibrated per-op dispatch overhead); non-launch data ops
    are paced the same way, except link-keyed peer copies which block on
    the :class:`ThreadedLinkTimer` so same-link transfers contend.  On
    multi-queue devices, compute launches block on ``compute_timer`` (the
    same timer class over the per-device FLOP share model) so concurrent
    compute ops contend exactly as in the stepped drive.  Payload effects
    still happen in ``mark_complete`` — this backend only owns *when*,
    like the stepped ``SimBackend``."""

    def __init__(self, clock: WallClock, scale: float,
                 link_timer: Optional[ThreadedLinkTimer] = None,
                 compute_timer: Optional[ThreadedLinkTimer] = None,
                 dispatch_overhead_s: Optional[float] = None):
        self.clock = clock
        self.scale = float(scale)
        self.link_timer = link_timer
        self.compute_timer = compute_timer
        self.dispatch_overhead_s = (
            calibrate_dispatch_overhead() if dispatch_overhead_s is None
            else float(dispatch_overhead_s))

    def calibration(self) -> dict:
        """Startup pacing calibration, for ``Cluster.run()`` telemetry."""
        return {
            "dispatch_overhead_wall_s": round(self.dispatch_overhead_s, 7),
            "dispatch_overhead_virtual_s": round(
                self.dispatch_overhead_s / self.scale, 7),
            "time_scale": self.scale,
        }

    def now(self) -> float:
        return self.clock.t

    def estimate(self, op: OpDescriptor) -> float:
        return float(op.meta.get("est_duration", 1e-3))

    def _sleep(self, virtual_dur: float) -> None:
        """Pace one op: the modeled duration scaled to wall time, minus
        the calibrated overhead the dispatch machinery adds around it.
        Ops whose scaled duration is below the overhead skip the sleep
        entirely — the dispatch path itself already costs that much wall
        time, so sleeping on top of it would double-bill the op."""
        wall = virtual_dur * self.scale - self.dispatch_overhead_s
        if wall > 0:
            time.sleep(wall)

    def execute(self, op: OpDescriptor):
        # the op's SimInstance (stamped at enqueue) owns the duration:
        # decode late-binds its batch, slow_factor applies, EWMA updates —
        # the same op_duration the stepped _dispatch uses
        inst = op.meta.get("_sim_inst")
        if inst is None:
            self._sleep(self.estimate(op))
            return None
        dur = inst.op_duration(op)
        if (self.compute_timer is not None
                and getattr(inst, "shares_compute", False)
                and op.phase in (Phase.PREFILL, Phase.DECODE)):
            # multi-queue device: block on the FLOP share model so a
            # co-located compute op stretches this one by its share
            share = inst.op_compute_share(op)
            self.compute_timer.transfer(inst.compute_key, dur * share,
                                        share=share)
            return None
        self._sleep(dur)
        return None

    def pace(self, op: OpDescriptor) -> None:
        if (op.op == OpType.MEMCPY_PEER and self.link_timer is not None
                and op.meta.get("link") is not None):
            self.link_timer.transfer(op.meta["link"],
                                     float(op.meta.get("nbytes", 0)))
            return
        dur = self.estimate(op)
        if dur > 0:
            self._sleep(dur)

"""Runtime profiler (paper §3.3): lightweight per-phase statistics.

Collected from the interception layer and daemon:
  * EWMA operator execution time and queue delay per phase,
  * memory-bandwidth pressure of decode (bytes touched / exec time / HBM peak),
  * device utilization (busy fraction over a sliding horizon).

These are 'coarse but useful' signals (the paper's words) — the scheduler
reads them to steer the prefill/decode dispatch ratio.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.api import OpDescriptor, OpType, Phase

HBM_BW_BYTES = 3.35e12      # H100 SXM HBM3 bandwidth (NVIDIA data sheet)
PEAK_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak (data sheet)


@dataclasses.dataclass
class PhaseStats:
    ewma_exec: float = 0.0          # seconds
    ewma_queue_delay: float = 0.0
    ewma_bytes: float = 0.0         # bytes touched per op

    def bandwidth_util(self) -> float:
        """Estimated HBM pressure of this phase's ops (0..1)."""
        if self.ewma_exec <= 0:
            return 0.0
        return min(1.0, self.ewma_bytes / self.ewma_exec / HBM_BW_BYTES)


class Profiler:
    def __init__(self, alpha: float = 0.2, horizon: float = 10.0):
        self.alpha = alpha
        self.horizon = horizon
        self.stats: Dict[Phase, PhaseStats] = {p: PhaseStats() for p in Phase}
        self._busy_events: Deque[Tuple[float, float]] = collections.deque()
        self._window_start = 0.0

    def _ewma(self, old: float, new: float) -> float:
        if old == 0.0:
            return new
        return (1 - self.alpha) * old + self.alpha * new

    def on_complete(self, op: OpDescriptor) -> None:
        s = self.stats[op.phase]
        s.ewma_exec = self._ewma(s.ewma_exec, op.exec_time)
        s.ewma_queue_delay = self._ewma(s.ewma_queue_delay, op.queue_delay)
        if "bytes" in op.meta:
            s.ewma_bytes = self._ewma(s.ewma_bytes, float(op.meta["bytes"]))
        if op.op == OpType.LAUNCH:
            self._busy_events.append((op.dispatch_time, op.complete_time))
            # what ended before the horizon adds nothing to a later
            # device_utilization(now >= complete_time): keep the deque short
            lo = op.complete_time - self.horizon
            while self._busy_events and self._busy_events[0][1] < lo:
                self._busy_events.popleft()

    def device_utilization(self, now: float) -> float:
        """Busy fraction over the trailing horizon."""
        lo = now - self.horizon
        while self._busy_events and self._busy_events[0][1] < lo:
            self._busy_events.popleft()
        busy = sum(min(e, now) - max(s, lo) for s, e in self._busy_events
                   if min(e, now) > max(s, lo))
        return min(1.0, busy / self.horizon) if self.horizon > 0 else 0.0

    def decode_bandwidth_util(self) -> float:
        return self.stats[Phase.DECODE].bandwidth_util()


# --------------------------------------------------------------- timeline
def profile_enabled() -> bool:
    """``FLEX_PROFILE=1`` turns on per-op timeline capture (PR 9)."""
    return os.environ.get("FLEX_PROFILE", "") == "1"


def profile_dir() -> str:
    """Where ``Session.close`` writes trace files (``FLEX_PROFILE_DIR``,
    default: current directory)."""
    return os.environ.get("FLEX_PROFILE_DIR", ".")


_TRACE_IDS = itertools.count(1)

# the Timeline of the session being traced, for code that holds no session
# (the model's step, a benchmark's readers): set when a Timeline starts,
# cleared when it is written out; None while FLEX_PROFILE is off
ACTIVE: Optional["Timeline"] = None


def _clock_anchor() -> Tuple[int, int]:
    """(monotonic ns, Unix ns) read back to back, the Unix reading the
    mean of two taken around the monotonic one."""
    a = time.time_ns()
    m = time.monotonic_ns()
    b = time.time_ns()
    return m, (a + b) // 2


class Timeline:
    """Per-op timeline recorder → Chrome-trace JSON (PR 9, opt-in).

    One Timeline spans a session (like the hazard sanitizer): every
    daemon's ``mark_complete`` appends one complete event per op, and
    ``Session.close`` dumps ``flextrace-<pid>-<n>.json`` into
    :func:`profile_dir`.  Load the file in ``chrome://tracing`` or
    Perfetto: rows are (device, execution queue), one slice per op with
    dispatch→complete extents and the op's phase/type/meta in ``args``.

    Capture is OFF unless ``FLEX_PROFILE=1`` — the hot path pays only a
    ``None`` check — and recording is one dict append under a lock, so
    turning it on perturbs (wall-clock) timing but never simulated time.

    The same list holds the host's spans and counters
    (``repro_torch.core.spans``), on the ops' monotonic clock;
    :meth:`to_profiler_ns` maps that clock onto torch.profiler's.
    """

    def __init__(self):
        global ACTIVE
        self._lk = threading.Lock()
        self._events: List[dict] = []
        self._anchors: List[Tuple[int, int]] = [_clock_anchor()]
        ACTIVE = self

    def record(self, device_id: int, op: OpDescriptor) -> None:
        q = op.meta.get("_queue")
        tid = f"{q[0]}:{q[1]}" if q else str(op.meta.get("_engine", "?"))
        ev = {
            "name": f"{op.phase.value}:{op.op.value}",
            "ph": "X",                           # complete event
            "ts": op.dispatch_time * 1e6,        # trace units are µs
            "dur": max(op.exec_time, 0.0) * 1e6,
            "pid": device_id,
            "tid": tid,
            "args": {"op_id": op.op_id, "vstream": op.vstream,
                     "queue_delay_us": max(op.queue_delay, 0.0) * 1e6},
        }
        for k in ("tokens", "bytes", "flops", "instance", "req_id",
                  "ctx", "chunk"):
            if k in op.meta:
                ev["args"][k] = op.meta[k]
        with self._lk:
            self._events.append(ev)
        step = op.meta.get("_step")     # a traced model step (core/spans.py)
        if step is not None:
            step.complete(self, op)

    def add(self, ev: dict) -> None:
        """Append a span or counter event."""
        with self._lk:
            self._events.append(ev)

    def events(self) -> List[dict]:
        anchor = _clock_anchor()
        with self._lk:
            self._anchors.append(anchor)
            return list(self._events)

    def to_profiler_ns(self, mono_ns: float) -> float:
        """A time on this timeline's clock (monotonic ns) on the clock
        torch.profiler stamps CUDA activity with (Unix ns): the offset
        between the two interpolated between the anchor pairs around it,
        read when the timeline started and whenever it was read."""
        with self._lk:
            anchors = list(self._anchors)
        i = bisect.bisect_right([m for m, _ in anchors], mono_ns)
        if i == 0 or i == len(anchors):
            m, u = anchors[min(i, len(anchors) - 1)]
            return mono_ns + (u - m)
        (m0, u0), (m1, u1) = anchors[i - 1], anchors[i]
        f = (mono_ns - m0) / (m1 - m0)
        return mono_ns + (u0 - m0) + f * ((u1 - m1) - (u0 - m0))

    def dump(self, path: Optional[str] = None) -> str:
        """Write the Chrome-trace file; returns the path written."""
        global ACTIVE
        if ACTIVE is self:
            ACTIVE = None
        if path is None:
            path = os.path.join(
                profile_dir(),
                f"flextrace-{os.getpid()}-{next(_TRACE_IDS)}.json")
        with self._lk:
            doc = {"traceEvents": self._events,
                   "displayTimeUnit": "ms",
                   "otherData": {"source": "repro_torch.core.profiler.Timeline"}}
            with open(path, "w") as f:
                json.dump(doc, f)
        return path

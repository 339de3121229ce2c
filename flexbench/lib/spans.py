"""What the program records inside its serving path while it is traced
(``FLEX_PROFILE=1``): spans and counters on the session's op timeline,
reached through the program's one process-level accessor
(``repro_torch.core.profiler.ACTIVE``).  A program without them gives
nothing here, and a reader of them then returns None.

Spans are Chrome-trace events (``"cat": "span"``) on the op events'
monotonic clock, in µs: ``args`` hold ``op_id`` where an op encloses or
caused the span, ``req_id`` where one request did, and ``stream_ms``, on
a CUDA card, a model step's span's time on the step's stream."""
from __future__ import annotations

import bisect
from typing import Dict, List, Set, Tuple

from flexbench.lib import trace


def timeline():
    """The program's active timeline, or None."""
    from repro_torch.core import profiler
    return getattr(profiler, "ACTIVE", None)


def named(*names: str) -> List[Dict]:
    """The spans of these names, in the order they were written."""
    tl = timeline()
    if tl is None:
        return []
    return [e for e in tl.events()
            if e.get("cat") == "span" and e["name"] in names]


def op_ids(view, phase: str) -> Set[int]:
    """The ids of the window's ops of ``phase`` (``view.ops``: those the
    existing readers keep)."""
    return {o["args"]["op_id"] for o in view.ops_of(phase)}


def mean(xs: List[float]):
    return sum(xs) / len(xs) if xs else None


def covered_ns(busy: List[Tuple[int, int]], a: float, b: float) -> float:
    """How much of [a, b] the sorted, disjoint ``busy`` intervals cover."""
    i = max(0, bisect.bisect_right(busy, (a, a)) - 1)
    out = 0.0
    while i < len(busy) and busy[i][0] < b:
        lo, hi = max(busy[i][0], a), min(busy[i][1], b)
        if hi > lo:
            out += hi - lo
        i += 1
    return out


def decode_issue_idle_ms(view) -> List[float]:
    """The card's idle time (no kernel, copy or set) inside each decode
    step's ``step.issue`` span that lies wholly inside the device trace's
    sub-window, the span mapped onto the device trace's clock by the
    program's ``Timeline.to_profiler_ns``; ms, in the order written."""
    tl = timeline()
    if tl is None or not view.kernels:
        return []
    busy = trace.busy_intervals(view.kernels)
    p0, p1 = view.span
    out = []
    for s in named("step.issue"):
        if s["args"].get("kind") != "decode":
            continue
        a = tl.to_profiler_ns(s["ts"] * 1e3)
        b = tl.to_profiler_ns((s["ts"] + s["dur"]) * 1e3)
        if p0 <= a and b <= p1:
            out.append((b - a - covered_ns(busy, a, b)) / 1e6)
    return out

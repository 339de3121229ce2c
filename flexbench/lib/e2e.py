"""The end-to-end metrics of a run, from the host clock: every
request is timed from when it was due."""
from __future__ import annotations

import math
from typing import Dict, List


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank (inf where it falls on a
    missing value)."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)] if v else float("nan")


def due_in_window(run) -> List:
    w0, w1 = run.window
    return [r for r in run.requests if w0 <= r.due < w1]


def missing(req) -> bool:
    """Failed, rejected, or not finished when the drain ended."""
    return req.state.value != "done"


def end_to_end(run) -> Dict[str, float]:
    """ttft_p95_ms: first token minus due time over every request due in
    the window, a missing one above every finite value.  tpot_p95_ms: over
    requests with two tokens or more inside the window, each one's mean
    gap between its tokens there.  output_tokens_per_s: every token handed
    out inside the window, over the window."""
    w0, w1 = run.window
    due = due_in_window(run)
    ttft = [float("inf") if missing(r) or not r.times
            else (r.times[0] - r.due) * 1e3 for r in due]
    tpot, tokens = [], 0
    for r in run.requests:
        ts = [t for t in r.times if w0 <= t < w1]
        tokens += len(ts)
        if len(ts) >= 2:
            tpot.append((ts[-1] - ts[0]) / (len(ts) - 1) * 1e3)
    return {"ttft_p95_ms": p95(ttft), "tpot_p95_ms": p95(tpot),
            "output_tokens_per_s": tokens / (w1 - w0)}


def lateness_ms(run) -> Dict[str, float]:
    """How late requests were sent (send minus due), ms."""
    late = [(r.sent - r.due) * 1e3 for r in run.requests]
    return {"p50": sorted(late)[len(late) // 2] if late else 0.0,
            "max": max(late) if late else 0.0}

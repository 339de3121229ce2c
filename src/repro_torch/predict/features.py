"""Training-sample extraction for the latency predictor (v9).

Three sources, one sample shape (:class:`OpSample`):

  * ``samples_from_events`` — the per-op Chrome-trace events the
    ``FLEX_PROFILE=1`` timelines record (``repro_torch.core.profiler.Timeline``):
    event names are ``"<phase>:<op>"``, durations are microseconds, and
    ``args`` carries the ``tokens`` / ``ctx`` features the launch meta
    stamped on every compute op.
  * ``load_samples`` — file ingestion for both artifact shapes CI already
    uploads: raw Chrome traces (a ``{"traceEvents": [...]}`` dict or a
    bare event list, e.g. ``flextrace-<pid>-<n>.json``) and
    ``BENCH_*.json`` payloads whose rows embed a ``trace_events`` list in
    their ``derived`` dict.
  * ``cost_model_samples`` — the roofline bootstrap: when no trace exists
    yet (a fresh deployment), sample the analytic cost model over a
    (tokens, ctx) / (batch, ctx) grid.  The cost model is duck-typed
    (``prefill_time`` / ``decode_time``) so this module carries no
    serving-side import and stays at its low layering rank.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List

import numpy as np

#: the op phases the latency predictor models
PHASES = ("prefill", "decode")


@dataclasses.dataclass(frozen=True)
class OpSample:
    """One training observation: an op's features and realized duration.

    ``tokens`` is the op's batch size in tokens (prefill-chunk tokens, or
    the decode batch — one token per active sequence); ``ctx`` is the
    context length the op attends over (cumulative prompt offset for a
    prefill chunk, average batch context for decode)."""
    phase: str
    tokens: float
    ctx: float
    duration_s: float


def samples_from_events(events: Iterable[dict]) -> List[OpSample]:
    """Extract :class:`OpSample` rows from Chrome-trace event dicts."""
    out: List[OpSample] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        phase = str(ev.get("name", "")).split(":", 1)[0]
        if phase not in PHASES:
            continue
        dur = float(ev.get("dur", 0.0)) * 1e-6
        args = ev.get("args", {})
        tokens = float(args.get("tokens", 0) or 0)
        if dur <= 0.0 or tokens <= 0.0:
            continue  # bookkeeping ops (event markers) carry no features
        ctx = args.get("ctx", tokens) or tokens
        if isinstance(ctx, list):   # each row's, stamped only while
            ctx = tokens            # traced: read as if untraced
        ctx = float(ctx)
        out.append(OpSample(phase, tokens, ctx, dur))
    return out


def load_samples(path: str) -> List[OpSample]:
    """Load training samples from a trace/artifact file (see module doc)."""
    with open(path) as f:
        payload = json.load(f)
    events: List[dict] = []
    if isinstance(payload, list):
        events = payload
    elif isinstance(payload, dict):
        if "traceEvents" in payload:
            events = payload["traceEvents"]
        elif "rows" in payload:  # BENCH_*.json artifact
            for row in payload["rows"]:
                derived = row.get("derived") or {}
                if isinstance(derived, dict):
                    events.extend(derived.get("trace_events", []))
    return samples_from_events(events)


# default bootstrap grids: prefill chunks from one cache page to a long
# prompt, decode batches from a lone sequence to a full continuous batch
_PREFILL_TOKENS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)
_CTX_FACTORS = (1.0, 2.0, 4.0)
_DECODE_BATCH = (1, 2, 4, 8, 16, 32, 64, 128)
_DECODE_CTX = (128, 256, 512, 1024, 2048, 4096, 8192)


def cost_model_samples(cost, spec, phases: Iterable[str] = PHASES
                       ) -> List[OpSample]:
    """Roofline bootstrap: sample the analytic cost model over a grid.

    Used when a deployment has no FLEX_PROFILE trace yet — the fitted
    linear model approximates the (piecewise, nonlinear) roofline cost
    model, and the calibration report records exactly how well."""
    out: List[OpSample] = []
    if "prefill" in phases:
        for t in _PREFILL_TOKENS:
            for f in _CTX_FACTORS:
                ctx = float(t) * f
                out.append(OpSample(
                    "prefill", float(t), ctx,
                    float(cost.prefill_time(spec, t, context=int(ctx)))))
    if "decode" in phases:
        for b in _DECODE_BATCH:
            for ctx in _DECODE_CTX:
                out.append(OpSample(
                    "decode", float(b), float(ctx),
                    float(cost.decode_time(spec, b, ctx))))
    return out


def featurize(tokens: float, ctx: float) -> np.ndarray:
    """[1, tokens, ctx, tokens*ctx], scaled to O(1) for a well-conditioned
    normal-equation solve.  The interaction term is what lets one linear
    model track the roofline's attention cost (FLOPs ∝ tokens * ctx)."""
    t = tokens * 1e-3
    c = ctx * 1e-3
    return np.array([1.0, t, c, t * c], dtype=np.float64)

"""Per-op latency predictor (v9): per-phase ridge / quantile fit.

One :class:`LatencyModel` holds an independent linear model per op phase
over the features ``[1, tokens, ctx, tokens*ctx]`` (see
:func:`repro_torch.predict.features.featurize`).  The fit is a closed-form
ridge solve in NumPy — no new dependencies — and ``tau > 0`` turns it
into a pessimistic quantile predictor by shifting the intercept to the
``tau``-quantile of the training residuals (predicted-SJF wants a
central estimate; admission's "is the SLO miss real?" question wants a
high quantile).

Honesty contract:

  * every ``fit`` attaches a **calibration report** — per-phase and
    overall MAPE, p90 relative error, and sample counts — under
    ``.calibration``;
  * every online ``observe`` (the serving loop reporting a realized op
    duration) updates running MAPE / p90 / over- and under-prediction
    counters, surfaced by ``report()`` into the ``prediction`` section
    of ``Cluster.run()`` results.

``to_dict`` / ``from_dict`` round-trip the fitted state (weights,
shifts, calibration) so a model fitted offline from CI traces can ship
as a JSON blob.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from repro_torch.predict.features import (OpSample, featurize, load_samples,
                                    samples_from_events)

# online p90 tracking keeps a bounded, deterministically-thinned window
# of relative errors (index n % cap) — O(1) memory over any run length
_ERR_WINDOW = 8192


class _ErrorStats:
    """Running prediction-error accumulators (MAPE, p90, over/under)."""

    def __init__(self):
        self.n = 0
        self.abs_rel_sum = 0.0
        self.over = 0       # predicted > actual
        self.under = 0      # predicted < actual
        self._window: List[float] = []

    def add(self, predicted: float, actual: float) -> None:
        if actual <= 0.0:
            return
        rel = (predicted - actual) / actual
        self.n += 1
        self.abs_rel_sum += abs(rel)
        if rel > 0:
            self.over += 1
        elif rel < 0:
            self.under += 1
        if len(self._window) < _ERR_WINDOW:
            self._window.append(abs(rel))
        else:
            self._window[self.n % _ERR_WINDOW] = abs(rel)

    def report(self) -> Dict[str, float]:
        if self.n == 0:
            return {"n": 0, "mape": 0.0, "p90_err": 0.0,
                    "over": 0, "under": 0}
        return {
            "n": self.n,
            "mape": round(self.abs_rel_sum / self.n, 6),
            "p90_err": round(float(np.percentile(self._window, 90)), 6),
            "over": self.over,
            "under": self.under,
        }


def _calibrate(pred: np.ndarray, y: np.ndarray) -> Dict[str, float]:
    rel = np.abs(pred - y) / np.maximum(y, 1e-12)
    return {"n": int(y.shape[0]),
            "mape": round(float(rel.mean()), 6),
            "p90_err": round(float(np.percentile(rel, 90)), 6)}


class LatencyModel:
    """Fitted per-phase latency predictor (see module docstring).

    Knobs: ``l2`` — ridge strength; ``tau`` — 0 for the conditional-mean
    ridge fit, else the residual quantile the intercept shifts to
    (``tau=0.9`` over-predicts 90% of training ops); ``trace`` — a
    trace/artifact path to fit from at construction, so
    ``make_predictor("quantile_latency", trace=...)`` is the whole
    trace→fit→deploy step."""

    def __init__(self, l2: float = 1e-6, tau: float = 0.0, trace: str = ""):
        if not 0.0 <= float(tau) < 1.0:
            raise ValueError(f"tau must be in [0, 1), got {tau}")
        self.l2 = float(l2)
        self.tau = float(tau)
        self._w: Dict[str, np.ndarray] = {}      # phase -> (4,) weights
        # scalar copies of the weights: predict() sits on the scheduling
        # hot path (per routed request, per observed op), where building a
        # feature ndarray per call is most of the cost
        self._wf: Dict[str, tuple] = {}
        self._shift: Dict[str, float] = {}       # phase -> quantile shift
        self.calibration: Dict[str, Dict] = {}
        self._online = _ErrorStats()
        if trace:
            self.fit(load_samples(trace))

    # ------------------------------------------------------------- fitting
    @property
    def fitted(self) -> bool:
        return bool(self._w)

    def fit(self, samples: Iterable[OpSample]) -> Dict[str, Dict]:
        """Closed-form per-phase ridge fit; returns (and attaches) the
        calibration report.  Deterministic: same samples, same model."""
        by_phase: Dict[str, List[OpSample]] = {}
        for s in samples:
            by_phase.setdefault(s.phase, []).append(s)
        if not by_phase:
            raise ValueError("no training samples (empty trace?)")
        self._w, self._wf, self._shift, self.calibration = {}, {}, {}, {}
        all_pred, all_y = [], []
        for phase, rows in sorted(by_phase.items()):
            X = np.stack([featurize(s.tokens, s.ctx) for s in rows])
            y = np.array([s.duration_s for s in rows], dtype=np.float64)
            ridge = self.l2 * np.eye(X.shape[1])
            w = np.linalg.solve(X.T @ X + ridge, X.T @ y)
            shift = 0.0
            if self.tau > 0.0:
                shift = float(np.quantile(y - X @ w, self.tau))
            self._w[phase] = w
            self._wf[phase] = tuple(float(x) for x in w)
            self._shift[phase] = shift
            pred = np.maximum(X @ w + shift, 0.0)
            self.calibration[phase] = _calibrate(pred, y)
            all_pred.append(pred)
            all_y.append(y)
        self.calibration["overall"] = _calibrate(
            np.concatenate(all_pred), np.concatenate(all_y))
        return self.calibration

    def fit_events(self, events: Iterable[dict]) -> Dict[str, Dict]:
        """Fit straight from Chrome-trace event dicts (Timeline.events())."""
        return self.fit(samples_from_events(events))

    # ---------------------------------------------------------- prediction
    def predict(self, phase: str, tokens: float,
                ctx: float) -> Optional[float]:
        """Predicted op duration in seconds; None when ``phase`` was not
        in the training set (callers fall back to their analytic
        estimate)."""
        w = self._wf.get(phase)
        if w is None:
            return None
        t = tokens * 1e-3
        c = ctx * 1e-3
        v = w[0] + w[1] * t + w[2] * c + w[3] * (t * c) + self._shift[phase]
        return v if v > 0.0 else 0.0

    def invert_tokens(self, phase: str, target_s: float,
                      ctx: float) -> Optional[float]:
        """Largest token count whose predicted duration fits ``target_s``
        at context ``ctx`` — the chunk adapter's inverse query.  The model
        is linear in tokens at fixed ctx, so this is a one-line solve;
        None when unfitted or the per-token slope is degenerate."""
        w = self._wf.get(phase)
        if w is None:
            return None
        c = ctx * 1e-3
        slope = (w[1] + w[3] * c) * 1e-3      # d(pred)/d(tokens)
        if slope <= 0.0:
            return None
        base = w[0] + w[2] * c + self._shift[phase]
        return max((target_s - base) / slope, 0.0)

    # ------------------------------------------------------ online honesty
    def observe(self, phase: str, tokens: float, ctx: float,
                actual_s: float) -> None:
        """Record a realized op duration against the model's prediction
        (misprediction telemetry — does not refit)."""
        pred = self.predict(phase, tokens, ctx)
        if pred is not None:
            self._online.add(pred, actual_s)

    def report(self) -> Dict:
        """Online error stats plus the fit-time calibration report."""
        return {**self._online.report(), "fit": dict(self.calibration)}

    # -------------------------------------------------------- serialization
    def to_dict(self) -> Dict:
        return {
            "kind": "latency",
            "l2": self.l2,
            "tau": self.tau,
            "weights": {p: [float(x) for x in w]
                        for p, w in self._w.items()},
            "shifts": dict(self._shift),
            "calibration": self.calibration,
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "LatencyModel":
        m = cls(l2=d.get("l2", 1e-6), tau=d.get("tau", 0.0))
        m._w = {p: np.asarray(w, dtype=np.float64)
                for p, w in d.get("weights", {}).items()}
        m._wf = {p: tuple(float(x) for x in w) for p, w in m._w.items()}
        m._shift = {p: float(s) for p, s in d.get("shifts", {}).items()}
        m.calibration = dict(d.get("calibration", {}))
        return m

"""Online output-length predictor (v9): running quantile sketches.

How many tokens will this request generate?  The scheduler cannot know,
but traffic is far from uniform: output length clusters tightly by
prompt class (chat replies are short, agent traces are long) and by
tenant.  :class:`LengthPredictor` keeps one :class:`QuantileSketch` per
``(prompt_class, tenant)`` key plus a global fallback, updated online
from every completed request — no offline fit, the model sharpens as the
deployment serves.

The sketch is a log-spaced counting histogram: quantile queries walk the
cumulative counts and return an upper bin edge, so quantiles are
**monotone in q by construction** (the property the streaming tests pin
down) and updates are O(log bins).

Like the latency model, every observation first scores the CURRENT
prediction (MAPE / p90 / over-under counters for the ``prediction``
telemetry section) and only then updates the sketch — the model is never
graded on a request it has already seen.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.predict.latency import _ErrorStats


class QuantileSketch:
    """Log-binned streaming histogram over positive values."""

    def __init__(self, lo: float = 1.0, hi: float = 65536.0, bins: int = 64):
        if not (0 < lo < hi) or bins < 2:
            raise ValueError(f"bad sketch shape lo={lo} hi={hi} bins={bins}")
        self.edges = np.geomspace(float(lo), float(hi), int(bins) + 1)
        self.counts = np.zeros(int(bins), dtype=np.int64)
        self.n = 0

    def update(self, x: float) -> None:
        x = max(float(x), self.edges[0])
        i = int(np.searchsorted(self.edges, x, side="right")) - 1
        self.counts[min(max(i, 0), self.counts.shape[0] - 1)] += 1
        self.n += 1

    def quantile(self, q: float) -> float:
        """Upper edge of the bin holding the q-quantile (conservative:
        never under-reports by more than one log-bin width).  Monotone in
        q: the cumulative counts are nondecreasing, so a larger q can
        only land in the same or a later bin."""
        if self.n == 0:
            return 0.0
        q = min(max(float(q), 0.0), 1.0)
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, q * self.n, side="left"))
        return float(self.edges[min(i, self.counts.shape[0] - 1) + 1])


class LengthPredictor:
    """Per-(prompt class, tenant) output-length prediction.

    Knobs: ``q`` — the quantile reported by ``predict`` (0.5 = median, a
    central estimate for SJF-style ordering; raise it for admission-style
    pessimism); ``bins`` / ``max_len`` — sketch resolution and range;
    ``min_count`` — observations a key needs before its own sketch is
    trusted over the global one; ``default_len`` — the cold-start guess
    before ANY observation."""

    def __init__(self, q: float = 0.5, bins: int = 64,
                 max_len: int = 65536, min_count: int = 8,
                 default_len: int = 256):
        if not 0.0 < float(q) <= 1.0:
            raise ValueError(f"q must be in (0, 1], got {q}")
        self.q = float(q)
        self.bins = int(bins)
        self.max_len = int(max_len)
        self.min_count = max(1, int(min_count))
        self.default_len = int(default_len)
        self._sketches: Dict[str, QuantileSketch] = {}
        self._global = self._new_sketch()
        self._online = _ErrorStats()

    def _new_sketch(self) -> QuantileSketch:
        return QuantileSketch(lo=1.0, hi=float(self.max_len),
                              bins=self.bins)

    @staticmethod
    def key(prompt_class: str, tenant: str) -> str:
        return f"{prompt_class or '?'}|{tenant or '?'}"

    # ---------------------------------------------------------- prediction
    def predict(self, prompt_class: str = "", tenant: str = "",
                q: Optional[float] = None) -> float:
        """Predicted output length in tokens (never zero)."""
        qq = self.q if q is None else float(q)
        sk = self._sketches.get(self.key(prompt_class, tenant))
        if sk is not None and sk.n >= self.min_count:
            return max(sk.quantile(qq), 1.0)
        if self._global.n > 0:
            return max(self._global.quantile(qq), 1.0)
        return float(self.default_len)

    def predict_for(self, req) -> float:
        """Prediction for a Request-like object (``prompt_class`` /
        ``tenant`` attributes; both optional)."""
        return self.predict(getattr(req, "prompt_class", ""),
                            getattr(req, "tenant", ""))

    # ------------------------------------------------------ online updates
    def observe(self, prompt_class: str, tenant: str,
                generated: int) -> None:
        """A request completed having generated ``generated`` tokens:
        score the pre-update prediction, then fold the observation in."""
        if generated <= 0:
            return
        self._online.add(self.predict(prompt_class, tenant),
                         float(generated))
        k = self.key(prompt_class, tenant)
        sk = self._sketches.get(k)
        if sk is None:
            sk = self._sketches[k] = self._new_sketch()
        sk.update(float(generated))
        self._global.update(float(generated))

    def report(self) -> Dict:
        return {**self._online.report(),
                "keys": len(self._sketches),
                "q": self.q}

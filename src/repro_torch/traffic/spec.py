"""TrafficSpec: declarative request-stream description (v5).

A spec composes the three axes independently:

  * **arrival** — a process name + knobs from :mod:`repro_torch.traffic.arrivals`
  * **classes** — prompt classes (I/O length distributions) mixed by Zipf
    popularity over their rank order: class ``r`` (1-based) gets weight
    ``r ** -zipf_alpha``, so the head class dominates and the tail is long
    (``zipf_alpha=0`` is a uniform mix)
  * **tenants** — tiers sampled by share; each request carries its tier's
    name and SLO so the control plane and ``summarize`` see them

``generate(seed)`` materializes an open-loop trace (same seed, same spec →
identical request list); ``sample_one(rng)`` draws a single request for
closed-loop pools, which set arrival times themselves.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.request import Request
from repro_torch.traffic.arrivals import make_arrivals
from repro_torch.traffic.lengths import make_lengths
from repro_torch.traffic.tenants import TenantClass


def zipf_probs(k: int, alpha: float) -> np.ndarray:
    """Zipf popularity over ranks 1..k: p(r) ∝ r ** -alpha."""
    if k <= 0:
        raise ValueError("need at least one prompt class")
    w = np.arange(1, k + 1, dtype=float) ** (-alpha)
    return w / w.sum()


@dataclasses.dataclass(frozen=True)
class PromptClass:
    """One request shape: mean input/output lengths plus the sampler each
    is drawn from (knobs pass through to :func:`make_lengths`).  A class
    pinned to a ``tenant`` always bills to that tier; otherwise the spec's
    tenant shares decide."""
    name: str
    input_len: int
    output_len: int
    tenant: str = ""
    input_dist: str = "lognormal"
    output_dist: str = "lognormal"
    input_knobs: Dict = dataclasses.field(default_factory=dict)
    output_knobs: Dict = dataclasses.field(default_factory=dict)


#: default catalog, popularity rank order — short chat dominates, the tail
#: holds the long-context shapes that starve tenant-blind FIFO queues
DEFAULT_CLASSES: Tuple[PromptClass, ...] = (
    PromptClass("chat", 256, 128),
    PromptClass("assist", 512, 256),
    PromptClass("rag", 2048, 256),
    PromptClass("code", 1024, 512),
    PromptClass("summarize", 4096, 128),
    PromptClass("agent", 512, 1024),
)


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    n: int = 100
    rate: float = 10.0
    arrival: str = "poisson"
    arrival_knobs: Dict = dataclasses.field(default_factory=dict)
    classes: Tuple[PromptClass, ...] = DEFAULT_CLASSES
    zipf_alpha: float = 1.1
    tenants: Tuple[TenantClass, ...] = ()
    start_time: float = 0.0

    def _tenant_probs(self) -> Optional[np.ndarray]:
        if not self.tenants:
            return None
        shares = np.asarray([t.share for t in self.tenants], dtype=float)
        if (shares < 0).any() or shares.sum() <= 0:
            raise ValueError("tenant shares must be >= 0 and sum > 0")
        return shares / shares.sum()

    def _pick_tenant(self, cls: PromptClass,
                     idx: int) -> Optional[TenantClass]:
        if cls.tenant:
            for t in self.tenants:
                if t.name == cls.tenant:
                    return t
            raise ValueError(f"prompt class {cls.name!r} pinned to unknown "
                             f"tenant {cls.tenant!r}")
        return self.tenants[idx] if self.tenants else None

    def generate(self, seed: int = 0) -> List[Request]:
        """Materialize the open-loop trace: deterministic in (spec, seed)."""
        rng = np.random.default_rng(seed)
        arrivals = make_arrivals(self.arrival, rng, self.n, self.rate,
                                 **self.arrival_knobs) + self.start_time
        cls_idx = rng.choice(len(self.classes), size=self.n,
                             p=zipf_probs(len(self.classes), self.zipf_alpha))
        tp = self._tenant_probs()
        ten_idx = (rng.choice(len(self.tenants), size=self.n, p=tp)
                   if tp is not None else np.zeros(self.n, dtype=int))
        # sample lengths class-by-class so each class's distribution knobs
        # apply; order is deterministic (class rank, then arrival order)
        ins = np.zeros(self.n, dtype=int)
        outs = np.zeros(self.n, dtype=int)
        for ci, c in enumerate(self.classes):
            mask = cls_idx == ci
            k = int(mask.sum())
            if not k:
                continue
            ins[mask] = make_lengths(c.input_dist, rng, k, c.input_len,
                                     **c.input_knobs)
            outs[mask] = make_lengths(c.output_dist, rng, k, c.output_len,
                                      **c.output_knobs)
        reqs: List[Request] = []
        for i in range(self.n):
            ten = self._pick_tenant(self.classes[cls_idx[i]], int(ten_idx[i]))
            reqs.append(Request(
                prompt_len=int(ins[i]), max_new_tokens=int(outs[i]),
                arrival_time=float(arrivals[i]),
                tenant=ten.name if ten else "",
                slo=ten.slo if ten else None,
                prompt_class=self.classes[cls_idx[i]].name))
        return reqs

    def sample_one(self, rng) -> Request:
        """Draw one request (no arrival time) — closed-loop pools stamp
        arrival themselves when the client's think time elapses."""
        ci = int(rng.choice(len(self.classes),
                            p=zipf_probs(len(self.classes), self.zipf_alpha)))
        c = self.classes[ci]
        tp = self._tenant_probs()
        ti = int(rng.choice(len(self.tenants), p=tp)) if tp is not None else 0
        ten = self._pick_tenant(c, ti)
        return Request(
            prompt_len=int(make_lengths(c.input_dist, rng, 1, c.input_len,
                                        **c.input_knobs)[0]),
            max_new_tokens=int(make_lengths(c.output_dist, rng, 1,
                                            c.output_len,
                                            **c.output_knobs)[0]),
            tenant=ten.name if ten else "",
            slo=ten.slo if ten else None,
            prompt_class=c.name)

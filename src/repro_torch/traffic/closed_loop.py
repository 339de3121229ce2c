"""Closed-loop client pools (the traffic subsystem, v5).

An open-loop trace fires requests on a clock no matter how the system is
doing; real users are **closed-loop**: each of N clients waits for its
response, thinks, then asks again — so offered load self-throttles under
congestion (the effect open-loop benchmarks famously overstate).

A :class:`ClosedLoopPool` plugs into ``Cluster.run(traffic=...)`` (both
drive modes); the real engine exposes the same retirement callback as
``RealEngine.on_request_done`` for callers that pump their own submit
loop.  Three duck-typed hooks the driver loops call:

  * ``initial()``                  — the first request of every client
  * ``on_complete(req, now)``      — called at EVERY terminal transition
    (done, rejected, failed); returns the client's next request (arrival
    stamped ``now + think``) or None when that client's budget is spent
  * ``exhausted()``                — True once every client is drained

``generated`` accumulates every request ever issued, so conservation
(each exactly one of completed/rejected/failed/in-flight) is checkable
at any instant.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.request import Request
from repro_torch.traffic.spec import TrafficSpec


class ClosedLoopPool:
    def __init__(self, spec: TrafficSpec, users: int = 16,
                 think_time_s: float = 1.0, requests_per_user: int = 8,
                 seed: int = 0, start_spread_s: Optional[float] = None):
        if users <= 0 or requests_per_user <= 0:
            raise ValueError("closed loop needs users >= 1 and "
                             "requests_per_user >= 1")
        self.spec = spec
        self.users = users
        self.think_time_s = float(think_time_s)
        self._spread = (self.think_time_s if start_spread_s is None
                        else float(start_spread_s))
        self._rng = np.random.default_rng(seed)
        self._budget = [requests_per_user] * users
        self._owner: Dict[int, int] = {}
        self._pending: set = set()
        self._in_flight = 0
        self._started = False
        self.peak_in_flight = 0
        self.generated: List[Request] = []

    def _issue(self, user: int, at: float) -> Request:
        req = self.spec.sample_one(self._rng)
        req.arrival_time = float(at)
        self._owner[req.req_id] = user
        self._pending.add(req.req_id)
        self._budget[user] -= 1
        self._in_flight += 1
        self.peak_in_flight = max(self.peak_in_flight, self._in_flight)
        self.generated.append(req)
        return req

    def initial(self) -> List[Request]:
        """First request per client, start times spread uniformly over
        ``start_spread_s`` so the pool doesn't arrive as one spike."""
        self._started = True
        return [self._issue(u, self._rng.uniform(0.0, self._spread)
                            if self._spread > 0 else 0.0)
                for u in range(self.users)]

    def on_complete(self, req: Request, now: float) -> Optional[Request]:
        """The driver loop reports a terminal request; hand back the owning
        client's next one after exponential think time, if any budget is
        left.  Unknown requests (open-loop traffic sharing the run) are
        ignored."""
        if req.req_id not in self._pending:
            return None
        self._pending.discard(req.req_id)
        user = self._owner[req.req_id]
        self._in_flight -= 1
        if self._budget[user] <= 0:
            return None
        think = (float(self._rng.exponential(self.think_time_s))
                 if self.think_time_s > 0 else 0.0)
        return self._issue(user, now + think)

    def exhausted(self) -> bool:
        """True once the pool will never issue again — the driver loop's
        termination check must include this (a think-time gap has zero
        in-flight requests but more work coming)."""
        return (self._started and self._in_flight == 0
                and all(b <= 0 for b in self._budget))

    def user_of(self, req: Request) -> Optional[int]:
        """Which client issued ``req`` (None if not from this pool).  The
        mapping persists past completion so per-user traces stay
        reconstructible."""
        return self._owner.get(req.req_id)

    @property
    def in_flight(self) -> int:
        return self._in_flight

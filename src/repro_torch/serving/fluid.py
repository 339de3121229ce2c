"""Coarse fluid-approximation serving engine (opt-in).

``SimConfig(fidelity="fluid")`` trades per-op event fidelity for raw
speed: instead of simulating every daemon op, queue drain rates are
**integrated between decision points**.  Each instance is modeled as

  * a FIFO **prefill server** (one launch per request, no chunking), and
  * a **fluid decode pool**: every active sequence emits tokens at rate
    ``1 / decode_step_time(batch, avg_context)``; between decision
    points (a join, a departure, or the ``until`` horizon) those rates
    are constant, so remaining-token balances advance by closed-form
    integration rather than one event per step.

Departure cascades are rated in ONE vectorized
:meth:`~repro_torch.serving.costmodel.CostModel.decode_times` call (batch
sizes ``n, n-1, …, 1`` as the pool drains); only the first segment is
committed — any join before it invalidates the projection and forces a
re-rate at the new decision point.

What is and is not approximated
-------------------------------
Kept: arrival process, FIFO prefill queueing, ``max_num_seqs`` decode
admission, disaggregated KV-transfer delay (contention-free
:meth:`CostModel.transfer_time`), closed-loop traffic sources.
Dropped: dispatch-policy behavior, chunked prefill, KV-streaming
contention (LinkModel), migration/role-switching, admission policies,
and per-token jitter — token timestamps inside one request are spread
uniformly over its drain interval.  Results therefore carry
``fidelity="fluid"`` and ``approximate=True``; use them for capacity
planning and throughput trends, never for latency-tail or
policy-behavior claims (the discrete engine is the reference).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.request import Request, RequestState, summarize

_EPS = 1e-9


class _FluidInstance:
    """Fluid twin of one SimInstance: prefill FIFO + decode drain pool."""

    def __init__(self, inst, cost, max_num_seqs: int, loop):
        self.name = inst.name
        self.spec = inst.spec
        self.cost = cost
        self.loop = loop
        self.max_num_seqs = max_num_seqs
        self.pf_free_t = 0.0                 # prefill server frees at
        # decode pool: per-sequence [request, remaining_tokens, context],
        # remaining/context are floats advanced by integration
        self.active: List[list] = []
        self.wait: List[Request] = []        # decode admission FIFO
        self.joined: Dict[int, float] = {}   # req_id -> decode join time
        self.last_t = 0.0                    # last integration point
        self.step_time = 0.0                 # current per-step seconds
        self.gen = 0                         # invalidates stale departures

    # ---------------------------------------------------------- decode
    def integrate(self, now: float) -> None:
        """Advance every active sequence's token balance to ``now`` at the
        drain rate fixed at the last decision point."""
        dt = now - self.last_t
        self.last_t = now
        if dt <= 0 or not self.active or self.step_time <= 0:
            return
        tokens = dt / self.step_time
        for ent in self.active:
            ent[1] -= tokens
            ent[2] += tokens                 # context grows with output

    def join(self, req: Request, now: float, on_finish) -> None:
        req.state = RequestState.DECODING
        if len(self.active) >= self.max_num_seqs:
            req.state = RequestState.DECODE_QUEUED
            self.wait.append(req)
            return
        self.integrate(now)
        self.joined[req.req_id] = now
        self.active.append([req, float(req.max_new_tokens),
                            float(req.prompt_len + 1)])
        self.reschedule(now, on_finish)

    def reschedule(self, now: float, on_finish) -> None:
        """New decision point: re-rate the pool and arm the next departure.

        The whole departure cascade (batch ``n, n-1, …, 1``) is rated in
        one vectorized ``decode_times`` call; only the first segment is
        armed as an event — a join before it fires bumps ``gen`` and the
        stale callback drops itself."""
        self.gen += 1
        if not self.active:
            self.step_time = 0.0
            return
        rem = np.array(sorted(ent[1] for ent in self.active))
        n = len(rem)
        batches = np.arange(n, 0, -1, dtype=np.float64)
        avg_ctx = sum(ent[2] for ent in self.active) / n
        # context drifts upward as the pool drains; the first (committed)
        # segment uses the current average, later segments are projection
        steps = self.cost.decode_times(self.spec, batches,
                                       np.full(n, avg_ctx))
        self.step_time = float(steps[0])
        dt = max(rem[0], 0.0) * self.step_time
        my_gen = self.gen
        self.loop.at(now + dt,
                     lambda: self._depart(my_gen, on_finish))

    def _depart(self, gen: int, on_finish) -> None:
        if gen != self.gen:
            return                           # invalidated by a later join
        now = self.loop.clock.t
        self.integrate(now)
        finished = [ent for ent in self.active if ent[1] <= _EPS]
        if not finished:                     # float drift: force the min
            finished = [min(self.active, key=lambda e: e[1])]
        self.active = [ent for ent in self.active if ent not in finished]
        for ent in finished:
            req = ent[0]
            join_t = self.joined.pop(req.req_id, now)
            _retire(req, join_t, now)
            on_finish(req, now)
        while self.wait and len(self.active) < self.max_num_seqs:
            nxt = self.wait.pop(0)
            nxt.state = RequestState.DECODING
            self.joined[nxt.req_id] = now
            self.active.append([nxt, float(nxt.max_new_tokens),
                                float(nxt.prompt_len + 1)])
        self.reschedule(now, on_finish)


def _retire(req: Request, join_t: float, finish_t: float) -> None:
    """Ledger release (fluid engine): spread the request's tokens
    uniformly over its decode interval — the fluid-limit timestamps
    (per-token jitter is what this engine deliberately drops) — and
    stamp the terminal state.  A single-token output passes
    ``join_t == finish_t`` (the prefill launch was the whole request)."""
    n = max(1, req.max_new_tokens)
    spacing = (finish_t - join_t) / n
    req.generated = n
    req.first_token_time = join_t + spacing
    if n >= 2:
        req.second_token_time = join_t + 2 * spacing
    req.last_token_time = finish_t
    req.finish_time = finish_t
    req.state = RequestState.DONE


def fluid_run(cluster, workload: Optional[List[Request]] = None,
              until: float = math.inf, traffic=None) -> Dict:
    """Run ``cluster``'s workload under the fluid approximation.

    Reuses the cluster's (stepped) :class:`EventLoop` for arrivals,
    prefill completions, transfer landings, and decode departures, but
    never touches the daemons — ``check_kv_conservation`` holds
    trivially because no KV is ever charged.  The result dict carries
    ``summarize``-compatible top-level keys plus ``fidelity="fluid"``
    and ``approximate=True``."""
    loop = cluster.loop
    cost = cluster.cost
    cap = cluster.sim_cfg.max_num_seqs
    disagg = cluster.prefill_pool is not cluster.decode_pool
    pf = [_FluidInstance(i, cost, cap, loop) for i in cluster.prefill_pool]
    dec = pf if not disagg else \
        [_FluidInstance(i, cost, cap, loop) for i in cluster.decode_pool]
    sources = [] if traffic is None else (
        list(traffic) if isinstance(traffic, (list, tuple)) else [traffic])
    requests: List[Request] = []

    def finish(req: Request, now: float) -> None:
        for src in sources:
            nxt = src.on_complete(req, now)
            if nxt is not None:
                loop.at(max(nxt.arrival_time, now), lambda r=nxt: submit(r))

    def decode_join(req: Request, now: float) -> None:
        inst = min(dec, key=lambda f: len(f.active) + len(f.wait))
        req.instance = inst.name
        inst.join(req, now, finish)

    def prefill_done(req: Request, inst: _FluidInstance) -> None:
        now = loop.clock.t
        if req.max_new_tokens <= 1:
            # single-token output: the prefill launch IS the whole request
            _retire(req, now, now)
            finish(req, now)
            return
        if disagg:
            req.state = RequestState.TRANSFER
            delay = cost.transfer_time(
                req.prompt_len + 1, bw=cluster.sim_cfg.transfer_bw,
                latency_s=cluster.sim_cfg.transfer_latency_s)
            loop.at(now + delay, lambda: decode_join(req, loop.clock.t))
        else:
            decode_join(req, now)

    def submit(req: Request) -> None:
        now = loop.clock.t
        requests.append(req)
        inst = min(pf, key=lambda f: f.pf_free_t)
        req.state = RequestState.PREFILLING
        req.instance = inst.name
        start = max(now, inst.pf_free_t)
        req.prefill_start = start
        done = start + cost.prefill_time(inst.spec, req.prompt_len,
                                         req.prompt_len)
        inst.pf_free_t = done
        loop.at(done, lambda: prefill_done(req, inst))

    for req in (workload or []):
        loop.at(req.arrival_time, lambda r=req: submit(r))
    for src in sources:
        for req in src.initial():
            loop.at(req.arrival_time, lambda r=req: submit(r))
    loop.run(until=until)

    cluster.requests = requests
    out = summarize(requests)
    out["chips"] = cluster.deploy.total_chips
    out["mode"] = cluster.deploy.mode
    out["drive"] = cluster.drive
    out["fidelity"] = "fluid"
    out["approximate"] = True
    return out

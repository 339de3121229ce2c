"""Phase-aware dispatch policies (paper §3.4, 'Phase-Aware Dispatch').

The daemon keeps separate prefill/decode queues; a :class:`DispatchPolicy`
picks which queue dispatches next whenever the device frees up.  The paper's
dynamic policy adjusts the prefill/decode **time-slice ratio** online from
five signals:

  (1) pending ops per phase, (2) recent per-phase execution times,
  (3) memory-bandwidth pressure, (4) decode progress / active sequences,
  (5) queue occupancy & device utilization.

All policies are **work-conserving**: if only one phase has pending work it
always dispatches (the ratio only arbitrates contention).

Policies (registry names in parentheses):
  * ``FIFOPolicy`` (``fifo``)                 — static PD co-location:
    arrival order, no phase awareness (head-of-line blocking).
  * ``StaticTimeSlicePolicy`` (``static_slice``) — fixed decode share (the
    knob swept in the paper's Figures 5/6).
  * ``DynamicPDPolicy`` (``dynamic_pd``)      — FlexNPU: adaptive share +
    TTFT guard.
  * ``PredictedSJFPolicy`` (``predicted_sjf``) — v9 predictive scheduling:
    ready prefills dispatch shortest-predicted-service-first (learned
    latency model when bound, analytic estimate otherwise), bounded by a
    starvation guard.

v9 adds a second hook below phase selection: after ``select`` names the
phase, the daemon asks ``choose(ops, ctx)`` WHICH ready op of that phase
dispatches.  The default returns the queue head — bit-identical to the
pre-v9 daemon — so only ordering-aware policies pay for it.

v3 interface: policies implement ``pick(ctx)`` over a stable
:class:`~repro_torch.sched.context.PolicyContext`; the daemon calls
``select(ctx)``, which normalizes and delegates.  The legacy v2
``select(queues, prof, now)`` convention (and the ``repro_torch.core.scheduler``
shim that carried it) was removed after its one-release deprecation
window — see the migration table in docs/api.md.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.api import ENGINE_COMPUTE, OpDescriptor, Phase
from repro_torch.sched.context import PolicyContext

SCHEDULABLE = (Phase.PREFILL, Phase.DECODE)


class DispatchPolicy:
    """Returns which phase should dispatch next (None = nothing ready)."""

    def select(self, ctx: PolicyContext) -> Optional[Phase]:
        """Entry point called by the daemon.  Override ``pick``, not this."""
        return self.pick(ctx)

    def pick(self, ctx: PolicyContext) -> Optional[Phase]:
        raise NotImplementedError

    def choose(self, ops, ctx: PolicyContext) -> OpDescriptor:
        """WHICH ready op of the selected phase dispatches (v9).

        ``ops`` is the non-empty list of dispatchable stream heads of the
        phase ``select`` returned, in op-id (arrival) order; the return
        value must be an element of it.  Default: the head — the exact
        pre-v9 daemon behavior, so ordering-unaware policies are
        bit-identical."""
        return ops[0]

    def on_dispatch(self, op: OpDescriptor, est_duration: float) -> None:
        pass

    def debug_state(self) -> Dict[str, float]:
        return {}


def _nonempty(queues) -> list:
    order = [Phase.OTHER, Phase.PREFILL, Phase.DECODE]
    return [p for p in order if queues.get(p)]


class FIFOPolicy(DispatchPolicy):
    """Static PD co-location: dispatch strictly by arrival time (the fixed
    execution policy of the paper's static co-location baseline)."""

    def pick(self, ctx):
        pending = _nonempty(ctx.queues)
        if not pending:
            return None
        return min(pending, key=lambda p: ctx.queues[p][0].enqueue_time)


class _TimeSliceBase(DispatchPolicy):
    """Deficit round-robin over estimated durations: the realized device-time
    split tracks ``decode_share`` without any hardware partitioning —
    user-space dispatch control only (paper §3.4)."""

    def __init__(self, decode_share: float = 0.5):
        self.decode_share = decode_share
        self._spent = {Phase.PREFILL: 1e-9, Phase.DECODE: 1e-9}

    def _target(self, phase: Phase) -> float:
        return self.decode_share if phase == Phase.DECODE \
            else 1.0 - self.decode_share

    def _pick_by_deficit(self, candidates) -> Phase:
        total = sum(self._spent.values())

        def deficit(p):
            return self._spent[p] / total - self._target(p)
        return min(candidates, key=deficit)

    def on_dispatch(self, op, est_duration):
        if op.phase in self._spent:
            self._spent[op.phase] += max(est_duration, 1e-9)

    def pick(self, ctx):
        if ctx.queues.get(Phase.OTHER):
            return Phase.OTHER                     # control ops never starve
        candidates = [p for p in SCHEDULABLE if ctx.queues.get(p)]
        if not candidates:
            return None
        if len(candidates) == 1:
            return candidates[0]                   # work-conserving
        return self._pick_by_deficit(candidates)

    def debug_state(self):
        total = sum(self._spent.values())
        return {"decode_share_target": self.decode_share,
                "decode_share_realized": self._spent[Phase.DECODE] / total}


class StaticTimeSlicePolicy(_TimeSliceBase):
    """Fixed prefill/decode split — static PD resource ratio baseline."""


@dataclasses.dataclass
class DynamicPDConfig:
    min_share: float = 0.05
    max_share: float = 0.95
    bw_saturation: float = 0.85    # Figure 2: decode HBM saturation knee
    adjust_step: float = 0.05
    ttft_guard_s: float = 0.5      # oldest-prefill age that forces a prefill
    backlog_ratio_hi: float = 2.0  # decode backlog pressure threshold
    adjust_interval_s: float = 0.05


class DynamicPDPolicy(_TimeSliceBase):
    """FlexNPU's dynamic PD co-location policy.

    Rules (paper §3.4):
      * decode bandwidth saturated + prefill pending  -> shift share to prefill
        ("giving decode more compute slots may not improve throughput").
      * decode backlog large                          -> shift share to decode
        ("prevent decode from becoming the serving bottleneck").
      * TTFT guard: a prefill older than ``ttft_guard_s`` dispatches next —
        this is what removes static co-location's head-of-line blocking.
    """

    def __init__(self, cfg: Optional[DynamicPDConfig] = None,
                 decode_share: float = 0.5):
        super().__init__(decode_share)
        self.cfg = cfg or DynamicPDConfig()
        self._last_adjust = -1e30

    def _adapt(self, ctx: PolicyContext) -> None:
        c = self.cfg
        if ctx.now - self._last_adjust < c.adjust_interval_s:
            return
        self._last_adjust = ctx.now
        n_pre = ctx.backlog(Phase.PREFILL)
        n_dec = ctx.backlog(Phase.DECODE)
        bw = ctx.prof.decode_bandwidth_util()                  # signal (3)
        dec_stats = ctx.prof.stats[Phase.DECODE]
        pre_stats = ctx.prof.stats[Phase.PREFILL]

        # signal (1)+(4): backlog pressure — decode work outstanding relative
        # to prefill work outstanding, weighted by their typical durations.
        dec_load = n_dec * max(dec_stats.ewma_exec, 1e-6)
        pre_load = n_pre * max(pre_stats.ewma_exec, 1e-6)

        if bw >= c.bw_saturation and n_pre > 0:
            # Decode can't convert more time slices into tokens; lend slack
            # compute to prefill (the co-location win).
            self.decode_share -= c.adjust_step
        elif dec_load > c.backlog_ratio_hi * max(pre_load, 1e-6):
            self.decode_share += c.adjust_step
        elif pre_load > c.backlog_ratio_hi * max(dec_load, 1e-6):
            self.decode_share -= c.adjust_step
        self.decode_share = min(c.max_share,
                                max(c.min_share, self.decode_share))

    def pick(self, ctx):
        if ctx.queues.get(Phase.OTHER):
            return Phase.OTHER
        candidates = [p for p in SCHEDULABLE if ctx.queues.get(p)]
        if not candidates:
            return None
        if len(candidates) == 1:
            return candidates[0]
        self._adapt(ctx)
        # TTFT guard (signal 5 / responsiveness): never let a prefill wait
        # behind an unbounded decode run.
        oldest_prefill = ctx.queues[Phase.PREFILL][0]
        if ctx.now - oldest_prefill.enqueue_time > self.cfg.ttft_guard_s:
            return Phase.PREFILL
        # Multi-queue devices (v4): steer toward heterogeneous co-location
        # — hand the free compute queue to the phase NOT already running on
        # another queue (prefill beside decode shares complementary
        # bottlenecks; a second prefill beside a prefill just splits FLOPs).
        if ctx.engine_slots.get(ENGINE_COMPUTE, 1) > 1:
            running = ctx.phases_in_flight(ENGINE_COMPUTE)
            idle = [p for p in candidates if p.value not in running]
            if running and len(idle) == 1:
                return idle[0]
        return self._pick_by_deficit(candidates)

    def debug_state(self):
        d = super().debug_state()
        d["decode_share_target"] = self.decode_share
        return d


class PredictedSJFPolicy(FIFOPolicy):
    """Predicted-shortest-job-first dispatch (v9 predictive scheduling).

    Phase selection stays FIFO (work-conserving, like the baseline this
    policy is measured against); the leverage is WITHIN the prefill
    phase: among the ready prefill stream heads, the op with the
    smallest **predicted** service time dispatches first.  Under a
    heavy-tailed prompt mix this is the classic SJF win — short prompts
    stop queueing behind 4k-token monsters and p95 TTFT drops.

    Predictions come from a bound :class:`repro_torch.predict.LatencyModel`
    (``bind_predictor``, wired by the cluster when the deployment
    configures one); unbound, the policy falls back to the analytic
    ``est_duration`` the launch meta carries — i.e. perfect-model SJF,
    the upper bound a learned model is compared against.

    Starvation bound: once the oldest ready prefill has waited longer
    than ``max_wait_s``, it dispatches regardless of size — SJF's known
    failure mode (long jobs starving under a stream of short ones) is
    capped at one bounded delay.

    Misprediction visibility: when the launch meta carries the analytic
    estimate, every choice the model makes is compared against the
    choice the estimates would have made; disagreements count as
    ``overturned`` decisions in ``debug_state`` (surfaced into the
    ``prediction`` telemetry section)."""

    def __init__(self, max_wait_s: float = 0.5):
        self.max_wait_s = float(max_wait_s)
        self.latency = None
        self.reordered = 0          # picks that were not the FIFO head
        self.starvation_picks = 0   # picks forced by the wait bound
        self.overturned = 0         # model pick != analytic-estimate pick

    def bind_predictor(self, latency=None, length=None) -> None:
        self.latency = latency

    def _predicted(self, op: OpDescriptor) -> float:
        if self.latency is not None:
            tokens = float(op.meta.get("tokens", 1) or 1)
            ctx = op.meta.get("ctx", tokens)
            if isinstance(ctx, list):   # each row's, stamped only while
                ctx = tokens            # traced: read as if untraced
            p = self.latency.predict(op.phase.value, tokens, float(ctx))
            if p is not None:
                return p
        return float(op.meta.get("est_duration", 0.0))

    def choose(self, ops, ctx):
        if len(ops) == 1 or ops[0].phase is not Phase.PREFILL:
            return ops[0]
        oldest = min(ops, key=lambda o: o.enqueue_time)
        if ctx.now - oldest.enqueue_time > self.max_wait_s:
            self.starvation_picks += 1
            return oldest
        best = min(ops, key=self._predicted)
        if best is not ops[0]:
            self.reordered += 1
        if self.latency is not None:
            ests = [float(o.meta.get("est_duration", 0.0)) for o in ops]
            if any(ests) and ops[ests.index(min(ests))] is not best:
                self.overturned += 1
        return best

    def debug_state(self):
        return {"sjf_reordered": float(self.reordered),
                "sjf_starvation_picks": float(self.starvation_picks),
                "sjf_overturned": float(self.overturned)}

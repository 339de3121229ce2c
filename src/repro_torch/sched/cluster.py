"""Cluster policies: routing, migration, and dynamic role-switching (v3).

The third control-plane layer sits above per-device dispatch and
per-instance admission: a :class:`ClusterPolicy` sees cluster-wide phase
pressure and decides *where* requests go and *what role* each instance
plays.  This is where FlexNPU's adaptive win lives — per-queue FIFO order
cannot rebalance a fleet under phase-shifted load (cf. the adaptive
orchestration layers in PAPERS.md: A-IO, the multi-core-NPU serving study).

Policies (registry names in parentheses):
  * ``LeastLoadedPolicy`` (``least_loaded``) — v2 behavior: route to the
    least-loaded healthy instance, avoid stragglers (>2.5x pool-median
    EWMA step time).
  * ``LeastContendedPolicy`` (``least_contended``) — topology-aware decode
    routing: picks the destination whose ``Topology``-resolved path from
    the source is least contended (live flows crossing each segment, plus
    the accumulated per-segment queueing delay from
    ``LinkModel.stats()["per_link"]``), so KV streams spread over spine
    planes instead of piling onto one; prefill routing stays least-loaded.
  * ``RoleSwitchPolicy`` (``role_switch``)   — least-loaded routing plus
    **dynamic role-switching** for disaggregated deployments: a decode
    instance under prefill backlog flips role to prefill — draining its
    in-flight decode KV through the copy-engine path — and flips back when
    TTFT pressure subsides (or decode pressure returns).
  * ``JBSQPolicy`` (``jbsq``) — v9 predictive routing: bounded
    join-the-shortest-PREDICTED-queue.  Prefills join the instance with
    the least predicted queued work (latency model over every queued
    prompt), subject to a per-instance depth bound; decode placement
    minimizes predicted outstanding tokens (length model).

Routing hooks take ``(req, pool, ctx)`` directly; the one-release v5
two-argument adapter (``dispatch_route_prefill``) was removed in v9 and
is on the layering ban-list so it cannot quietly return.

The module is duck-typed against ``repro_torch.serving.simulator`` objects
(instances expose ``failed / ewma_step / load() / active / decode_pending /
role``; the cluster exposes ``switch_role`` and the pools) so the policy
layer carries no serving-side import and stays reusable for a future
multi-replica RealEngine front end.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.api import Phase
from repro_torch.sched.context import RouteContext

# priority at or above which a request counts as interactive-tier for
# tier-aware routing tiebreaks (matches ``default_tiers``: interactive=2)
INTERACTIVE_PRIORITY = 2


def _tier_penalty(ctx: Optional[RouteContext], name: str) -> float:
    """Tier-isolation tiebreak (v9): interactive requests pack onto
    instances already serving interactive work (negative penalty for a
    high count), everything else avoids them — so under contention the
    interactive tier concentrates on a subset of instances instead of
    every instance carrying a little batch churn.  0 when the cluster did
    not populate tier context (policy didn't ask, or tenant-blind
    traffic)."""
    if ctx is None or not ctx.tier_active:
        return 0.0
    n = float(ctx.tier_active.get(name, 0))
    return -n if ctx.priority >= INTERACTIVE_PRIORITY else n


class ClusterPolicy:
    """Routing + migration + role control for a serving cluster."""

    def bind(self, cluster) -> None:
        """Called once by the cluster after construction."""
        self.cluster = cluster

    # ------------------------------------------------------------- routing
    def healthy(self, pool: List) -> List:
        """Healthy members of a pool, excluding stragglers.

        Straggler avoidance: instances whose EWMA step time is >2.5x the
        pool median stop receiving NEW work (they still drain their own
        queues)."""
        ok = [i for i in pool if not i.failed]
        if len(ok) <= 1:
            return ok
        steps = sorted(i.ewma_step for i in ok if i.ewma_step > 0)
        if steps:
            med = steps[len(steps) // 2]
            fast = [i for i in ok
                    if i.ewma_step <= 2.5 * med or i.ewma_step == 0]
            if fast:
                return fast
        return ok

    def route_prefill(self, req, pool: List,
                      ctx: Optional[RouteContext] = None):
        """Pick the instance that prefills ``req`` (None = no capacity).

        ``ctx`` (v6) carries per-instance prefix-match lengths and loads
        (plus tenant-tier counts for ``wants_tier_ctx`` policies, v9);
        load-only policies may ignore it."""
        raise NotImplementedError

    def route_decode(self, req, src, pool: List):
        """Pick the decode destination for a prefilled/migrating request."""
        raise NotImplementedError

    # ------------------------------------------------------ periodic control
    def tick_interval(self) -> float:
        """Seconds between ``on_tick`` calls (0 = policy never ticks)."""
        return 0.0

    def on_tick(self, now: float) -> None:
        """Periodic cluster-wide control (role switching, rebalancing)."""

    def debug_state(self) -> Dict[str, float]:
        return {}


class LeastLoadedPolicy(ClusterPolicy):
    """v2 routing: least queued work per chip, stragglers avoided."""

    def _least_loaded(self, pool: List):
        ok = self.healthy(pool)
        return min(ok, key=lambda i: i.load()) if ok else None

    def route_prefill(self, req, pool, ctx=None):
        return self._least_loaded(pool)

    def route_decode(self, req, src, pool):
        return self._least_loaded(pool)


class LeastContendedPolicy(LeastLoadedPolicy):
    """Topology-aware decode routing: minimize spine contention.

    For each healthy decode candidate, the (src, dst) transfer path is
    resolved through the cluster's ``Topology`` and scored by how
    contended its segments are RIGHT NOW (live flows crossing each
    segment, the dominant term) plus how contended they have BEEN
    (per-segment ``queue_delay_s`` from ``LinkModel.stats()["per_link"]``
    — a slow-moving tiebreak that learns persistently hot planes).  Ties
    fall back to instance load, so with an idle fabric this degrades to
    least-loaded routing.  Bound clusters without a topology (or unit
    tests routing bare pools) also degrade to least-loaded.

    v9: prefill routing stays least-loaded but breaks LOAD ties toward
    interactive-tier isolation (see :func:`_tier_penalty`) — the policy
    sets ``wants_tier_ctx`` so the cluster populates per-instance
    interactive counts in the route context."""

    # one live flow on a segment outweighs any accumulated-delay tiebreak
    _LIVE_FLOW_WEIGHT = 1e3
    wants_tier_ctx = True

    def route_prefill(self, req, pool, ctx=None):
        ok = self.healthy(pool)
        if not ok:
            return None
        return min(ok, key=lambda i: (i.load(), _tier_penalty(ctx, i.name)))

    def route_decode(self, req, src, pool):
        ok = self.healthy(pool)
        if not ok:
            return None
        c = getattr(self, "cluster", None)
        topo = getattr(c, "topology", None)
        lm = getattr(c, "link_model", None)
        if topo is None or lm is None:
            return min(ok, key=lambda i: i.load())
        from repro_torch.transport.links import seg_key
        per_link = lm.stats().get("per_link", {})

        def contention(dst) -> float:
            score = 0.0
            for seg in topo.path(src.name, dst.name):
                score += lm.active_count(seg) * self._LIVE_FLOW_WEIGHT
                score += per_link.get(seg_key(seg), {}).get(
                    "queue_delay_s", 0.0)
            return score

        return min(ok, key=lambda i: (contention(i), i.load()))


@dataclasses.dataclass
class RoleSwitchConfig:
    check_interval_s: float = 0.25   # on_tick cadence (virtual seconds)
    ttft_hi_s: float = 1.0           # oldest queued prefill age that borrows
    ttft_lo_s: float = 0.1           # pressure below this returns instances
    cooldown_s: float = 1.0          # min gap between role flips
    min_decode: int = 1              # never shrink the decode pool below this
    decode_busy_hi: float = 0.85     # decode slot occupancy that (a) blocks
    #                                  borrowing and (b) forces a return


class RoleSwitchPolicy(LeastLoadedPolicy):
    """Dynamic role-switching over a disaggregated deployment.

    Borrow rule: when the oldest queued prefill has waited longer than
    ``ttft_hi_s`` (TTFT pressure) and the decode pool has slack, the
    least-busy decode instance flips to prefill; its in-flight decode KV
    drains to the remaining decode instances over the copy-engine path.

    Return rule: when TTFT pressure falls below ``ttft_lo_s`` — or decode
    occupancy crosses ``decode_busy_hi`` — the most recently borrowed
    instance flips back to decode.  Both rules respect a cooldown so the
    fleet never thrashes."""

    def __init__(self, cfg: Optional[RoleSwitchConfig] = None):
        self.cfg = cfg or RoleSwitchConfig()
        self.borrowed: List = []     # decode instances currently prefilling
        self.flips = 0
        self._last_flip = -1e30
        self._pressure = 0.0
        self._decode_busy = 0.0

    def tick_interval(self) -> float:
        return self.cfg.check_interval_s

    # ------------------------------------------------------------- signals
    def prefill_pressure(self, now: float, prefill_pool: List) -> float:
        """Age of the oldest prefill op still queued anywhere in the pool
        (the cluster-wide TTFT pressure signal)."""
        oldest = None
        for inst in prefill_pool:
            if inst.failed:
                continue
            t = inst.daemon.oldest_pending_time(Phase.PREFILL)
            if t is not None and (oldest is None or t < oldest):
                oldest = t
            for r in inst.prefill_waiting:        # parked / unadmitted
                if oldest is None or r.arrival_time < oldest:
                    oldest = r.arrival_time
        return 0.0 if oldest is None else max(0.0, now - oldest)

    @staticmethod
    def decode_busy(decode_pool: List) -> float:
        ok = [i for i in decode_pool if not i.failed]
        slots = sum(i.sim_cfg.max_num_seqs for i in ok)
        if slots <= 0:
            return 1.0
        return sum(len(i.active) + len(i.decode_pending) for i in ok) / slots

    # ---------------------------------------------------------------- tick
    def on_tick(self, now: float) -> None:
        c = self.cluster
        cfg = self.cfg
        self._pressure = self.prefill_pressure(now, c.prefill_pool)
        self._decode_busy = self.decode_busy(c.decode_pool)
        if now - self._last_flip < cfg.cooldown_s:
            return
        if self.borrowed and self._pressure > cfg.ttft_lo_s:
            # keep re-leveling the router-visible prefill queues while
            # borrowed capacity is active: waiting requests are pure
            # routing state, so this continuously corrects any imbalance
            # (e.g. real dispatch overhead the cost model doesn't see)
            c._rebalance_prefill_queues()
        decode_ok = [i for i in c.decode_pool if not i.failed]
        if (self._pressure > cfg.ttft_hi_s
                and len(decode_ok) > cfg.min_decode
                and self._decode_busy < cfg.decode_busy_hi):
            victim = min(decode_ok,
                         key=lambda i: len(i.active) + len(i.decode_pending))
            if c.switch_role(victim, "prefill"):
                self.borrowed.append(victim)
                self.flips += 1
                self._last_flip = now
        elif self.borrowed and (self._pressure < cfg.ttft_lo_s
                                or self._decode_busy > cfg.decode_busy_hi):
            inst = self.borrowed[-1]
            if inst.failed:
                self.borrowed.pop()
            elif c.switch_role(inst, "decode"):
                self.borrowed.pop()
                self.flips += 1
                self._last_flip = now

    def debug_state(self):
        return {"role_flips": self.flips,
                "borrowed_now": len(self.borrowed),
                "prefill_pressure_s": round(self._pressure, 4),
                "decode_busy": round(self._decode_busy, 4)}


class PrefixAffinityPolicy(LeastContendedPolicy):
    """Data-aware prefill routing over the prefix-cache tier (v6).

    Route each prefill to the healthy instance already holding the
    LONGEST indexed prefix match for the request (``ctx.match_tokens``,
    probed by the cluster per routing decision), provided the best match
    covers at least ``min_match_pages`` index pages — recomputing less
    than a page is cheaper than any affinity imbalance.  Ties break by
    instance load.  With no usable match (cold cache, tokenless
    requests, or a caller passing no context) the policy degrades to
    :class:`LeastContendedPolicy` — load-based prefill routing plus its
    topology-aware decode routing, which this class inherits unchanged.

    v9: load ties (among tied-best-match candidates AND on the fallback
    path) break toward interactive-tier isolation, like the parent."""

    def __init__(self, min_match_pages: int = 1):
        self.min_match_pages = max(1, int(min_match_pages))
        self.affinity_routes = 0
        self.fallback_routes = 0

    def route_prefill(self, req, pool, ctx=None):
        ok = self.healthy(pool)
        if not ok:
            return None
        if ctx is not None and ctx.match_tokens:
            best = max(ctx.match_tokens.get(i.name, 0) for i in ok)
            floor = self.min_match_pages * max(1, ctx.page_tokens)
            if best >= floor:
                cands = [i for i in ok
                         if ctx.match_tokens.get(i.name, 0) == best]
                self.affinity_routes += 1
                return min(cands, key=lambda i: (i.load(),
                                                 _tier_penalty(ctx, i.name)))
        self.fallback_routes += 1
        return min(ok, key=lambda i: (i.load(), _tier_penalty(ctx, i.name)))

    def debug_state(self):
        return {"affinity_routes": self.affinity_routes,
                "fallback_routes": self.fallback_routes}


class JBSQPolicy(LeastLoadedPolicy):
    """Bounded join-the-shortest-predicted-queue routing (v9).

    JBSQ(k) from the predictive-serving literature: an arriving prefill
    joins the instance whose queue holds the least PREDICTED work —
    seconds of modeled prefill service summed over every queued prompt,
    not a request count, so one 8k-token monster counts for what it
    costs — among instances with fewer than ``bound`` queued prefills.
    When every instance is at the bound, the depth filter drops
    (work-conserving: routing never refuses a request for the bound; the
    overflow is counted in ``debug_state`` instead).

    Decode placement uses the length model the same way: join the
    instance with the least predicted OUTSTANDING generation (predicted
    final length minus tokens already generated, summed over its decode
    sets).  Without bound predictors both paths degrade to least-loaded.

    Tier tiebreaks: predicted-work ties (idle fleet) break by load, then
    toward interactive-tier isolation like the other v9 routers."""

    wants_tier_ctx = True

    def __init__(self, bound: int = 4):
        self.bound = max(1, int(bound))
        self.latency = None
        self.length = None
        self.bound_exceeded = 0
        self.predicted_routes = 0
        self.fallback_routes = 0

    def bind_predictor(self, latency=None, length=None) -> None:
        self.latency = latency
        self.length = length

    def _prefill_work(self, inst) -> float:
        """Predicted seconds of prefill service queued on one instance."""
        total = 0.0
        for r in list(inst.prefill_waiting) + list(inst.prefilling.values()):
            left = max(r.prompt_len - getattr(r, "cached_tokens", 0), 1)
            # memo per (request, remaining-tokens): one queued request is
            # re-scored on every arrival, and this scan runs inside the
            # routing path the threaded drive times for real
            memo = getattr(r, "_jbsq_svc", None)
            if memo is not None and memo[0] == left:
                total += memo[1]
                continue
            p = self.latency.predict("prefill", float(left), float(left))
            v = p if p is not None else left * 1e-6
            r._jbsq_svc = (left, v)
            total += v
        return total

    def route_prefill(self, req, pool, ctx=None):
        ok = self.healthy(pool)
        if not ok:
            return None

        def depth(i) -> int:
            return len(i.prefill_waiting) + len(i.prefilling)

        under = [i for i in ok if depth(i) < self.bound]
        if not under:
            self.bound_exceeded += 1
            under = ok
        if self.latency is not None and self.latency.fitted:
            self.predicted_routes += 1
            return min(under, key=lambda i: (self._prefill_work(i), i.load(),
                                             _tier_penalty(ctx, i.name)))
        self.fallback_routes += 1
        return min(under, key=lambda i: (i.load(),
                                         _tier_penalty(ctx, i.name)))

    def route_decode(self, req, src, pool):
        ok = self.healthy(pool)
        if not ok:
            return None
        if self.length is None:
            return min(ok, key=lambda i: i.load())

        def outstanding(i) -> float:
            total = 0.0
            for r in list(i.active) + list(i.decode_pending):
                # freeze the length prediction at the first scoring of
                # each request (the sketch keeps learning for LATER
                # requests; re-querying it per scan buys nothing but a
                # per-route O(batch) quantile walk)
                pred = getattr(r, "_len_pred", None)
                if pred is None:
                    pred = self.length.predict_for(r)
                    r._len_pred = pred
                total += max(pred - getattr(r, "generated", 0), 1.0)
            return total

        return min(ok, key=lambda i: (outstanding(i), i.load()))

    def debug_state(self):
        return {"jbsq_bound": float(self.bound),
                "jbsq_bound_exceeded": float(self.bound_exceeded),
                "jbsq_predicted_routes": float(self.predicted_routes),
                "jbsq_fallback_routes": float(self.fallback_routes)}

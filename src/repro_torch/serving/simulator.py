"""Discrete-event cluster simulator for 384-card-scale serving experiments.

The FlexDaemon, scheduler policies, profiler, queues, and request lifecycle
are the SAME objects used by the real-execution engine — the simulator only
replaces ``execute()`` wall time with roofline-modeled durations and advances
a virtual clock (DESIGN.md §2).  One daemon models one serving *instance*
(the SPMD group of chips dispatches one step at a time, like the real stack).

A Cluster opens ONE multi-device session (``connect(mode="sim",
devices=N)``): instance *i* is device *i*, with its own stepped daemon,
handle tables, and memory accounting.  Instances submit work through their
device-scoped client using the same v2 verbs as the real engine — prefill
and decode each run on a dedicated virtual stream, so the daemon's
stream-ordered, dependency-aware dispatch applies identically under the
virtual clock.

Deployments (paper §4):
  * ``disagg``          — static PD disaggregation (e.g. 6P2D): separate
                          prefill/decode instances + KV-transfer delay.
  * ``static_colocate`` — P+D share instances, FIFO order, prefill admission
                          gated on a free decode slot (head-of-line blocking).
  * ``dynamic_pd``      — FlexNPU: P+D as separate logical components routed
                          through one daemon with DynamicPDPolicy.
  * ``static_slice``    — co-location with a FIXED time-slice ratio
                          (Figures 5/6 sweeps).

Fault tolerance: instances can be failed mid-run (state lost, queued +
in-flight requests re-routed and restarted), or slowed (straggler); the
router avoids stragglers using fleet-relative EWMA step times.

Control plane (v3, ``repro_torch.sched``): dispatch policies are built through
the policy registry, prefill admission goes through a shared
``AdmissionPolicy`` (the same implementation the real engine uses), and a
``ClusterPolicy`` owns routing, migration, and **dynamic role-switching**
(``Cluster.switch_role``): a decode instance under prefill backlog flips
role — draining its in-flight decode KV over the copy-engine path — and
flips back when TTFT pressure subsides.

Drive modes: ``drive="stepped"`` (default) is the discrete-event simulator
above; ``drive="threaded"`` runs the SAME instances over real daemon
dispatch threads against a wall clock scaled by ``time_scale``
(``repro_torch.serving.realtime``), so control-plane behavior is validated under
real concurrency too.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import math
import threading
from typing import Callable, Deque, Dict, List, Optional, Tuple

# flexlint: ignore[layering] -- serving -> cache prefix-reuse use is the API
from repro_torch.cache import make_cache, request_block_hashes
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import OpDescriptor, OpType, Phase
from repro_torch.core.queues import flops_key
from repro_torch.core.session import connect
from repro_torch.predict import ChunkAdapter, cost_model_samples, make_predictor
# flexlint: ignore[layering] -- serving -> sched policy-plane use is the API
from repro_torch.sched import (INTERACTIVE_PRIORITY, AdmissionPolicy, AdmissionView,
                         ClusterPolicy, DynamicPDConfig, DynamicPDPolicy,
                         FIFOPolicy, GatedAdmission, RouteContext,
                         UngatedAdmission, make_policy, policy_kind)
from repro_torch.serving.costmodel import CostModel, InstanceSpec
from repro_torch.serving.request import TERMINAL_STATES, Request, RequestState
# KV transport subsystem: topology-resolved multi-hop paths, the path-aware
# link model (also reused, with fractional demand shares, as the per-device
# compute-contention model), the stepped drivers, and chunked layer-wise KV
# streaming.  The one-release re-exports from this module were removed —
# import these from repro_torch.transport[.drivers] directly.
from repro_torch.transport import KVStreamer, LinkModel, Topology
from repro_torch.transport.drivers import LinkDriver


class SimClock:
    def __init__(self):
        self.t = 0.0

    def now(self) -> float:
        return self.t


class SimBackend:
    """Backend facade for daemons living inside the simulation."""

    def __init__(self, clock: SimClock):
        self.clock = clock

    def now(self) -> float:
        return self.clock.t

    def estimate(self, op: OpDescriptor) -> float:
        return float(op.meta.get("est_duration", 1e-3))

    def execute(self, op):  # never called in sim mode
        raise RuntimeError("SimBackend does not execute ops")


class EventLoop:
    """Discrete-event loop with a two-lane ready structure.

    Events carry a global ``(t, seq)`` order.  Future events live in a
    heapq; events scheduled AT the current timestamp (``defer`` and
    clamped ``at`` calls — the driver-loop hook every completion callback
    funnels through) go to an O(1) FIFO lane instead of round-tripping
    the heap.  Because the clock is monotonic and ``seq`` increases, the
    FIFO is already sorted by ``(t, seq)``, so ``run`` merge-pops the two
    lanes in EXACTLY the order the all-heap loop produced — same-timestamp
    work drains as one batch without O(log n) churn per callback.

    ``legacy_defer=True`` restores the v5 all-heap path (every event
    through ``heappush``); the regression tests compare the two lanes'
    orderings and whole-cluster ``run()`` results bit-for-bit."""

    def __init__(self, legacy_defer: bool = False):
        self.clock = SimClock()
        self._heap: List[Tuple[float, int, Callable]] = []
        # same-timestamp FIFO lane: (t, seq, fn), nondecreasing in (t, seq)
        self._deferred: Deque[Tuple[float, int, Callable]] = collections.deque()
        self._seq = itertools.count()
        self.legacy_defer = legacy_defer
        self.events = 0    # callbacks executed (sim-throughput telemetry)

    def at(self, t: float, fn: Callable) -> None:
        if t <= self.clock.t and not self.legacy_defer:
            self._deferred.append((self.clock.t, next(self._seq), fn))
        else:
            heapq.heappush(self._heap,
                           (max(t, self.clock.t), next(self._seq), fn))

    def after(self, dt: float, fn: Callable) -> None:
        self.at(self.clock.t + dt, fn)

    def defer(self, fn: Callable) -> None:
        """Driver-loop hook (v5): run ``fn`` at the CURRENT virtual time,
        but only after the event being processed unwinds.  Closed-loop
        traffic sources are fed through this — their ``on_complete`` may
        submit a new request, which must not mutate instance state from
        inside a ``_decode_done``/``_retire`` call stack."""
        self.at(self.clock.t, fn)

    def run(self, until: float = math.inf, max_events: int = 50_000_000):
        heap, dq, clock = self._heap, self._deferred, self.clock
        n = 0
        while (heap or dq) and n < max_events:
            # merge-pop by (t, seq): the FIFO front is the oldest deferred
            # event; it wins over the heap top only if strictly older in
            # the global order (seq ties are impossible — one counter)
            if dq:
                use_dq = (not heap or dq[0][0] < heap[0][0]
                          or (dq[0][0] == heap[0][0]
                              and dq[0][1] < heap[0][1]))
            else:
                use_dq = False
            t = dq[0][0] if use_dq else heap[0][0]
            if t > until:
                clock.t = until
                return       # beyond-horizon events stay queued for resume
            if use_dq:
                t, _seq, fn = dq.popleft()
            else:
                t, _seq, fn = heapq.heappop(heap)
            clock.t = t
            fn()
            n += 1
            self.events += 1


@dataclasses.dataclass
class SimConfig:
    max_num_seqs: int = 256            # decode slots per instance
    max_prefill_tokens: int = 8192     # tokens batched into one prefill launch
    kv_reserve_frac: float = 0.10
    transfer_bw: float = 50e9          # disaggregation KV link (per link)
    transfer_latency_s: float = 1e-3   # fixed per-transfer launch latency
    admission_gated: bool = False      # static co-location: prefill needs slot
    # micro-batched prefill: split each prompt into launches of at most
    # this many tokens (0 = one whole-prompt op).  Chunks of one request
    # ride ONE prefill stream, so they stay FIFO; between chunks the
    # dispatch policy may interleave decode — and on a multi-queue device
    # (compute_queues > 1) decode overlaps the chunks outright.
    chunk_prefill_tokens: int = 0
    # execution queues per device (repro_torch.core.queues): compute_queues > 1
    # lets compute ops overlap on one device — decode is pinned to the
    # highest-index compute queue, prefill streams spread over the rest —
    # with concurrent compute ops splitting modeled FLOP throughput by
    # their compute-boundedness (processor sharing, like LinkModel).
    # The default (1, 1) is the v3 engine-slot behavior, bit-for-bit.
    compute_queues: int = 1
    copy_queues: int = 1
    # max prefills enqueued-but-incomplete per instance (0 = unbounded).
    # A small window keeps excess prefill backlog in the instance's
    # router-visible waiting queue instead of the device queue, so a role
    # switch can REBALANCE it onto a newly-borrowed instance (work already
    # on a daemon cannot move).  Work-conserving for any window >= 2.
    prefill_window: int = 0
    # KV transport (repro_torch.transport): the interconnect topology that
    # resolves (src, dst) transfer paths (None = flat destination-ingress
    # contention at transfer_bw, the v2 behavior), and the layer-wise
    # streaming granularity in token-equivalents per chunk (0 = one blob
    # per request, the v2 behavior).
    topology: Optional[Topology] = None
    kv_chunk_tokens: int = 0
    # Prefix-cache tier (v6, repro_torch.cache): ``prefix_cache`` names the
    # eviction policy from make_cache ("none" = disabled — bit-compatible
    # with v5); blocks are ``prefix_page_tokens`` wide and each instance's
    # cache budget is ``prefix_cache_frac`` of its KV capacity (occupancy
    # charged to the instance ledger).  ``remote_prefix_fetch`` lets the
    # cluster copy a longer remote match over the KV transport path when
    # the cost model says the copy beats recomputing it.
    prefix_cache: str = "none"
    prefix_cache_knobs: Dict = dataclasses.field(default_factory=dict)
    prefix_page_tokens: int = 64
    prefix_cache_frac: float = 0.2
    remote_prefix_fetch: bool = True
    # Simulation fidelity: "discrete" is the exact event-per-step
    # simulator; "fluid" integrates queue drain rates between decision
    # points (repro_torch.serving.fluid) — ~100x cheaper per event and clearly
    # APPROXIMATE (results carry fidelity="fluid"; use for capacity
    # planning, never for latency-tail or policy-behavior claims).
    fidelity: str = "discrete"
    # regression hook: route defer() through the heap like v5 (the
    # bit-identical event-order tests compare this against the batched
    # FIFO lane; no production reason to enable it)
    legacy_event_loop: bool = False


class SimInstance:
    """One serving instance: a session device + batch formation + KV
    accounting.  ``client``/``daemon`` come from the cluster's multi-device
    session (instance i == device i)."""

    def __init__(self, name: str, spec: InstanceSpec, cost: CostModel,
                 loop: EventLoop, client, daemon, sim_cfg: SimConfig,
                 role: str = "both",
                 admission: Optional[AdmissionPolicy] = None,
                 lock: Optional[threading.RLock] = None,
                 drive: str = "stepped"):
        self.name = name
        self.spec = spec
        self.cost = cost
        self.loop = loop
        self.sim_cfg = sim_cfg
        # "prefill" | "decode" | "both" (switchable)
        self.role = role                # guarded-by: _lock
        self.drive = drive
        # shared admission policy (control plane v3) — the same object type
        # RealEngine uses, so gating decisions cannot drift between them
        self.admission = admission or (
            GatedAdmission(count_prefilling=False)
            if sim_cfg.admission_gated else UngatedAdmission())
        # serving-state lock: the cluster shares ONE RLock across instances
        # (threaded drive mutates state from daemon engine threads; in the
        # stepped drive it is uncontended)
        self._lock = lock or threading.RLock()
        self.client = client
        self.daemon = daemon
        # execution queues (v4): with one compute queue this is exactly the
        # v3 stream layout (one prefill + one decode stream, any-queue).
        # With compute_queues > 1, decode is PINNED to the highest-index
        # compute queue (prefill can never occupy it) and prefill streams
        # spread over the remaining queues, requests round-robining across
        # them — micro-batched prefill chunks then overlap decode steps.
        cq = max(1, sim_cfg.compute_queues)
        if cq > 1:
            self.streams_p = [client.create_stream(phase=Phase.PREFILL,
                                                   queue=i)
                              for i in range(cq - 1)]
            self.stream_d = client.create_stream(phase=Phase.DECODE,
                                                 queue=cq - 1)
        else:
            self.streams_p = [client.create_stream(phase=Phase.PREFILL)]
            self.stream_d = client.create_stream(phase=Phase.DECODE)
        self.stream_p = self.streams_p[0]
        self.stream_c = client.copy_engine_stream()   # KV transfers
        # round-robin over prefill streams
        self._rr_prefill = 0            # guarded-by: _lock
        self.slow_factor = 1.0          # guarded-by: _lock
        self.failed = False             # guarded-by: _lock
        self.link_driver: Optional[LinkDriver] = None  # set by the Cluster
        # compute-contention model (set by the Cluster when the device has
        # >1 compute queue): concurrent compute ops on this device split
        # modeled FLOP throughput by their compute shares
        self.compute_key = flops_key(name)
        self.compute_driver = None     # stepped drive (LinkDriver)
        self.shares_compute = cq > 1   # threaded drive routes through timer
        # request state: awaiting admission (gated) -> prefill queued or
        # in flight -> prefilled awaiting a slot -> decoding
        self.prefill_waiting: List[Request] = []    # guarded-by: _lock
        self.prefilling: Dict[int, Request] = {}    # guarded-by: _lock
        self.decode_pending: List[Request] = []     # guarded-by: _lock
        self._active: List[Request] = []            # guarded-by: _lock
        # running sum of total_tokens over `active` (guarded-by: _lock):
        # the decode hot path reads the batch's average context every step,
        # and an O(batch) sum per step dominated the simulator's profile —
        # integer increments keep this EXACTLY equal to the full sum.
        # Reassigning `active` wholesale (tests poke it; drain paths swap
        # it) re-syncs the counter through the property setter.
        self._active_tokens = 0
        # Lazy decode-step bookkeeping (guarded-by: _lock): every
        # active request gains exactly one token per decode step, so the
        # hot path only bumps aggregate counters and pops this step's
        # finish bucket — O(finishers), not O(batch).  Per-request fields
        # (generated / last_token_time) materialize in _materialize_tokens
        # at every exit from `active` (finish, drain, removal, end of run);
        # the arithmetic is integer step counts, so materialized values are
        # EXACTLY what the per-request loop would have produced.
        self._step_idx = 0                 # decode steps completed here
        self._last_step_time = -1.0        # clock time of the latest step
        # req_id -> (join_step, generated_at_join, finish_step)
        self._decode_join: Dict[int, Tuple[int, int, int]] = {}
        self._finish_step: Dict[int, List[Request]] = {}
        self._await_second: List[Request] = []  # need second_token_time
        # finished decoding but their KV tail is still streaming in: they
        # cannot retire (pages partly in flight) until the stream completes
        self.stalled: Dict[int, Request] = {}       # guarded-by: _lock
        self._stall_start: Dict[int, float] = {}    # guarded-by: _lock
        self.decode_stall_s = 0.0                   # guarded-by: _lock
        self.stalls = 0                             # guarded-by: _lock
        self.kv_capacity = cost.kv_capacity_tokens(
            spec, sim_cfg.kv_reserve_frac)
        if self.kv_capacity <= 0:
            raise ValueError(
                f"{name}: weights ({cost.weights_bytes() / 1e9:.0f} GB) do "
                f"not fit {spec.chips} chips x 16 GB HBM — choose a larger "
                f"instance or a smaller/quantized model")
        self.kv_used = 0                            # guarded-by: _lock
        # prompt tokens whose KV is still charged here while a copy-engine
        # transfer to a decode instance is in flight (conservation: the
        # source pages are only freed once the destination holds the copy)
        self.kv_in_transit = 0                      # guarded-by: _lock
        # prefix-cache tier (v6, repro_torch.cache): retained prompt-KV blocks
        # this instance can re-serve.  Occupancy is charged into kv_used
        # through on_delta (cached blocks are real HBM pages), inserts are
        # gated on live KV headroom, and the budget is a fraction of KV
        # capacity.  "none" (the default) is a NullPrefixCache: every call
        # is a no-op and behavior is bit-identical to v5.
        self.cache = make_cache(
            sim_cfg.prefix_cache or "none",
            capacity_tokens=max(
                0, int(self.kv_capacity * sim_cfg.prefix_cache_frac)),
            page_tokens=max(1, sim_cfg.prefix_page_tokens),
            on_delta=self._cache_delta, room_fn=self.kv_free,
            **sim_cfg.prefix_cache_knobs)
        self.prefix_flops_saved = 0.0               # guarded-by: _lock
        self._decode_op_inflight = False            # guarded-by: _lock
        # rejection telemetry (v5): requests the admission policy shed on
        # this instance — honest accounting's per-instance counter
        self.rejected = 0                           # guarded-by: _lock
        # predictive scheduling (v9, both set by the Cluster when the
        # deployment configures predictors; None = pre-v9 behavior):
        #   chunk_adapter  — retunes chunk_prefill_tokens per enqueue from
        #                    predicted decode-slack (repro_torch.predict.adapt)
        #   predict_observe(phase, tokens, ctx, dur) — latency-model
        #                    honesty hook, called per realized compute op
        self.chunk_adapter = None                   # guarded-by: _lock
        self.predict_observe: Optional[Callable] = None
        self.on_request_done: Optional[Callable] = None
        self.on_request_rejected: Optional[Callable] = None
        self.on_prefill_done: Optional[Callable] = None
        # cluster hook: a completion other instances may be blocked on
        # (shared-event record, peer copy) — kicks the sibling daemons
        self.on_cross_device: Optional[Callable] = None
        self.steps = {"prefill": 0, "decode": 0}    # guarded-by: _lock
        self.ewma_step = 0.0                        # guarded-by: _lock

    # ---------------------------------------------------------- utilities
    @property
    def active(self) -> List[Request]:  # holds: _lock
        """The decode batch.  In-place mutations (append/remove) must keep
        ``_active_tokens`` in step by hand — the hot paths do — but a
        wholesale reassignment (drain paths, tests poking a batch in)
        re-syncs the running sum here."""
        return self._active

    @active.setter
    def active(self, reqs: List[Request]) -> None:  # holds: _lock
        self._active = reqs
        self._active_tokens = sum(r.total_tokens for r in reqs)

    @property
    def now(self) -> float:
        return self.loop.clock.t

    def load(self) -> float:  # holds: _lock
        """Router load signal: queued work normalized by capacity."""
        q = (len(self.prefill_waiting) + len(self.decode_pending)
             + len(self.active) + self.daemon.pending_count())
        return q / max(self.spec.chips, 1)

    def kv_free(self) -> int:  # holds: _lock
        return max(0, self.kv_capacity - self.kv_used)

    def _cache_delta(self, tokens: int) -> None:  # holds: _lock
        """Prefix-cache occupancy ledger hook: cached blocks live in this
        instance's HBM, so inserts charge ``kv_used`` and evictions refund
        it (the conservation check sees cache pages like any others)."""
        self.kv_used += tokens

    # ------------------------------------------------------------ prefill
    def submit(self, req: Request) -> None:
        with self._lock:
            req.instance = self.name
            self.prefill_waiting.append(req)
            self._drain_admission()

    def _admission_view(self, idx: int = 0) -> AdmissionView:  # holds: _lock
        cand = self.prefill_waiting[idx] \
            if idx < len(self.prefill_waiting) else None
        b = len(self.active)
        return AdmissionView(
            waiting=len(self.prefill_waiting),
            next_prompt_len=cand.prompt_len if cand else 0,
            active=b,
            decode_pending=len(self.decode_pending),
            prefilling=len(self.prefilling),
            max_num_seqs=self.sim_cfg.max_num_seqs,
            kv_free=self.kv_free(),
            next_tenant=cand.tenant if cand else "",
            next_priority=cand.priority if cand else 0,
            # prefix-aware gate (v9): pure probe of THIS instance's cache
            # for the candidate — 0 with the cache off ("none"), keeping
            # the historical whole-prompt KV check bit-identical
            next_cached_tokens=self.cache.match_tokens(cand) if cand else 0,
            avg_context=(self._active_tokens // b) if b else 0)

    def _drain_admission(self) -> None:  # holds: _lock
        """Admit waiting requests per the AdmissionPolicy.  The policy
        first sheds doomed requests (honest rejection), then picks each
        admission candidate (``pick_next`` — FIFO for v3/v4 policies,
        priority + weighted-fair for ``slo_aware``).  Each pass offers at
        most ``len(waiting)`` candidates (an ungated enqueue may re-park
        one when KV is full — see ``_enqueue_prefill``), and the prefill
        dispatch window bounds device-queue depth."""
        for r in self.admission.shed(self.prefill_waiting, self.now):
            if r in self.prefill_waiting:
                self.prefill_waiting.remove(r)
                self._reject(r)
        w = self.sim_cfg.prefill_window
        n = len(self.prefill_waiting)
        while n > 0 and self.prefill_waiting \
                and (w <= 0 or len(self.prefilling) < w):
            i = self.admission.pick_next(self.prefill_waiting)
            if not self.admission.admit(self._admission_view(i)):
                return
            req = self.prefill_waiting.pop(i)
            self.admission.on_admit(req)
            self._enqueue_prefill(req)
            n -= 1

    def _reject(self, req: Request) -> None:  # holds: _lock
        """Load shedding: the request leaves the system REJECTED — a
        terminal state reported through the same completion plumbing as
        DONE, so telemetry (and closed-loop clients) always see it."""
        req.state = RequestState.REJECTED
        req.finish_time = self.now
        self.rejected += 1
        if self.on_request_rejected is not None:
            self.on_request_rejected(self, req)

    def _tightest_tpot(self) -> float:  # holds: _lock
        """Tightest TPOT SLO among the decoding requests (0 = none carries
        one) — the budget the chunk adapter protects."""
        slos = [r.slo.tpot_s for r in self.active
                if r.slo is not None and r.slo.tpot_s > 0]
        return min(slos) if slos else 0.0

    def _prefill_chunks(self, prompt_len: int,
                        chunk_tokens: Optional[int] = None) -> List[tuple]:
        """(tokens, context_offset) per micro-batch chunk: the prompt split
        into at most ``chunk_prefill_tokens``-token launches (one chunk
        when 0).  Chunks of one request ride one prefill stream, so they
        dispatch FIFO within their queue class.  ``chunk_tokens``
        overrides the static config knob (the v9 chunk adapter's per-
        enqueue decision)."""
        c = self.sim_cfg.chunk_prefill_tokens \
            if chunk_tokens is None else chunk_tokens
        if c <= 0 or prompt_len <= c:
            return [(prompt_len, 0)]
        out, off = [], 0
        while off < prompt_len:
            n = min(c, prompt_len - off)
            out.append((n, off))
            off += n
        return out

    def _enqueue_prefill(self, req: Request) -> None:  # holds: _lock
        # prefix-cache admission hook (v6): pin the longest cached prefix
        # match for this prompt — matched tokens skip recomputation and
        # only the SUFFIX is launched/charged to the cost model.  The
        # pins also shield the matched blocks from eviction until the
        # prefill settles (release in _prefill_done).
        cached = self.cache.acquire(req, self.now)
        if self.kv_free() < req.prompt_len:
            # under KV pressure the cache gives memory back before we
            # park: cached blocks are strictly less valuable than live
            # request state (they can be recomputed; a parked prompt
            # stalls a user)
            self.cache.evict_tokens(req.prompt_len - self.kv_free(),
                                    self.now)
        if self.kv_free() < req.prompt_len:
            # No KV room: park until decode frees memory.
            self.cache.release(req)
            self.prefill_waiting.append(req)
            return
        req.cached_tokens = cached
        self.kv_used += req.prompt_len
        req.state = RequestState.PREFILLING
        self.prefilling[req.req_id] = req
        # requests round-robin across the device's prefill streams (one
        # per non-decode compute queue); all chunks of ONE request share a
        # stream so program order holds without event edges
        stream = self.streams_p[self._rr_prefill % len(self.streams_p)]
        self._rr_prefill += 1
        adapted = None
        if self.chunk_adapter is not None:
            # v9 adaptive chunking: size this prompt's chunks to the
            # predicted decode-slack of the CURRENT co-located batch
            b = len(self.active)
            _, avg_ctx = self._decode_ctx()
            adapted = self.chunk_adapter.chunk_tokens(
                b, avg_ctx, self._tightest_tpot())
        chunks = self._prefill_chunks(req.prompt_len - cached, adapted)
        # one vectorized cost-model pass prices every chunk of the prompt
        # (bit-identical to per-chunk prefill_time calls — see
        # CostModel.prefill_times)
        durations = self.cost.prefill_times(
            self.spec, [c for c, _ in chunks],
            [cached + off + c for c, off in chunks])
        for i, (ctoks, off) in enumerate(chunks):
            fut = self.client.launch(
                stream, None, phase=Phase.PREFILL,
                meta={"req": req, "tokens": ctoks,
                      "ctx": cached + off + ctoks,
                      "chunk": i, "chunks": len(chunks), "_sim_inst": self,
                      **self.cost.prefill_meta(self.spec, ctoks),
                      "est_duration": float(durations[i])})
        # the request's prefill completes with its LAST chunk (a failed
        # device errors/abandons every chunk, so the callback still sees
        # the fault through the final chunk's future)
        fut.add_done_callback(lambda f, r=req: self._prefill_done(r, f))
        if cached:
            # recompute-savings telemetry: the FLOPs the cached prefix
            # would have cost (linear + causal attention over the prefix)
            self.prefix_flops_saved += self.cost.prefill_flops(
                cached, context=cached)
        self.kick()

    def _prefill_done(self, req: Request, fut) -> None:
        with self._lock:
            if self.failed:
                # threaded drive: an op already EXECUTING on its engine
                # thread when the fault hit still completes — but its
                # result is void and the request was re-routed by the
                # fault handler (the stepped drive abandons such ops in
                # _complete; this is the same rule at the callback level)
                return
            self.prefilling.pop(req.req_id, None)
            self.cache.release(req)   # unpin the matched prefix blocks
            try:
                fut.result()
            except Exception:
                return  # failure path handled by cluster re-router
            self.steps["prefill"] += 1
            # populate the prefix cache with this prompt's full-page blocks
            # (existing blocks are touched, new ones inserted if the pool
            # and live KV headroom allow)
            self.cache.insert(req, self.now)
            req.record_token(self.now)   # first token emitted at prefill end
            self._drain_admission()      # a window slot freed up
            if self.on_prefill_done is not None:
                self.on_prefill_done(self, req)
            else:
                # the token emitted at prefill end appends its KV here —
                # without this, retirement (prompt + generated) frees one
                # more token than was ever charged (the cluster's
                # _admit_local does the same for routed admissions)
                self.kv_used += req.generated
                self.admit_decode(req)

    # ------------------------------------------------------------- decode
    def admit_decode(self, req: Request, charge_kv: bool = False) -> None:
        with self._lock:
            if charge_kv:
                self.kv_used += req.prompt_len + req.generated
            req.instance = self.name
            req.state = RequestState.DECODE_QUEUED
            self.decode_pending.append(req)
            self._fill_slots()
            self._ensure_decode_op()

    def drain_decode(self) -> List[Request]:
        """Role switch (decode -> prefill): stop decoding and hand every
        queued/active decode request back to the cluster for migration.

        The requests' KV pages STAY charged here (``kv_used`` includes
        prompt + generated tokens for each) — the cluster moves each one
        over the copy-engine path and only then frees the source copy, the
        same conservation rule as prefill-side transfers.  An in-flight
        decode op settles harmlessly against the emptied active list.

        Requests whose KV is still STREAMING IN are pinned here: their
        pages are partly in flight from another source, so they cannot
        migrate mid-stream — they finish decoding in place (in-flight work
        completes, the same rule as prefills during a prefill->decode
        flip)."""
        with self._lock:
            drained = [r for r in self.decode_pending + self.active
                       if not r.kv_stream_pending]
            self.decode_pending = [r for r in self.decode_pending
                                   if r.kv_stream_pending]
            kept = [r for r in self.active if r.kv_stream_pending]
            for r in self.active:
                if r.kv_stream_pending:
                    self._materialize_tokens(r)   # stays active here
                else:
                    self._forget_decode(r)        # migrates away
            self.active = kept          # setter re-syncs _active_tokens
            return drained

    def _fill_slots(self) -> None:  # holds: _lock
        while (self.decode_pending
               and len(self.active) < self.sim_cfg.max_num_seqs):
            r = self.decode_pending.pop(0)
            r.state = RequestState.DECODING
            self.active.append(r)
            self._active_tokens += r.total_tokens
            # register the deterministic finish step: one token per step,
            # done when generated reaches max_new_tokens (at least one
            # step — matches the old per-step `>= max` check exactly)
            fin = self._step_idx + max(1, r.max_new_tokens - r.generated)
            self._decode_join[r.req_id] = (self._step_idx, r.generated, fin)
            self._finish_step.setdefault(fin, []).append(r)
            if r.second_token_time < 0:
                self._await_second.append(r)

    def _materialize_tokens(self, r: Request) -> None:  # holds: _lock
        """Fold the steps a request sat in `active` into its per-request
        fields (exact integer catch-up of the lazy decode bookkeeping)."""
        ent = self._decode_join.get(r.req_id)
        if ent is None:
            return
        join_step, gen0, fin = ent
        steps = self._step_idx - join_step
        if steps > 0:
            r.generated = gen0 + steps
            r.last_token_time = self._last_step_time
            self._decode_join[r.req_id] = (self._step_idx, r.generated, fin)

    def _forget_decode(self, r: Request) -> None:  # holds: _lock
        """Materialize + unregister a request leaving `active`."""
        self._materialize_tokens(r)
        ent = self._decode_join.pop(r.req_id, None)
        if ent is not None:
            bucket = self._finish_step.get(ent[2])
            if bucket is not None and r in bucket:
                bucket.remove(r)
                if not bucket:
                    del self._finish_step[ent[2]]
        if r in self._await_second:
            self._await_second.remove(r)

    def sync_token_state(self) -> None:
        """Materialize every active request's lazily-advanced token fields
        (summaries / conservation checks read them mid-run)."""
        with self._lock:
            for r in self.active:
                self._materialize_tokens(r)

    def _decode_ctx(self) -> Tuple[int, int]:  # holds: _lock
        """(batch, avg_context) of the CURRENT decode batch — the running
        ``_active_tokens`` sum makes this O(1) per decode step."""
        b = max(1, len(self.active))
        ctx = (self._active_tokens // b) if self.active else 1024
        return b, ctx

    def _ensure_decode_op(self) -> None:  # holds: _lock
        if self._decode_op_inflight or not (self.active or self.decode_pending):
            return
        self._decode_op_inflight = True
        b, ctx = self._decode_ctx()
        fut = self.client.launch(
            self.stream_d, None, phase=Phase.DECODE,
            meta={"est_duration": self._decode_estimate(), "_sim_inst": self,
                  **self.cost.decode_meta(self.spec, b, ctx)})
        fut.add_done_callback(self._decode_done)
        self.kick()

    def _decode_estimate(self) -> float:  # holds: _lock
        b, ctx = self._decode_ctx()
        return self.cost.decode_time(self.spec, b, ctx)

    def op_duration(self, op: OpDescriptor) -> float:
        """Modeled duration of an op at EXECUTION time — one implementation
        for both drives (stepped ``_dispatch`` and the real-time backend):
        decode late-binds its batch (continuous batching), ``slow_factor``
        applies, and the straggler EWMA updates."""
        with self._lock:
            if op.phase == Phase.DECODE:
                dur = self._decode_estimate()
                b, ctx = self._decode_ctx()
                op.meta.update(self.cost.decode_meta(self.spec, b, ctx))
            elif op.phase == Phase.PREFILL:
                dur = float(op.meta.get("est_duration", 1e-3))
            else:
                # bookkeeping ops (event markers, cost-only copies without
                # a link): modeled duration, no slowdown — a straggling
                # compute pipeline doesn't slow the DMA engine
                return float(op.meta.get("est_duration", 0.0))
            dur *= self.slow_factor
            if self.predict_observe is not None:
                # v9 honesty loop: grade the latency model on the REALIZED
                # duration (straggler slowdown included) of every compute op
                t = float(op.meta.get("tokens", 1))
                self.predict_observe(op.phase.value, t,
                                     float(op.meta.get("ctx", t)), dur)
            self.ewma_step = 0.8 * self.ewma_step + 0.2 * dur \
                if self.ewma_step else dur
            return dur

    def op_compute_share(self, op: OpDescriptor) -> float:
        """The op's demand on the device's FLOP throughput (its compute-
        boundedness, from the cost model) — the weight the contention
        model shares FLOPs by when compute ops overlap on a multi-queue
        device.  Late-bound like ``op_duration`` (decode's batch forms at
        execution time)."""
        with self._lock:
            if op.phase == Phase.DECODE:
                b, ctx = self._decode_ctx()
                return self.cost.decode_compute_share(self.spec, b, ctx)
            if op.phase == Phase.PREFILL:
                return self.cost.prefill_compute_share(
                    self.spec, int(op.meta.get("tokens", 1)),
                    context=int(op.meta.get("ctx", 0)))
            return 1.0

    def _decode_done(self, fut) -> None:
        with self._lock:
            self._decode_op_inflight = False
            if self.failed:
                return  # void completion of an in-flight op (see above)
            try:
                fut.result()
            except Exception:
                return
            self.steps["decode"] += 1
            now = self.loop.clock.t
            self._step_idx += 1
            self._last_step_time = now
            n = len(self.active)
            self.kv_used += n           # one token appended per sequence
            self._active_tokens += n
            # first/second token times are one-shot per request: recorded
            # the first step(s) after joining, then never touched again
            if self._await_second:
                still = []
                for r in self._await_second:
                    if r.first_token_time < 0:
                        r.first_token_time = now
                        still.append(r)   # second token is the NEXT step
                    else:
                        r.second_token_time = now
                self._await_second = still
            # requests finishing THIS step were known at join time — pop
            # the bucket instead of scanning the whole batch (the bucket
            # preserves join order, which is `active` order)
            finished = self._finish_step.pop(self._step_idx, [])
            for r in finished:
                join_step, gen0, _fin = self._decode_join.pop(r.req_id)
                r.generated = gen0 + (self._step_idx - join_step)
                r.last_token_time = now
                if self._await_second and r in self._await_second:
                    self._await_second.remove(r)  # one/two-token outputs
                self.active.remove(r)
                self._active_tokens -= r.total_tokens
                if r.kv_stream_pending:
                    # decode outran the inbound KV stream: the request
                    # cannot retire while its pages are partly in flight —
                    # park it until the tail lands (decode stall)
                    self.stalled[r.req_id] = r
                    self._stall_start[r.req_id] = self.now
                    self.stalls += 1
                    continue
                self._retire(r)
            if finished:
                self._retry_parked()
            self._fill_slots()
            self._ensure_decode_op()

    def _retire(self, r: Request) -> None:  # holds: _lock
        """Free a finished request's pages and report completion."""
        self.kv_used -= r.total_tokens
        r.state = RequestState.DONE
        r.finish_time = self.now
        if self.on_request_done is not None:
            self.on_request_done(self, r)

    def finish_stalled(self, req: Request) -> None:
        """The inbound KV stream completed: retire the request if decode
        already finished (accounting the stall), else no-op — it is still
        active/queued and will retire through ``_decode_done``."""
        with self._lock:
            r = self.stalled.pop(req.req_id, None)
            if r is None:
                return
            self.decode_stall_s += self.now - self._stall_start.pop(
                r.req_id, self.now)
            self._retire(r)
            self._retry_parked()
            self._fill_slots()
            self._ensure_decode_op()

    def remove_request(self, req: Request) -> None:
        """Drop a not-yet-finished request from every decode queue (its
        inbound stream died with the source; the cluster re-routes it)."""
        with self._lock:
            if req in self.decode_pending:
                self.decode_pending.remove(req)
            if req in self.active:
                self._forget_decode(req)
                self.active.remove(req)
                self._active_tokens -= req.total_tokens
            if self.stalled.pop(req.req_id, None) is not None:
                self._stall_start.pop(req.req_id, None)

    def _retry_parked(self) -> None:
        """Freed slots/KV may admit waiting or parked requests."""
        with self._lock:
            self._drain_admission()

    # ----------------------------------------------------- device driving
    def kick(self) -> None:  # holds: _lock
        """Dispatch every ready op the device's engines can take.

        The daemon hands out at most one op per free engine slot, so a
        copy-engine transfer and a compute launch run concurrently on the
        virtual clock (the threaded daemon does the same on real threads)."""
        if self.failed or self.drive != "stepped":
            return  # threaded drive: the daemon's own dispatcher runs ops
        # batched decision point: one lock round-trip hands out
        # every op the device's free queues can take — the same op
        # sequence as the old select-one-dispatch-one loop (dispatching
        # only schedules future events; it never changes what is ready)
        for op in self.daemon.select_ready(self.now):
            self._dispatch(op)

    def _dispatch(self, op: OpDescriptor) -> None:
        # Copy-engine transfers are timed by the shared LinkModel: their
        # duration depends on link occupancy, not a fixed estimate.
        if op.op == OpType.MEMCPY_PEER and self.link_driver is not None \
                and op.meta.get("link") is not None:
            self.link_driver.start(op.meta["link"],
                                   float(op.meta.get("nbytes", 0)),
                                   lambda x, o=op: self._complete(o))
            return
        # Multi-queue devices: concurrent compute ops split modeled FLOP
        # throughput — route launches through the compute-contention model
        # (work = solo duration x share; weighted processor sharing, so a
        # bandwidth-bound decode stretches a co-located prefill only by
        # its small compute share).  Single-queue devices (the default)
        # never see compute concurrency and keep the fixed-duration path.
        if (op.op == OpType.LAUNCH and self.compute_driver is not None
                and op.phase in (Phase.PREFILL, Phase.DECODE)):
            dur = self.op_duration(op)
            share = self.op_compute_share(op)
            self.compute_driver.start(self.compute_key, dur * share,
                                      lambda x, o=op: self._complete(o),
                                      share=share)
            return
        self.loop.after(self.op_duration(op), lambda o=op: self._complete(o))

    def _complete(self, op: OpDescriptor) -> None:
        # stepped-drive completion callback (event loop / link driver):
        # the fault flag and everything kick() touches live under the
        # serving-state lock like every other mutation path
        with self._lock:
            if self.failed:
                # the op was in flight when the fault hit: its result is
                # void, but cross-device effects must settle (a shared
                # record peers wait on, a peer's memcpy ref) or siblings
                # wedge/leak
                self.daemon.abandon_inflight(op)
                if self.on_cross_device is not None and \
                        op.op in (OpType.RECORD_EVENT, OpType.MEMCPY_PEER):
                    self.on_cross_device()
                return
            self.daemon.mark_complete(op, self.now)
            if self.on_cross_device is not None and \
                    op.op in (OpType.RECORD_EVENT, OpType.MEMCPY_PEER):
                self.on_cross_device()
            self.kick()

    # ------------------------------------------------------------ faults
    def fail(self) -> List[Request]:
        """Device failure: lose all state; return requests to re-route."""
        with self._lock:
            self.failed = True
            lost: List[Request] = []
            lost.extend(self.prefill_waiting)
            lost.extend(self.prefilling.values())  # ops queued or in flight
            lost.extend(self.decode_pending)
            lost.extend(self.active)
            lost.extend(self.stalled.values())     # awaiting their KV tail
            self.prefill_waiting, self.decode_pending, self.active = [], [], []
            # lost requests reset_for_retry below (token fields zeroed) —
            # the lazy bookkeeping dies with them (setter zeroed the sum)
            self._decode_join.clear()
            self._finish_step.clear()
            self._await_second = []
            self.prefilling = {}
            self.stalled, self._stall_start = {}, {}
            # cached prefix blocks died with the device: drop index + pins
            # (no on_delta refunds — the whole ledger is zeroed below)
            self.cache.clear()
            self.kv_used = 0
            self.kv_in_transit = 0
        self.daemon.fail(requeue_sink=lambda op: None)
        for r in lost:
            r.reset_for_retry()
        return lost


# ===========================================================================
# Cluster: deployment topologies, routing, KV transfer, fault injection
# ===========================================================================


@dataclasses.dataclass
class DeploymentSpec:
    """How instances are laid out (paper §4.3: 6P2D vs 3x128 co-location).

    The ``*_policy`` fields name control-plane policies from the
    ``repro_torch.sched`` registry; empty strings pick the mode's historical
    default, so v2 specs behave identically."""
    mode: str            # disagg | static_colocate | dynamic_pd | static_slice
    prefill_instances: int = 0       # disagg only
    prefill_chips: int = 0
    decode_instances: int = 0
    decode_chips: int = 0
    colocated_instances: int = 0     # co-location modes
    colocated_chips: int = 0
    decode_share: float = 0.5        # static_slice fixed ratio
    dynamic_cfg: Optional[DynamicPDConfig] = None
    # control plane (v3): registry names + knobs
    dispatch_policy: str = ""        # per-daemon phase picker
    dispatch_knobs: Dict = dataclasses.field(default_factory=dict)
    cluster_policy: str = ""         # routing / migration / role switching
    cluster_knobs: Dict = dataclasses.field(default_factory=dict)
    # admission (v5): registry name + knobs; "" keeps the mode's historical
    # default (gated for static_colocate, ungated otherwise).  Admission
    # policies can be STATEFUL (slo_aware's fairness counters), so the
    # cluster constructs a fresh instance per SimInstance.
    admission_policy: str = ""
    admission_knobs: Dict = dataclasses.field(default_factory=dict)
    # predictive scheduling (v9): learned models from the repro_torch.predict
    # registry, strictly opt-in — both empty ("") leaves every code path
    # bit-identical to v8.  The latency predictor is bootstrap-fitted from
    # the deployment's own cost model at build time unless its ``trace``
    # knob already fitted it from a profile artifact; the length predictor
    # learns online from completions.  ``adaptive_chunking`` retunes
    # ``chunk_prefill_tokens`` per prefill from predicted decode-slack and
    # requires a latency predictor.
    latency_predictor: str = ""
    latency_knobs: Dict = dataclasses.field(default_factory=dict)
    length_predictor: str = ""
    length_knobs: Dict = dataclasses.field(default_factory=dict)
    adaptive_chunking: bool = False
    chunk_knobs: Dict = dataclasses.field(default_factory=dict)

    @property
    def total_chips(self) -> int:
        return (self.prefill_instances * self.prefill_chips
                + self.decode_instances * self.decode_chips
                + self.colocated_instances * self.colocated_chips)


def deployment_6p2d(total: int = 384) -> DeploymentSpec:
    """The paper's static PD disaggregation baseline (Table 3)."""
    return DeploymentSpec(mode="disagg", prefill_instances=6,
                          prefill_chips=16, decode_instances=2,
                          decode_chips=144)


def deployment_dynamic(total: int = 384, instances: int = 3) -> DeploymentSpec:
    """The paper's FlexNPU deployment: 3 co-located instances x 128 NPUs."""
    return DeploymentSpec(mode="dynamic_pd", colocated_instances=instances,
                          colocated_chips=total // instances)


def deployment_role_switch(total: int = 384, **knobs) -> DeploymentSpec:
    """6P2D geometry under the dynamic role-switching control plane: same
    chips as the static baseline, but decode instances may temporarily
    flip to prefill under TTFT pressure (``knobs`` -> RoleSwitchConfig)."""
    return DeploymentSpec(mode="disagg", prefill_instances=6,
                          prefill_chips=16, decode_instances=2,
                          decode_chips=144, cluster_policy="role_switch",
                          cluster_knobs=dict(knobs))


class Cluster:
    def __init__(self, cfg: ModelConfig, deploy: DeploymentSpec,
                 sim_cfg: Optional[SimConfig] = None,
                 cost: Optional[CostModel] = None,
                 drive: str = "stepped", time_scale: float = 0.05):
        if drive not in ("stepped", "threaded"):
            raise ValueError(f"unknown drive {drive!r}")
        self.drive = drive
        self.cfg = cfg
        self.deploy = deploy
        self.cost = cost or CostModel(cfg)
        self.sim_cfg = sim_cfg or SimConfig()
        self.requests: List[Request] = []           # guarded-by: _lock
        self.prefill_pool: List[SimInstance] = []   # guarded-by: _lock
        self.decode_pool: List[SimInstance] = []    # guarded-by: _lock
        self.instances: List[SimInstance] = []
        # ONE serving-state lock shared by the cluster and every instance:
        # the threaded drive mutates state from daemon engine threads
        # (uncontended in the stepped drive)
        self._lock = threading.RLock()
        # KV transport subsystem: the topology resolves every (src, dst)
        # pair to a multi-hop segment path (flat = destination ingress
        # only, the v2 behavior), the path-aware LinkModel rates transfers
        # at the min per-segment processor share, and the KVStreamer
        # splits each request's KV into layer-wise chunks (0 = one blob)
        # each cluster owns a COPY of the configured topology: fail_spine
        # mutates routing state, and one SimConfig is routinely reused
        # across a sweep of clusters
        t = self.sim_cfg.topology
        self.topology = dataclasses.replace(
            t, bw_overrides=dict(t.bw_overrides),
            failed_spines=set(t.failed_spines)) if t is not None \
            else Topology.flat(bw=self.sim_cfg.transfer_bw)
        self.link_model = LinkModel(bw=self.sim_cfg.transfer_bw,
                                    latency_s=self.sim_cfg.transfer_latency_s,
                                    topology=self.topology)
        self.streamer = KVStreamer(
            self.cost.kv_bytes_per_token(),
            chunk_tokens=self.sim_cfg.kv_chunk_tokens,
            n_layers=max(1, cfg.num_attention_layers()))
        # Compute-contention model (execution queues, v4): one shared
        # LinkModel whose segments are per-device ("flops", name) keys with
        # capacity 1.0 work-unit/s — concurrent compute-queue ops on one
        # device split modeled FLOP throughput in proportion to their
        # compute shares.  Only built when devices actually expose >1
        # compute queue, so the default config's event stream (and thus
        # its outputs) is bit-identical to the single-slot engine model.
        self.compute_model: Optional[LinkModel] = None
        self.compute_driver: Optional[LinkDriver] = None
        self._compute_timer = None
        if self.sim_cfg.fidelity not in ("discrete", "fluid"):
            raise ValueError(f"unknown fidelity {self.sim_cfg.fidelity!r}")
        if self.sim_cfg.fidelity == "fluid" and drive != "stepped":
            raise ValueError("fluid fidelity requires the stepped drive")
        shared_flops = self.sim_cfg.compute_queues > 1
        if drive == "stepped":
            self.loop = EventLoop(
                legacy_defer=self.sim_cfg.legacy_event_loop)
            self.link_driver = LinkDriver(self.loop, self.link_model)
            if shared_flops:
                self.compute_model = LinkModel(bw=1.0, latency_s=0.0)
                self.compute_driver = LinkDriver(self.loop,
                                                 self.compute_model)
        else:
            from repro_torch.serving.realtime import (RealTimeLoop,
                                                calibrate_dispatch_overhead)
            from repro_torch.transport.drivers import ThreadedLinkTimer
            self.loop = RealTimeLoop(time_scale)
            self.link_driver = None
            overhead = calibrate_dispatch_overhead()
            self._link_timer = ThreadedLinkTimer(self.link_model,
                                                 self.loop.clock, time_scale,
                                                 sleep_overhead_s=overhead)
            if shared_flops:
                self.compute_model = LinkModel(bw=1.0, latency_s=0.0)
                self._compute_timer = ThreadedLinkTimer(
                    self.compute_model, self.loop.clock, time_scale,
                    sleep_overhead_s=overhead)
        # control plane (v3): the cluster policy owns routing, migration,
        # and role switching; built by registry name from the deployment
        for name, want in ((deploy.cluster_policy, "cluster"),
                           (deploy.dispatch_policy, "dispatch"),
                           (deploy.admission_policy, "admission")):
            if name and policy_kind(name) != want:
                raise ValueError(
                    f"policy {name!r} is a {policy_kind(name)} policy; "
                    f"expected a {want} policy here")
        self.policy: ClusterPolicy = make_policy(
            deploy.cluster_policy or "least_loaded", **deploy.cluster_knobs)
        self.policy.bind(self)
        # predictive scheduling (v9): cluster-owned learned models, built
        # by registry name and shared by every plane that can use them
        # (bound in _build; instances feed realized durations back through
        # predict_observe).  Strictly opt-in: both None by default.
        self.latency_model = make_predictor(
            deploy.latency_predictor, **deploy.latency_knobs) \
            if deploy.latency_predictor else None
        self.length_model = make_predictor(
            deploy.length_predictor, **deploy.length_knobs) \
            if deploy.length_predictor else None
        if deploy.adaptive_chunking and self.latency_model is None:
            raise ValueError(
                "adaptive_chunking requires a latency_predictor "
                "(the chunk adapter inverts its prefill model)")
        self.role_flips = 0                         # guarded-by: _lock
        self._tick_armed = False                    # guarded-by: _lock
        # transfer-id -> {"req", "src", "dst", "tokens", "remaining",
        # "dst_charged", "admitted", "aborted"} while a KV stream is in
        # flight (fault handling + per-chunk conservation checks).
        # Keyed by a UNIQUE id, not req_id: a re-routed request may start a
        # second stream while its aborted first one is still settling.
        self.inflight_transfers: Dict[int, Dict] = {}   # guarded-by: _lock
        self._transfer_ids = itertools.count(1)
        # closed-loop traffic sources attached by run(traffic=...): fed at
        # every terminal request transition through loop.defer
        self._sources: List = []                    # guarded-by: _lock
        # cross-instance prefix reuse telemetry (v6)
        self.prefix_fetches = 0                     # guarded-by: _lock
        self.prefix_fetch_fails = 0                 # guarded-by: _lock
        self.prefix_fetch_tokens = 0                # guarded-by: _lock
        with self._lock:
            self._build()
        self._prefix_on = any(i.cache.enabled for i in self.instances)

    # ----------------------------------------------------------- topology
    def _dispatch_policy(self):
        d = self.deploy
        if d.dispatch_policy:
            return make_policy(d.dispatch_policy, **d.dispatch_knobs)
        m = d.mode
        if m == "static_colocate":
            return FIFOPolicy()
        if m == "static_slice":
            return make_policy("static_slice", decode_share=d.decode_share)
        if m == "dynamic_pd":
            return DynamicPDPolicy(d.dynamic_cfg)
        return FIFOPolicy()   # disagg instances are single-phase anyway

    def _build(self):  # holds: _lock
        d = self.deploy
        # plan (name, spec, policy, sim_cfg, role) per device, then open ONE
        # multi-device session routing each instance to its own daemon
        plan = []
        if d.mode == "disagg":
            for i in range(d.prefill_instances):
                plan.append((f"P{i}", InstanceSpec(f"P{i}", d.prefill_chips),
                             self._dispatch_policy(), self.sim_cfg,
                             "prefill"))
            for i in range(d.decode_instances):
                plan.append((f"D{i}", InstanceSpec(f"D{i}", d.decode_chips),
                             self._dispatch_policy(), self.sim_cfg,
                             "decode"))
        else:
            gated = d.mode == "static_colocate"
            sim_cfg = dataclasses.replace(self.sim_cfg, admission_gated=gated)
            for i in range(d.colocated_instances):
                plan.append((f"C{i}", InstanceSpec(f"C{i}", d.colocated_chips),
                             self._dispatch_policy(), sim_cfg, "both"))
        policies = [p for _, _, p, _, _ in plan]
        # v9 bootstrap fit: a configured-but-unfitted latency model (no
        # ``trace`` knob) trains on the deployment's own analytic roofline
        # — a synthetic grid priced by the cost model per distinct
        # instance geometry.  Deterministic, and honest: the calibration
        # report still measures the LINEAR model against the full
        # (nonlinear) roofline surface.
        if self.latency_model is not None and not self.latency_model.fitted:
            phase_map = {"prefill": ("prefill",), "decode": ("decode",),
                         "both": ("prefill", "decode")}
            samples, seen = [], set()
            for _, spec, _, _, role in plan:
                key = (spec.chips, role)
                if key not in seen:
                    seen.add(key)
                    samples += cost_model_samples(self.cost, spec,
                                                  phase_map[role])
            self.latency_model.fit(samples)
        self._bind_predictors(self.policy)
        queue_spec = {"compute": max(1, self.sim_cfg.compute_queues),
                      "copy": max(1, self.sim_cfg.copy_queues)}
        if self.drive == "stepped":
            backend = SimBackend(self.loop.clock)
            self.session = connect(
                mode="sim", devices=len(plan), backend=backend,
                policy=lambda i: policies[i], queues=queue_spec)
        else:
            # threaded: real daemon dispatch threads paced by the scaled
            # wall clock (repro_torch.serving.realtime)
            from repro_torch.serving.realtime import RealTimeSimBackend
            backend = RealTimeSimBackend(self.loop.clock, self.loop.scale,
                                         link_timer=self._link_timer,
                                         compute_timer=self._compute_timer)
            self._backend = backend
            self.session = connect(
                mode="flex", devices=len(plan), backend=backend,
                policy=lambda i: policies[i], queues=queue_spec)
        for i, (name, spec, _, sim_cfg, role) in enumerate(plan):
            # admission (v5): a FRESH policy object per instance — stateful
            # policies (slo_aware fairness counters) must not be shared
            admission = make_policy(d.admission_policy,
                                    **d.admission_knobs) \
                if d.admission_policy else None
            inst = SimInstance(name, spec, self.cost, self.loop,
                               self.session.device(i), self.session.daemon(i),
                               sim_cfg, role=role, admission=admission,
                               lock=self._lock, drive=self.drive)
            # dispatch policies see link-queueing pressure (PolicyContext)
            self.session.daemon(i).link_stats_fn = self.link_model.stats
            # v9: predictor-aware planes get the cluster's models; the
            # instance grades the latency model on every realized op and
            # sizes prefill chunks from predicted decode-slack
            self._bind_predictors(policies[i], inst.admission)
            if self.latency_model is not None:
                inst.predict_observe = self.latency_model.observe
                if d.adaptive_chunking:
                    inst.chunk_adapter = ChunkAdapter(
                        self.latency_model,
                        base_tokens=sim_cfg.chunk_prefill_tokens,
                        **d.chunk_knobs)
            inst.link_driver = self.link_driver
            inst.compute_driver = self.compute_driver
            # terminal-transition hooks (v5): completions and rejections
            # flow back to the cluster so closed-loop traffic sources see
            # every ending, whatever instance it happened on
            inst.on_request_done = self._request_done
            inst.on_request_rejected = self._request_rejected
            if self.drive == "stepped":
                inst.on_cross_device = self._kick_all
            if d.mode == "disagg":
                # ANY disagg instance may hold the prefill role after a
                # role switch — every prefill completion routes through the
                # cluster's KV-transfer path
                inst.on_prefill_done = self._transfer_to_decode
            if role == "prefill":
                self.prefill_pool.append(inst)
            elif role == "decode":
                self.decode_pool.append(inst)
            else:
                self.instances.append(inst)
        if d.mode == "disagg":
            self.instances = self.prefill_pool + self.decode_pool
        else:
            self.prefill_pool = self.decode_pool = self.instances

    def _bind_predictors(self, *policies) -> None:
        """Hand the cluster's learned models to any policy that takes them
        (duck-typed ``bind_predictor(latency=..., length=...)``) — no-op
        when no predictor is configured or the policy has no hook."""
        if self.latency_model is None and self.length_model is None:
            return
        for p in policies:
            fn = getattr(p, "bind_predictor", None)
            if fn is not None:
                fn(latency=self.latency_model, length=self.length_model)

    # ------------------------------------------------------------ routing
    def _healthy(self, pool: List[SimInstance]) -> List[SimInstance]:
        return self.policy.healthy(pool)

    def _route_ctx(self, req: Request) -> RouteContext:  # holds: _lock
        """Per-request routing context (v6 ``route_prefill`` signature):
        the cluster probes every healthy prefill instance's prefix cache
        for its longest match so affinity policies can route reuse."""
        matches: Dict[str, int] = {}
        if self._prefix_on:
            hashes = request_block_hashes(
                req, max(1, self.sim_cfg.prefix_page_tokens))
            if hashes:
                for i in self.prefill_pool:
                    if not i.failed and i.cache.enabled:
                        matches[i.name] = i.cache.match_chain(hashes)
        tier: Dict[str, int] = {}
        if getattr(self.policy, "wants_tier_ctx", False):
            # tier-aware tiebreaks (v9): per-instance count of in-flight
            # interactive-tier requests.  Opt-in per policy class — the
            # scan is O(in-flight requests) per routing decision, so
            # load-only policies keep the O(instances) hot path.
            for i in self.prefill_pool:
                if i.failed:
                    continue
                tier[i.name] = sum(
                    1 for r in itertools.chain(
                        i.prefill_waiting, i.prefilling.values(),
                        i.active, i.decode_pending)
                    if r.priority >= INTERACTIVE_PRIORITY)
        return RouteContext(
            now=self.loop.clock.t,
            match_tokens=matches,
            loads={i.name: i.load() for i in self.prefill_pool
                   if not i.failed},
            page_tokens=self.sim_cfg.prefix_page_tokens
            if self._prefix_on else 0,
            cluster=self,
            tenant=req.tenant,
            priority=req.priority,
            tier_active=tier)

    def _route_prefill(self, req) -> Optional[SimInstance]:  # holds: _lock
        """All cluster prefill routing funnels through here: builds the
        RouteContext and calls the policy's v6+ three-argument hook
        directly (the v5 two-argument adapter was removed in v9)."""
        return self.policy.route_prefill(req, self.prefill_pool,
                                         self._route_ctx(req))

    def submit(self, req: Request) -> None:
        with self._lock:
            self.requests.append(req)
            inst = self._route_prefill(req)
            if inst is None:
                self._fail_request(req)
                return
            if self._maybe_prefix_fetch(req, inst):
                self._arm_tick()
                return      # parked at the cluster until the fetch lands
            inst.submit(req)
            self._arm_tick()

    # ------------------------------------------- terminal-state plumbing
    def _fail_request(self, req: Request) -> None:  # holds: _lock
        """The ONE place a cluster request ends FAILED: idempotent, and
        reported to traffic sources like any other terminal transition."""
        if req.state in TERMINAL_STATES:
            return
        req.state = RequestState.FAILED
        req.finish_time = self.loop.clock.t
        self._notify_sources(req)

    def _request_done(self, inst, req: Request) -> None:  # holds: _lock
        if self.length_model is not None:
            # v9 online learning: every completion scores the current
            # length prediction, then sharpens the (class, tenant) sketch
            self.length_model.observe(req.prompt_class, req.tenant,
                                      req.generated)
        self._notify_sources(req)

    def _request_rejected(self, inst, req: Request) -> None:  # holds: _lock
        self._notify_sources(req)

    def _notify_sources(self, req: Request) -> None:  # holds: _lock
        """Feed closed-loop traffic sources through the driver-loop defer
        hook: terminal transitions happen deep inside instance call stacks
        (and, threaded, on daemon engine threads) — the source callback
        must run after the event unwinds, on the loop."""
        if not self._sources:
            return
        self.loop.defer(lambda: self._feed_sources(req))

    def _feed_sources(self, req: Request) -> None:
        with self._lock:
            for src in self._sources:
                nxt = src.on_complete(req, self.loop.clock.t)
                if nxt is not None:
                    self.loop.at(nxt.arrival_time,
                                 lambda r=nxt: self.submit(r))

    # ------------------------------------------------- periodic policy tick
    def _arm_tick(self) -> None:  # holds: _lock
        iv = self.policy.tick_interval()
        if iv <= 0 or self._tick_armed:
            return
        self._tick_armed = True
        self.loop.after(iv, self._tick)

    def _tick(self) -> None:
        with self._lock:
            self._tick_armed = False
            self.policy.on_tick(self.loop.clock.t)
            if self._outstanding():
                self._arm_tick()   # re-arm only while work remains, so the
                #                    stepped event loop can still drain

    def _kick_all(self) -> None:  # holds: _lock
        """A cross-device edge resolved (shared record / peer copy done):
        sibling daemons may have unblocked stream heads."""
        for inst in self.instances:
            inst.kick()

    def _transfer_to_decode(self, src: SimInstance, req: Request,
                            tokens: Optional[int] = None) -> None:
        """Stream a request's KV to a decode instance through the source's
        copy-engine stream.  Two callers: prefill completion (``tokens`` =
        the prompt, as in v2) and decode-drain **migration** during a role
        switch (``tokens`` = prompt + generated so far).

        The KV moves as layer-wise chunks (``KVStreamer``; one blob when
        ``kv_chunk_tokens=0``), each a real daemon op on the copy engine
        timed by the path-aware LinkModel: every chunk occupies the full
        ``Topology``-resolved path (source egress -> spine -> destination
        ingress) and contends with any transfer sharing ANY segment.  The
        destination admits the request for decode as soon as the FIRST
        chunk lands; the tail streams in underneath the early decode
        steps.

        KV conservation, now per chunk: the source keeps each chunk's
        pages charged (``kv_in_transit``) until that chunk lands; only
        then does the source free them and the destination charge its
        own — ``check_kv_conservation`` holds at every mid-stream point."""
        with self._lock:
            if tokens is None:
                tokens = req.prompt_len
            if src.failed:
                # a failed source's ledgers are zeroed — charging a stream
                # against them would leak kv_in_transit forever; the
                # request's pages died with the instance, so restart it
                self._reroute(req)
                return
            if src.role == "decode":
                # the source flipped back to decode while this prefill was
                # in flight: keep the KV where it is — no transfer
                self._admit_local(src, req)
                return
            req.state = RequestState.TRANSFER
            dst = self.policy.route_decode(req, src, self.decode_pool)
            if dst is None:
                src.kv_used -= tokens
                self._fail_request(req)
                return
            if dst is src:
                self._admit_local(src, req)
                return
            path = self.topology.path(src.name, dst.name)
            if any(s in self.link_model.failed_segments for s in path):
                # the only route crosses a severed segment (every spine
                # plane failed): KV cannot reach any decode instance —
                # fail honestly instead of "delivering" over dead fabric
                src.kv_used -= tokens
                self._fail_request(req)
                return
            src.kv_in_transit += tokens
            xid = next(self._transfer_ids)
            self.inflight_transfers[xid] = {
                "req": req, "src": src, "dst": dst, "tokens": tokens,
                "remaining": tokens,   # token-equivalents not yet landed
                "dst_charged": 0,      # token-equivalents charged at dst
                "admitted": False,     # decode admission (first chunk)
                "aborted": False, "path": path}
            req.kv_stream_pending = True
            self.streamer.stream(
                src.client, dst.daemon, tokens, path=path,
                vstream=src.stream_c, meta={"req_id": req.req_id},
                on_chunk=lambda i, ctoks, last, f, x=xid:
                    self._chunk_done(x, ctoks, last, f))
            src.kick()

    def _admit_local(self, inst, req: Request) -> None:  # holds: _lock
        """Admit for decode on the instance that already holds the KV
        (prefill finished on an instance that now serves decode).  The
        prompt pages are charged since enqueue; only the generated tokens
        (the first token emitted at prefill end) still need accounting."""
        inst.kv_used += req.generated
        inst.admit_decode(req, charge_kv=False)

    def _chunk_done(self, xid: int, ctoks: int, last: bool, fut) -> None:
        """One KV chunk's copy op settled.  Source pages for THIS chunk are
        freed (whatever happens next — the copy either landed or the
        request is being re-routed), the destination charges them if the
        chunk landed, and the request is admitted for decode on the first
        landed chunk / finalized on the last."""
        with self._lock:
            entry = self.inflight_transfers.get(xid)
            if entry is None:
                return                   # source failed: registry entry
                #                          dropped, accounting zeroed
            req, src, dst = entry["req"], entry["src"], entry["dst"]
            entry["remaining"] -= ctoks
            if not src.failed:
                # free the source copy of this chunk only now that it is
                # settled; freed pages may admit parked prefills — the
                # capacity win of streaming over one-blob transfers
                src.kv_in_transit -= ctoks
                src.kv_used -= ctoks
                assert src.kv_used >= 0 and src.kv_in_transit >= 0, \
                    (src.name, src.kv_used, src.kv_in_transit)
                src._retry_parked()
            failed_chunk = False
            try:
                fut.result()
            except Exception:
                failed_chunk = True      # chunk errored on the device
            if any(s in self.link_model.failed_segments
                   for s in entry["path"]):
                # the op drained over a severed segment (fail_spine tears
                # flows down so copy engines never wedge) — the bytes were
                # LOST, not delivered; never charge the destination
                failed_chunk = True
            if last:
                self.inflight_transfers.pop(xid, None)
            if entry["aborted"]:
                return                   # fault handling already re-routed it
            if failed_chunk or dst.failed:
                # destination lost mid-stream: nothing more arrives.  Undo
                # any partial landing (a failed dst zeroed its own ledger)
                # and restart the request from prefill.
                entry["aborted"] = True
                if not dst.failed:
                    self._evict_partial(entry)
                self._reroute(req)
                return
            # chunk landed: the destination now holds these pages
            dst.kv_used += ctoks
            entry["dst_charged"] += ctoks
            if not entry["admitted"] and dst.role in ("decode", "both"):
                # first landed chunk (or dst flipped back to decode
                # mid-stream): begin decode under the incoming tail.  The
                # transfer was sized at issue time — charge the tokens
                # generated since (prefill's first token / none for a
                # role-switch migration).
                entry["admitted"] = True
                dst.kv_used += req.prompt_len + req.generated \
                    - entry["tokens"]
                dst.admit_decode(req, charge_kv=False)
            if last:
                req.kv_stream_pending = False
                if entry["admitted"]:
                    dst.finish_stalled(req)   # retire if decode outran us
                else:
                    # dst flipped to prefill while the KV was in flight:
                    # the full copy DID land (pages charged here via the
                    # chunks) — top up to current size and migrate onward
                    dst.kv_used += req.prompt_len + req.generated \
                        - entry["tokens"]
                    self._transfer_to_decode(dst, req,
                                             tokens=req.total_tokens)

    def _evict_partial(self, entry: Dict) -> None:  # holds: _lock
        """Refund a live destination for a stream that died mid-flight:
        every page charged there for this request (landed chunks, the
        admission top-up, decode appends) comes back off its ledger, and
        the request leaves its decode queues."""
        req, dst = entry["req"], entry["dst"]
        if entry["admitted"]:
            # remove first: it materializes the lazily-advanced token count
            # the refund below reads (req was actively decoding at dst)
            dst.remove_request(req)
            # charged so far: dst_charged + (prompt + gen_admit - tokens)
            # + decode appends = dst_charged - tokens + total_tokens
            dst.kv_used -= (entry["dst_charged"] - entry["tokens"]
                            + req.total_tokens)
        else:
            dst.kv_used -= entry["dst_charged"]
        assert dst.kv_used >= 0, (dst.name, dst.kv_used)
        req.kv_stream_pending = False

    def _reroute(self, req: Request) -> None:
        with self._lock:
            req.reset_for_retry()
            inst = self._route_prefill(req)
            if inst is not None:
                inst.submit(req)
            else:
                self._fail_request(req)

    # ------------------------------------------------- remote prefix fetch
    def _maybe_prefix_fetch(self, req, dst) -> bool:  # holds: _lock
        """Cross-instance prefix reuse (v6): if a PEER instance caches a
        strictly longer prefix of this prompt than the routed destination
        and the cost model says copying those blocks over the KV path
        beats recomputing them, stream them to the destination first.

        The request parks at the cluster (state QUEUED, no instance) until
        the fetch settles; fetched blocks are COPIES — the source keeps
        its cache entries (pinned against eviction for the flight) and
        stages the outgoing chunks in a send buffer charged to its ledger,
        so ``check_kv_conservation`` holds at every mid-fetch point.  Any
        failure (chunk error, severed path, either endpoint dying) falls
        back to plain local recompute — reuse is an optimization, never a
        correctness dependency."""
        if not (self._prefix_on and self.sim_cfg.remote_prefix_fetch):
            return False
        if dst.failed or not dst.cache.enabled:
            return False
        page = max(1, self.sim_cfg.prefix_page_tokens)
        hashes = request_block_hashes(req, page)
        if not hashes:
            return False
        local = dst.cache.match_chain(hashes)
        best, src = local, None
        for inst in self.instances:
            if inst is dst or inst.failed or not inst.cache.enabled:
                continue
            m = inst.cache.match_chain(hashes)
            if m > best:
                best, src = m, inst
        delta = best - local
        if src is None or delta < page:
            return False
        # benefit in recompute-skippable tokens (at least one prompt token
        # must always prefill to emit the first token)
        usable = max(0, req.prompt_len - 1)
        benefit = min(best, usable) - min(local, usable)
        if benefit <= 0:
            return False
        t_copy = self.cost.transfer_time(
            delta, bw=self.sim_cfg.transfer_bw,
            latency_s=self.sim_cfg.transfer_latency_s)
        t_recompute = self.cost.prefill_time(dst.spec, benefit, context=best)
        if t_copy >= t_recompute:
            return False
        path = self.topology.path(src.name, dst.name)
        if any(s in self.link_model.failed_segments for s in path):
            return False
        chain = hashes[:best // page]
        start = local // page
        if not src.cache.pin_chain(chain[start:]):
            return False     # raced with an eviction — recompute locally
        # stage the outgoing copy: send-buffer pages charged at the source
        # for the flight, freed chunk-by-chunk as each lands (the same
        # per-chunk ledger arithmetic as prefill->decode transfers)
        src.kv_used += delta
        src.kv_in_transit += delta
        xid = next(self._transfer_ids)
        self.inflight_transfers[xid] = {
            "kind": "prefix_fetch", "req": req, "src": src, "dst": dst,
            "tokens": delta, "remaining": delta, "chain": chain,
            "start": start, "aborted": False, "path": path}
        self.prefix_fetches += 1
        self.streamer.stream(
            src.client, dst.daemon, delta, path=path, vstream=src.stream_c,
            meta={"req_id": req.req_id, "prefix_fetch": True},
            on_chunk=lambda i, ctoks, last, f, x=xid:
                self._prefix_chunk_done(x, ctoks, last, f))
        src.kick()
        return True

    def _prefix_chunk_done(self, xid: int, ctoks: int, last: bool,
                           fut) -> None:
        """One prefix-fetch chunk settled: free the source's send-buffer
        share, and on the LAST chunk unpin the source blocks, graft the
        fetched chain into the destination cache, and deliver the parked
        request (or fall back to recompute if anything went wrong)."""
        with self._lock:
            entry = self.inflight_transfers.get(xid)
            if entry is None:
                return           # source failed: entry dropped, request
                #                  already resubmitted for local recompute
            req, src, dst = entry["req"], entry["src"], entry["dst"]
            entry["remaining"] -= ctoks
            if not src.failed:
                src.kv_in_transit -= ctoks
                src.kv_used -= ctoks      # send-buffer share of this chunk
                assert src.kv_used >= 0 and src.kv_in_transit >= 0, \
                    (src.name, src.kv_used, src.kv_in_transit)
                src._retry_parked()
            failed_chunk = False
            try:
                fut.result()
            except Exception:
                failed_chunk = True
            if any(s in self.link_model.failed_segments
                   for s in entry["path"]):
                failed_chunk = True
            if last:
                self.inflight_transfers.pop(xid, None)
                if not src.failed:
                    src.cache.unpin_chain(entry["chain"][entry["start"]:])
            if entry["aborted"]:
                return           # fault handling already resubmitted it
            if failed_chunk or dst.failed:
                entry["aborted"] = True
                self.prefix_fetch_fails += 1
                if not dst.failed:
                    self._submit_after_fetch(req, dst)
                else:
                    # destination died before _fail_instance_locked saw
                    # this entry — resubmit through fresh routing
                    self._submit_after_fetch(req, None)
                return
            self.prefix_fetch_tokens += ctoks
            if last:
                # graft the fetched chain into the destination's cache;
                # have_from skips blocks it already held, and a mid-fetch
                # eviction of the local head orphans the tail harmlessly
                # (insert_chain skips orphans — the request just recomputes
                # more than hoped)
                dst.cache.insert_chain(entry["chain"], self.loop.clock.t,
                                       have_from=entry["start"])
                self._submit_after_fetch(req, dst)

    def _submit_after_fetch(self, req, dst) -> None:  # holds: _lock
        """Deliver a cluster-parked request after its prefix fetch settled
        (or failed): to the fetch destination if it still serves prefill,
        else through fresh routing.  Never starts another fetch."""
        if req.state in TERMINAL_STATES:
            return
        if dst is not None and not dst.failed \
                and dst.role in ("prefill", "both"):
            dst.submit(req)
        else:
            inst = self._route_prefill(req)
            if inst is None:
                self._fail_request(req)
                return
            inst.submit(req)
        self._arm_tick()

    # ------------------------------------------------------ role switching
    def switch_role(self, inst, new_role: str) -> bool:
        """Dynamically flip a disaggregated instance between the prefill
        and decode roles (ClusterPolicy's rebalancing verb).

        decode -> prefill: the instance stops decoding; every queued/active
        decode request drains to the remaining decode pool over the
        copy-engine KV path (pages stay charged at the source until each
        copy lands — ``check_kv_conservation`` holds THROUGH the flip).

        prefill -> decode: not-yet-admitted prefills re-route to the
        prefill pool; in-flight prefills finish and their KV stays local
        (no transfer) since the instance now serves decode itself."""
        with self._lock:
            if isinstance(inst, str):
                inst = next(i for i in self.instances if i.name == inst)
            if (inst.failed or inst.role == new_role or inst.role == "both"
                    or new_role not in ("prefill", "decode")):
                return False
            if new_role == "prefill":
                if inst in self.decode_pool:
                    self.decode_pool.remove(inst)
                inst.role = "prefill"
                if inst not in self.prefill_pool:
                    self.prefill_pool.append(inst)
                for req in inst.drain_decode():
                    self._transfer_to_decode(inst, req,
                                             tokens=req.total_tokens)
                # spread router-visible prefill backlog onto the borrowed
                # capacity (work already on a daemon queue cannot move)
                self._rebalance_prefill_queues()
            else:
                if inst in self.prefill_pool:
                    self.prefill_pool.remove(inst)
                inst.role = "decode"
                if inst not in self.decode_pool:
                    self.decode_pool.append(inst)
                # hand unstarted prefills back to the router; in-flight ones
                # finish here and _transfer_to_decode admits them locally
                waiting, inst.prefill_waiting = inst.prefill_waiting, []
                for r in waiting:
                    target = self._route_prefill(r)
                    if target is not None:
                        target.submit(r)
                    else:
                        self._fail_request(r)
            self.role_flips += 1
            return True

    def _rebalance_prefill_queues(self) -> None:  # holds: _lock
        """Re-route every not-yet-admitted prefill through the cluster
        policy (arrival order preserved).  Cheap: waiting requests hold no
        KV and no daemon state, so moving them is pure routing."""
        with self._lock:
            waiting: List[Request] = []
            for i in self.prefill_pool:
                if i.failed or not i.prefill_waiting:
                    continue
                moved, i.prefill_waiting = i.prefill_waiting, []
                waiting.extend(moved)
            waiting.sort(key=lambda r: r.arrival_time)
            for r in waiting:
                target = self._route_prefill(r)
                if target is not None:
                    target.submit(r)
                else:
                    self._fail_request(r)

    # -------------------------------------------------------------- runs
    def _outstanding(self) -> bool:
        with self._lock:
            # a closed-loop source in a think-time gap has zero in-flight
            # requests but more coming — the run is not quiescent until
            # every source is exhausted too
            return bool(self.inflight_transfers) or any(
                r.state not in TERMINAL_STATES for r in self.requests) \
                or any(not s.exhausted() for s in self._sources)

    def run(self, workload: Optional[List[Request]] = None,
            until: float = math.inf, traffic=None) -> Dict:
        """Drive the cluster with an open-loop trace (``workload``), one
        or more closed-loop traffic sources (``traffic``: an object or
        list of objects with ``initial()`` / ``on_complete(req, now)`` /
        ``exhausted()`` — e.g. :class:`repro_torch.traffic.ClosedLoopPool`), or
        both.

        With ``sim_cfg.fidelity="fluid"`` the run is handed to the coarse
        fluid-approximation engine (:mod:`repro_torch.serving.fluid`): queue
        drain rates are integrated between decision points instead of
        simulating every daemon op.  The result dict is clearly labeled
        (``fidelity="fluid"``, ``approximate=True``) — use it for
        capacity planning, not latency-tail or policy-behavior claims."""
        if self.sim_cfg.fidelity == "fluid":
            from repro_torch.serving.fluid import fluid_run
            return fluid_run(self, workload=workload, until=until,
                             traffic=traffic)
        with self._lock:
            # the threaded drive's daemon engine threads are already live
            # here: attach sources and schedule arrivals under the same
            # lock every terminal-transition path takes
            if traffic is not None:
                self._sources = list(traffic) if isinstance(
                    traffic, (list, tuple)) else [traffic]
            for req in (workload or []):
                self.loop.at(req.arrival_time, lambda r=req: self.submit(r))
            for src in self._sources:
                for req in src.initial():
                    self.loop.at(req.arrival_time,
                                 lambda r=req: self.submit(r))
        if self.drive == "threaded":
            self.loop.run(until=until, idle=lambda: not self._outstanding())
            self.close()   # stop daemon dispatch threads (leak-free)
        else:
            self.loop.run(until=until)
        for inst in self.instances:
            inst.sync_token_state()   # runs cut off mid-decode by `until`
        from repro_torch.serving.request import summarize
        with self._lock:
            out = summarize(self.requests)
            out["chips"] = self.deploy.total_chips
            out["mode"] = self.deploy.mode
            out["drive"] = self.drive
            retries = sum(r.retries for r in self.requests)
            if retries:
                out["retries"] = retries
            # honest shedding telemetry (v5): the instances' rejection
            # counters must agree with the REJECTED request states
            # summarize() counted — a policy cannot drop work without it
            # showing up here
            shed = sum(i.rejected for i in self.instances)
            if shed or self.deploy.admission_policy:
                out["shed_requests"] = shed
            if self.link_model.completed:
                out.update(self.link_model.stats())
                out["topology"] = self.topology.name
                out["kv_chunk_tokens"] = self.sim_cfg.kv_chunk_tokens
                # decode stalls: requests that finished decoding before
                # their KV tail landed (cost of streaming too coarsely)
                out["decode_stall_s"] = round(
                    sum(i.decode_stall_s for i in self.instances), 6)
                out["decode_stalls"] = sum(i.stalls for i in self.instances)
            if self.sim_cfg.compute_queues > 1 \
                    or self.sim_cfg.copy_queues > 1 \
                    or self.sim_cfg.chunk_prefill_tokens:
                out["queues"] = {
                    "compute": max(1, self.sim_cfg.compute_queues),
                    "copy": max(1, self.sim_cfg.copy_queues),
                    "chunk_prefill_tokens":
                        self.sim_cfg.chunk_prefill_tokens}
            if self.drive == "threaded":
                # per-op dispatch-overhead calibration (measured at backend
                # startup, folded into the wall-clock pacing) — recorded so
                # BENCH artifacts show how faithful the threaded timing was
                out["calibration"] = self._backend.calibration()
            if self._prefix_on:
                out["prefix_cache"] = self.prefix_cache_telemetry()
            if self.latency_model is not None \
                    or self.length_model is not None:
                out["prediction"] = self.prediction_telemetry()
            out["policy"] = self.policy_telemetry()
            return out

    def prediction_telemetry(self) -> Dict:  # holds: _lock
        """Honest v9 prediction accounting: per-model calibration + online
        error (MAPE, p90, over/under counts) and the scheduling decisions
        the models actually drove — including the ones the learned model
        OVERTURNED relative to the analytic estimate, the misprediction
        cost a reader should weigh against the p95 win."""
        out: Dict = {}
        if self.latency_model is not None:
            out["latency"] = self.latency_model.report()
        if self.length_model is not None:
            out["length"] = self.length_model.report()
        decisions: Dict[str, float] = {}
        polled = [self.policy] + [i.admission for i in self.instances] \
            + [i.daemon.policy for i in self.instances]
        seen = set()
        for p in polled:
            if id(p) in seen:
                continue
            seen.add(id(p))
            for k in ("reordered", "starvation_picks", "overturned",
                      "bound_exceeded", "tpot_deferrals"):
                v = getattr(p, k, None)
                if v is not None:
                    decisions[k] = decisions.get(k, 0.0) + float(v)
        adapters = [i.chunk_adapter for i in self.instances
                    if i.chunk_adapter is not None]
        for a in adapters:
            for k, v in a.debug_state().items():
                if k in ("chunk_decisions", "chunk_adapted"):
                    decisions[k] = decisions.get(k, 0.0) + float(v)
        if decisions:
            out["decisions"] = decisions
        return out

    def prefix_cache_telemetry(self) -> Dict:  # holds: _lock
        """Prefix-reuse observability (v6): aggregate hit rate, recompute
        FLOPs avoided, and cross-instance fetch traffic, plus the raw
        per-instance cache stats — folded into ``run`` results so
        BENCH_*.json artifacts record reuse behavior."""
        per_inst = {i.name: i.cache.stats() for i in self.instances
                    if i.cache.enabled}
        matched = sum(s["matched_tokens"] for s in per_inst.values())
        prompts = sum(s["prompt_tokens"] for s in per_inst.values())
        return {
            "policy": self.sim_cfg.prefix_cache,
            "page_tokens": self.sim_cfg.prefix_page_tokens,
            "matched_tokens": matched,
            "prompt_tokens": prompts,
            "hit_rate": round(matched / prompts, 6) if prompts else 0.0,
            "flops_saved": sum(i.prefix_flops_saved for i in self.instances),
            "inserts": sum(s["inserts"] for s in per_inst.values()),
            "evictions": sum(s["evictions"] for s in per_inst.values()),
            "remote_fetches": self.prefix_fetches,
            "remote_fetch_fails": self.prefix_fetch_fails,
            "remote_fetch_tokens": self.prefix_fetch_tokens,
            "remote_fetch_bytes": round(
                self.prefix_fetch_tokens * self.cost.kv_bytes_per_token(),
                3),
            "per_instance": per_inst,
        }

    def close(self) -> None:
        """Stop daemon threads (threaded drive); idempotent."""
        self.session.close()

    def policy_telemetry(self) -> Dict:  # holds: _lock
        """Control-plane observability: per-daemon dispatch debug state
        (realized decode share, targets), cluster-policy state (role flips,
        pressure), current roles, and queue depths.  Folded into ``run``
        results so BENCH_*.json artifacts record policy *behavior*."""
        dispatch = {}
        for inst in self.instances:
            st = inst.daemon.policy.debug_state()
            if st:
                dispatch[inst.name] = {k: round(float(v), 6)
                                       for k, v in st.items()}
        admission = {}
        for inst in self.instances:
            st = inst.admission.debug_state()
            if st or inst.rejected:
                admission[inst.name] = {
                    "policy": type(inst.admission).__name__,
                    "rejected": inst.rejected,
                    **{k: round(float(v), 6) for k, v in st.items()}}
        return {
            **({"admission": admission} if admission else {}),
            "cluster_policy": type(self.policy).__name__,
            "cluster": self.policy.debug_state(),
            "role_flips": self.role_flips,
            "roles": {i.name: i.role for i in self.instances},
            "dispatch": dispatch,
            "queue_depths": {
                i.name: {"prefill_ops": i.daemon.backlog(Phase.PREFILL),
                         "decode_ops": i.daemon.backlog(Phase.DECODE),
                         "waiting": len(i.prefill_waiting),
                         "decode_pending": len(i.decode_pending),
                         "active": len(i.active),
                         "stalled": len(i.stalled)}
                for i in self.instances},
        }

    def check_kv_conservation(self) -> None:
        """Invariant: KV pages are never double-freed or dropped while a
        stream is in flight — at CHUNK granularity: a source's
        ``kv_in_transit`` equals the not-yet-landed remainder of its
        streams, so the check holds at every mid-stream point, including
        migrations during a role switch and fault re-routing."""
        with self._lock:
            by_src: Dict[str, int] = {}
            for entry in self.inflight_transfers.values():
                # aborted entries (dst died) still hold source pages until
                # each remaining chunk op completes and settles them
                by_src[entry["src"].name] = \
                    by_src.get(entry["src"].name, 0) + entry["remaining"]
            for inst in self.instances:
                assert inst.kv_used >= 0, (inst.name, inst.kv_used)
                assert inst.kv_in_transit >= 0, (inst.name,
                                                 inst.kv_in_transit)
                assert inst.kv_used >= inst.kv_in_transit or inst.failed, \
                    (inst.name, inst.kv_used, inst.kv_in_transit)
                if not inst.failed:
                    assert inst.kv_in_transit == by_src.get(inst.name, 0), \
                        (inst.name, inst.kv_in_transit,
                         by_src.get(inst.name, 0))

    # ------------------------------------------------------------- faults
    def fail_instance(self, name: str) -> int:
        """Kill an instance; its requests restart elsewhere (prefill redone).

        KV transfers touching the dead instance are resolved WITHOUT double
        frees: source-side transfers died with their daemon (futures never
        resolve — drop the registry entry); destination-side transfers keep
        their entry so the still-running source op settles its own KV
        accounting, but the request is re-routed immediately."""
        with self._lock:
            return self._fail_instance_locked(name)

    def _fail_instance_locked(self, name: str) -> int:  # holds: _lock
        inst = next(i for i in self.instances if i.name == name)
        lost = inst.fail()
        n_lost = len(lost)
        for xid, entry in list(self.inflight_transfers.items()):
            if entry.get("kind") == "prefix_fetch":
                # prefix fetches never hold request KV — the request is
                # parked at the cluster and the blocks are copies — so the
                # only cleanup is resubmitting the parked request for
                # local recompute (and, source-side, dropping the entry:
                # its chunk futures died with the daemon and fail()
                # zeroed the send-buffer accounting + cache pins)
                if entry["src"] is inst:
                    del self.inflight_transfers[xid]
                    if not entry["aborted"]:
                        entry["aborted"] = True
                        self.prefix_fetch_fails += 1
                        self._submit_after_fetch(entry["req"], entry["dst"])
                        n_lost += 1
                elif entry["dst"] is inst and not entry["aborted"]:
                    # source chunks keep settling their send buffer as
                    # each op completes; the fetched copy died with the
                    # destination — reroute the parked request now
                    entry["aborted"] = True
                    self.prefix_fetch_fails += 1
                    self._submit_after_fetch(entry["req"], None)
                    n_lost += 1
                continue
            if entry["src"] is inst:
                # the remaining chunk ops were drained with the daemon: no
                # completion callbacks will fire, and fail() zeroed the
                # source accounting.  Chunks that already LANDED charged
                # the destination (and may have admitted the request for
                # decode) — evict that partial state before re-routing.
                # An already-aborted entry (its DESTINATION died first)
                # was re-routed then — don't resubmit a second time.
                del self.inflight_transfers[xid]
                if not entry["aborted"]:
                    if not entry["dst"].failed:
                        self._evict_partial(entry)
                    self._reroute(entry["req"])
                    n_lost += 1
            elif entry["dst"] is inst and not entry["aborted"]:
                entry["aborted"] = True   # source chunks settle their KV
                #                           later as each op completes
                if entry["admitted"]:
                    # the request was decoding at the dead destination: it
                    # is in `lost` (fail() drained the decode queues) and
                    # the loop below re-routes it — don't do it twice
                    continue
                self._reroute(entry["req"])
                n_lost += 1
        for r in lost:
            target = self._route_prefill(r)
            if target is not None:
                target.submit(r)
            else:
                self._fail_request(r)
        return n_lost

    def fail_spine(self, index: int = 0) -> int:
        """Sever one spine plane mid-run.  In-flight streams crossing it
        lose their remaining bytes: the chunk ops drain immediately (the
        copy engines never wedge behind a dead link), each affected
        request's partial landing is evicted from its destination, and the
        request restarts from prefill.  NEW transfers stripe over the
        surviving planes (``Topology.fail_spine``); with NO surviving
        plane, transfers fail honestly (requests end FAILED) rather than
        "delivering" KV over dead fabric.  Returns the number of
        re-routed requests; ``check_kv_conservation`` holds throughout."""
        with self._lock:
            self.topology.fail_spine(index)
            seg = ("spine", index)
            n = 0
            for entry in self.inflight_transfers.values():
                if seg not in entry.get("path", ()) or entry["aborted"]:
                    continue
                entry["aborted"] = True
                if entry.get("kind") == "prefix_fetch":
                    # nothing landed at the destination to evict (the
                    # chain grafts only on the LAST chunk) — the parked
                    # request falls back to local recompute
                    self.prefix_fetch_fails += 1
                    self._submit_after_fetch(entry["req"], entry["dst"])
                    n += 1
                    continue
                if not entry["dst"].failed:
                    self._evict_partial(entry)
                self._reroute(entry["req"])
                n += 1
            if self.link_driver is not None:
                self.link_model.fail_segment(seg, self.loop.clock.t)
                self.link_driver.repoll()   # torn-down transfers drain now
            else:
                # threaded: the copy-engine threads mutate the model under
                # the ThreadedLinkTimer's lock — sever it under that lock
                self._link_timer.fail_segment(seg, self.loop.clock.t)
            return n

    def slow_instance(self, name: str, factor: float) -> None:
        # threaded drive: op_duration reads slow_factor from daemon engine
        # threads — publish the straggler injection under the shared lock
        with self._lock:
            inst = next(i for i in self.instances if i.name == name)
            inst.slow_factor = factor

    def utilization(self) -> Dict[str, float]:
        return {i.name: i.daemon.profiler.device_utilization(self.loop.clock.t)
                for i in self.instances}

"""Real-execution serving engine (PyTorch on one CUDA card, or the CPU).

Continuous batching over slot-structured dense KV caches.  ALL device work is
issued through the session-based v2 ``RuntimeAPI`` verbs: the engine opens a
``repro_torch.core.connect(...)`` session and speaks only to its device-scoped
clients — it is byte-identical under ``mode="passthrough"`` (paper's native
passthrough) and the interposed FlexDaemon modes, which is the transparency
claim of the paper made concrete.

Modes:
  * ``passthrough``     — direct execution (Table 1 baseline).
  * ``static_colocate`` — one FIFO queue, prefill admission gated on a free
                          decode slot (head-of-line blocking; Table 4 baseline).
  * ``dynamic_pd``      — FlexNPU: prefill and decode as separate logical
                          instances over one daemon with DynamicPDPolicy.
  * ``disagg``          — static PD disaggregation over a 2-device pair:
                          prefill on one device, decode on the other, and
                          the KV cache moved between them by ``memcpy_peer``
                          on the copy-engine stream, ordered by a
                          cross-device (shared) event — the real-execution
                          analogue of the cluster simulator's disagg
                          deployments.

Data parallelism (v4): the engine is **multi-device** — ``replicas=R``
opens ONE session spanning R replicas (R devices, or R prefill/decode
device pairs under disagg), each with its own slot cache and decode batch.
Requests are routed to replicas by a :class:`~repro_torch.sched.ClusterPolicy`
from the v3 registry (``cluster_policy="least_loaded"`` by default), so
the same routing layer fronts the real engine and the cluster simulator.
``replicas=1`` (the default) is the v3 single-device engine, byte-for-byte.

Execution queues (v4): each device exposes ``compute_queues`` compute
queues (plus a copy queue).  With more than one, decode is PINNED to the
highest-index compute queue and prefill launches round-robin over streams
bound to the remaining queues — prefills of different requests overlap
each other and never block decode.  Real-model prompt chunking is not
micro-batched here (the dense prefill writes its KV from position 0, so a
prompt is one launch — per-request outputs stay byte-identical); the
cluster simulator's ``chunk_prefill_tokens`` models intra-request
micro-batching.

Prefill and decode each run on their own virtual stream; the daemon
enforces per-stream FIFO order while the phase policy arbitrates between
the stream heads (stream-ordered dispatch, daemon v2).

The port of ``repro/serving/engine.py``: the model runs eagerly (no
``jax.jit``), slot inserts are indexed copies, argmax runs on the device,
and the disagg path packs the KV cache through a ``uint8`` view (torch's
bfloat16 has no numpy dtype).  Decode updates the slot cache in place,
which the no-insert-while-decoding rule of ``_fill_slots_locked`` makes
safe.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import spans as _spans
from repro_torch.core.api import Phase
from repro_torch.core.session import connect
# The engine consumes the sched policy plane by design; the layering rank
# exists to ban the reverse direction (sched importing serving).
# flexlint: ignore[layering] -- serving -> sched policy-plane use is the API
from repro_torch.sched import (AdmissionPolicy, AdmissionView, ClusterPolicy,
                         DynamicPDConfig, DynamicPDPolicy, FIFOPolicy,
                         GatedAdmission, RouteContext, UngatedAdmission,
                         make_policy, policy_kind)
from repro_torch.device import require_device
from repro_torch.models.model import Model
from repro_torch.serving.request import Request, RequestState, summarize


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _pack_cache(cache):
    """Flatten a KV cache (a list of per-pattern dicts) into one contiguous
    byte blob (+ recipe).  Pack order is fixed: list entries (layers) in
    order, then each dict's keys sorted — ``jax.tree.flatten``'s order, so
    the layer-chunk bounds match the JAX engine's."""
    keys = [sorted(layer) for layer in cache]
    leaves = [cache[i][k] for i, ks in enumerate(keys) for k in ks]
    spec = [(tuple(t.shape), t.dtype) for t in leaves]
    parts = [t.contiguous().view(torch.uint8).reshape(-1).cpu().numpy()
             for t in leaves]
    blob = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return blob, keys, spec


def _unpack_cache(blob, keys, spec, device):
    buf = np.frombuffer(bytes(blob) if not isinstance(blob, (bytes, bytearray))
                        else blob, np.uint8)
    leaves, off = [], 0
    for shape, dtype in spec:
        n = _nbytes(shape, dtype)
        raw = torch.from_numpy(buf[off:off + n].copy())
        leaves.append(raw.view(dtype).reshape(shape).to(device))
        off += n
    it = iter(leaves)
    return [{k: next(it) for k in ks} for ks in keys]


@torch.inference_mode()
def _insert_slot(full_cache, one_cache, slot):
    """Copy a [R, 1, ...] single-sequence cache into batch index ``slot``
    of the [R, B, ...] slot cache (in place; returns the slot cache)."""
    for full, single in zip(full_cache, one_cache):
        for k in full:
            full[k][:, slot] = single[k][:, 0]
    return full_cache


class _Replica:
    """One data-parallel replica: a session device (or a prefill/decode
    device PAIR under disagg) with its own streams, slot cache, and decode
    batch.  Duck-types the routing view a :class:`ClusterPolicy` expects
    (``failed`` / ``ewma_step`` / ``load()``), so cluster policies route
    real-engine replicas exactly like simulator instances."""

    def __init__(self, engine: "RealEngine", index: int,
                 client, daemon, client_d, daemon_d):
        self.engine = engine
        self.index = index
        self.name = f"replica{index}"
        self.client = client          # prefill-side client
        self.daemon = daemon
        self.client_d = client_d      # decode-side client (disagg: peer dev)
        self.daemon_d = daemon_d
        cq = engine.compute_queues
        if cq > 1:
            # decode owns the last compute queue outright; prefill streams
            # spread over the rest, requests round-robining across them
            self.streams_p = [client.create_stream(phase=Phase.PREFILL,
                                                   queue=i)
                              for i in range(cq - 1)]
            self.stream_d = client_d.create_stream(phase=Phase.DECODE,
                                                   queue=cq - 1)
        else:
            self.streams_p = [client.create_stream(phase=Phase.PREFILL)]
            self.stream_d = client_d.create_stream(phase=Phase.DECODE)
        self.stream_p = self.streams_p[0]
        self._rr = 0
        # device state
        self.slot_cache = engine.model.init_cache(engine.max_num_seqs,
                                                  engine.max_len,
                                                  device=engine.device)
        self.lengths = np.zeros((engine.max_num_seqs,), np.int32)
        self.slot_req: List[Optional[Request]] = [None] * engine.max_num_seqs
        self.next_tokens = np.zeros((engine.max_num_seqs,), np.int32)
        self.decode_pending: List[tuple] = []   # (req, single_cache, tok)
        self.prefilling_count = 0               # admitted, prefill running
        self.active_count = 0
        self.decode_inflight = False
        # routing view (ClusterPolicy duck-typing)
        self.failed = False
        self.ewma_step = 0.0

    def load(self) -> float:
        """Router load signal: work resident on this replica."""
        return float(self.prefilling_count + len(self.decode_pending)
                     + self.active_count)

    def observe_step(self, dur: float) -> None:
        self.ewma_step = 0.8 * self.ewma_step + 0.2 * dur \
            if self.ewma_step else dur

    def next_prefill_stream(self) -> int:
        s = self.streams_p[self._rr % len(self.streams_p)]
        self._rr += 1
        return s


class RealEngine:
    def __init__(self, model: Model, params, *, mode: str = "dynamic_pd",
                 max_num_seqs: int = 4, max_len: int = 256,
                 policy=None, admission: Optional[AdmissionPolicy] = None,
                 sample: str = "greedy", kv_chunk_layers: int = 0,
                 replicas: int = 1, cluster_policy=None,
                 compute_queues: int = 1, device="cuda"):
        if model.cfg.is_encdec:
            raise ValueError(
                f"RealEngine: {model.cfg.name} is an encoder-decoder, whose "
                f"prefill needs src_embeds (frame embeddings) beside its "
                f"target tokens, and the engine feeds token prompts; the "
                f"reference engine has no such path either.  Drive it "
                f"through Model.prefill/decode")
        self.device = require_device(device)
        self._cuda = self.device.type == "cuda"
        self.model = model
        self.params = params
        self.mode = mode
        self.max_num_seqs = max_num_seqs
        self.max_len = max_len
        self.sample = sample
        self.compute_queues = max(1, int(compute_queues))
        # disagg KV transport: split the packed cache into this many
        # layer-group chunks pipelined over memcpy_peer (0 = one blob).
        # Chunks ride the same copy-engine stream, so they serialize on
        # the DMA engine while the destination's readback starts as soon
        # as the cross-device event edge for the LAST chunk resolves —
        # outputs stay byte-identical to the one-blob path.
        self.kv_chunk_layers = int(kv_chunk_layers)
        if replicas < 1:
            raise ValueError("the engine needs at least one replica")
        self.n_replicas = int(replicas)
        self._lock = threading.RLock()
        self._all_done = threading.Condition(self._lock)  # lock-alias: _lock
        # control plane (v3): dispatch policies resolve through the registry
        # by name; admission is a shared AdmissionPolicy (the same object
        # type the cluster simulator uses — no copy-pasted gating)
        if isinstance(policy, str):
            if policy_kind(policy) != "dispatch":
                raise ValueError(
                    f"policy {policy!r} is a {policy_kind(policy)} policy; "
                    f"RealEngine's policy= takes a dispatch policy "
                    f"(fifo, static_slice, dynamic_pd, ...)")
            policy = make_policy(policy)
        self.admission = admission or (
            GatedAdmission() if mode == "static_colocate"
            else UngatedAdmission())
        # replica routing (v4): the same ClusterPolicy layer the simulator
        # uses, resolved through the registry by name
        if cluster_policy is None or isinstance(cluster_policy, str):
            name = cluster_policy or "least_loaded"
            if policy_kind(name) != "cluster":
                raise ValueError(
                    f"policy {name!r} is a {policy_kind(name)} policy; "
                    f"RealEngine's cluster_policy= takes a cluster policy "
                    f"(least_loaded, least_contended, ...)")
            self.router: ClusterPolicy = make_policy(name)
        else:
            self.router = cluster_policy
        self.router.bind(self)

        queues = {"compute": self.compute_queues, "copy": 1}
        if mode == "passthrough":
            self.session = connect(mode="passthrough",
                                   devices=self.n_replicas)
        elif mode == "disagg":
            # each replica is a device PAIR: device 2i prefills, 2i+1
            # decodes; each side is single-phase so FIFO order suffices
            # (the simulator's disagg instances too)
            self.session = connect(mode="flex", devices=2 * self.n_replicas,
                                   policy=policy or FIFOPolicy(),
                                   instance="engine", queues=queues)
        else:
            policy = policy or (FIFOPolicy() if mode == "static_colocate"
                                else DynamicPDPolicy(
                                    DynamicPDConfig(ttft_guard_s=0.05,
                                                    adjust_interval_s=0.01)))
            self.session = connect(mode="flex", devices=self.n_replicas,
                                   policy=policy, instance="engine",
                                   queues=queues)
        self.replicas: List[_Replica] = []
        for r in range(self.n_replicas):
            if mode == "disagg":
                p_dev, d_dev = 2 * r, 2 * r + 1
            else:
                p_dev = d_dev = r
            self.replicas.append(_Replica(
                self, r, self.session.device(p_dev),
                self.session.daemon(p_dev), self.session.device(d_dev),
                self.session.daemon(d_dev)))
        # the session's recorder (FLEX_PROFILE=1), or None: while it is on,
        # the engine records its spans and counters there and launches each
        # step as a spans.Step
        self.timeline = self.session.timeline
        # single-replica conveniences (the v3 attribute names)
        self.client = self.replicas[0].client
        self.daemon = self.replicas[0].daemon
        self.client_d = self.replicas[0].client_d
        self.stream_p = self.replicas[0].stream_p
        self.stream_d = self.replicas[0].stream_d

        # the steps (shared: replicas run the same program)
        self._prefill_fn = (
            lambda p, toks, cache: model.prefill(p, {"tokens": toks}, cache))
        self._decode_fn = model.decode

        # engine-level queues
        self.waiting_admission: List[Request] = []  # guarded-by: _lock
        self.outstanding = 0                        # guarded-by: _lock
        self.finished: List[Request] = []           # guarded-by: _lock
        # honest rejection telemetry (v5): requests the admission policy
        # shed — they end REJECTED and count toward run() accounting
        self.rejected: List[Request] = []           # guarded-by: _lock
        # terminal-transition hook (v5): called with each request as it
        # ends (done/failed/rejected) — closed-loop traffic generators
        # plug in here, same contract as the cluster simulator's
        self.on_request_done = None

    # ------------------------------------------------------------- public
    def submit(self, req: Request) -> None:
        tl = self.timeline
        sp = None if tl is None else _spans.Span(tl, "engine.submit",
                                                 {"req_id": req.req_id})
        with self._lock:
            self.outstanding += 1
            req.arrival_time = req.arrival_time or time.monotonic()
            self.waiting_admission.append(req)
            self._drain_admission_locked()
        if sp is not None:
            sp.close()

    def run(self, requests: List[Request], timeout: float = 300.0) -> Dict:
        """Submit per arrival offsets (relative seconds) and wait."""
        t0 = time.monotonic()
        for r in sorted(requests, key=lambda r: r.arrival_time):
            delay = t0 + r.arrival_time - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            r.arrival_time = time.monotonic()
            self.submit(r)
        with self._all_done:
            deadline = time.monotonic() + timeout
            while self.outstanding > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{self.outstanding} requests unfinished")
                self._all_done.wait(min(remaining, 0.1))
        return summarize(requests)

    def shutdown(self):
        try:  # release the engine's stream handles (leak-free tables)
            for rep in self.replicas:
                rep.client.synchronize(None)
                if rep.client_d is not rep.client:
                    rep.client_d.synchronize(None)
                rep.client_d.destroy_stream(rep.stream_d)
                for s in rep.streams_p:
                    rep.client.destroy_stream(s)
                for c in (rep.client, rep.client_d):
                    if getattr(c, "_copy_stream", None) is not None:
                        c.destroy_stream(c._copy_stream)
        except Exception:
            pass  # dirty shutdown (timeout/fault): session teardown suffices
        self.session.close()

    # ------------------------------------------------------------ prefill
    def _admission_view(self, rep, idx: int = 0) -> AdmissionView:  # holds: _lock
        cand = self.waiting_admission[idx] \
            if idx < len(self.waiting_admission) else None
        return AdmissionView(
            waiting=len(self.waiting_admission),
            next_prompt_len=cand.prompt_len if cand else 0,
            active=rep.active_count,
            decode_pending=len(rep.decode_pending),
            prefilling=rep.prefilling_count,
            max_num_seqs=self.max_num_seqs,
            kv_free=None,      # dense slot caches: no token accounting
            next_tenant=cand.tenant if cand else "",
            next_priority=cand.priority if cand else 0)

    def _drain_admission_locked(self):  # holds: _lock
        # load shedding first (v5): doomed requests end REJECTED with
        # honest telemetry — the same policy hooks the simulator drives
        for r in self.admission.shed(self.waiting_admission,
                                     time.monotonic()):
            if r in self.waiting_admission:
                self.waiting_admission.remove(r)
                self._reject_locked(r)
        while self.waiting_admission:
            # pick the candidate (FIFO for v3/v4 policies, priority +
            # weighted-fair for slo_aware), route it, then gate against
            # the TARGET replica's occupancy — one admission
            # implementation for any replica count
            i = self.admission.pick_next(self.waiting_admission)
            # v6+ routing signature, called directly (the v5 two-argument
            # adapter was removed in v9; the real engine has no prefix
            # caches yet, so the context only carries clock and loads)
            rep = self.router.route_prefill(
                self.waiting_admission[i], self.replicas,
                RouteContext(now=time.monotonic(),
                             loads={r.name: r.load()
                                    for r in self.replicas}))
            if rep is None or not self.admission.admit(
                    self._admission_view(rep, i)):
                return
            req = self.waiting_admission.pop(i)
            self.admission.on_admit(req)
            rep.prefilling_count += 1
            self._launch_prefill(rep, req)

    def _reject_locked(self, req: Request) -> None:  # holds: _lock
        req.state = RequestState.REJECTED
        req.finish_time = time.monotonic()
        self.rejected.append(req)
        self.outstanding -= 1
        if self.on_request_done is not None:
            self.on_request_done(req)
        self._all_done.notify_all()

    def _launch_prefill(self, rep: _Replica, req: Request) -> None:  # holds: _lock
        tl = self.timeline
        sp = None if tl is None else _spans.Span(tl, "engine.prefill_setup",
                                                 {"req_id": req.req_id})
        req.state = RequestState.PREFILLING
        req.instance = rep.name
        toks = torch.tensor(req.prompt_tokens, dtype=torch.long,
                            device=self.device)[None, :]
        cache = self.model.init_cache(1, self.max_len, device=self.device)
        meta = {"tokens": req.prompt_len, "req_id": req.req_id}
        fn, step = self._prefill_fn, None
        if tl is not None:
            fn = step = meta["_step"] = _spans.Step(
                tl, "prefill", fn, self._cuda, req_id=req.req_id)
        t0 = time.monotonic()
        fut = rep.client.launch(
            rep.next_prefill_stream(), fn, self.params, toks,
            cache, phase=Phase.PREFILL, meta=meta)
        fut.add_done_callback(
            lambda f, r=req, rp=rep, t=t0, st=step:
            self._prefill_done(rp, r, f, t, st))
        if sp is not None:
            sp.close()

    def _prefill_done(self, rep: _Replica, req: Request, fut,
                      t0: float, step=None) -> None:
        try:
            logits, single_cache, lens = fut.result()
        except Exception:
            with self._lock:
                rep.prefilling_count = max(0, rep.prefilling_count - 1)
                self._fail_locked(req)
            return
        sp = None if step is None else _spans.Span(
            step.tl, "engine.prefill_done",
            {"req_id": req.req_id, "op_id": step.op_id})
        try:
            tok = int(torch.argmax(logits[0]).item())
            now = time.monotonic()
            with self._lock:
                rep.prefilling_count = max(0, rep.prefilling_count - 1)
                rep.observe_step(now - t0)
                req.record_token(now)
                req.output_tokens.append(tok)
                if req.done_decoding:
                    self._finish_locked(req)
                    return
            if self.mode == "disagg":
                self._transfer_kv(rep, req, single_cache, tok)
                return
            with self._lock:
                rep.decode_pending.append((req, single_cache, tok))
                self._fill_slots_locked(rep)
                self._ensure_decode_locked(rep)
        finally:
            if sp is not None:
                sp.close()

    # --------------------------------------------- disagg: KV cache transfer
    def _kv_chunk_bounds(self, blob_nbytes: int, spec) -> List[tuple]:
        """(offset, nbytes) per chunk: the packed blob split on LAYER
        boundaries (pack order is the cache pytree's leaf order) into up
        to ``kv_chunk_layers`` near-even groups — never mid-array."""
        if self.kv_chunk_layers <= 1 or len(spec) <= 1:
            return [(0, blob_nbytes)]
        sizes = [_nbytes(shape, dtype) for shape, dtype in spec]
        n = min(self.kv_chunk_layers, len(sizes))
        per = max(1, math.ceil(len(sizes) / n))
        bounds, off = [], 0
        for i in range(0, len(sizes), per):
            nb = sum(sizes[i:i + per])
            bounds.append((off, nb))
            off += nb
        return bounds

    def _transfer_kv(self, rep: _Replica, req: Request, single_cache,
                     tok: int) -> None:
        """Move the prefilled KV cache from the replica's prefill device to
        its decode device through backend-owned buffers: H2D on the
        source, ``memcpy_peer`` on the copy-engine stream — chunked on
        layer boundaries when ``kv_chunk_layers`` > 1, so the chunks
        pipeline on the copy engine — then ONE cross-device (shared) event
        after the last chunk orders the decode side's D2H readbacks after
        every peer copy (the daemons' happens-before graph spans both
        devices)."""
        blob, keys, spec = _pack_cache(single_cache)
        cp, cd = rep.client, rep.client_d
        sp, sd = cp.copy_engine_stream(), cd.copy_engine_stream()
        ev = self.session.create_shared_event()
        bounds = self._kv_chunk_bounds(blob.nbytes, spec)
        handles = []
        for i, (off, nb) in enumerate(bounds):
            h_src = cp.malloc(nb, tag="kv-transfer")
            h_dst = cd.malloc(nb, tag="kv-transfer")
            handles.append((h_src, h_dst))
            cp.memcpy(h_src, blob[off:off + nb], vstream=sp)
            cp.memcpy_peer(rep.daemon_d, h_dst, h_src, nb,
                           vstream=sp,
                           meta={"req_id": req.req_id, "kv_chunk": i,
                                 "kv_chunks": len(bounds)})
        cp.record_event(ev, sp)
        cd.wait_event(ev, sd)               # released by the source's record
        # same-stream FIFO: the LAST readback completes last, with every
        # earlier chunk's future already resolved
        futs = [cd.memcpy(None, h_dst, nb, vstream=sd)
                for (_, h_dst), (_, nb) in zip(handles, bounds)]
        futs[-1].add_done_callback(
            lambda f: self._kv_arrived(rep, req, tok, keys, spec,
                                       handles, ev, futs))

    def _kv_arrived(self, rep: _Replica, req: Request, tok: int, keys,
                    spec, handles, ev: int, futs) -> None:
        try:
            parts = [np.asarray(f.result(), dtype=np.uint8) for f in futs]
            blob = parts[0] if len(parts) == 1 else np.concatenate(parts)
            cache = _unpack_cache(blob, keys, spec, self.device)
        except Exception:
            with self._lock:
                self._fail_locked(req)
            return
        finally:
            try:  # the peer copies completed before the readbacks (event edge)
                for h_src, h_dst in handles:
                    rep.client.free(h_src)
                    rep.client_d.free(h_dst)
                self.session.destroy_shared_event(ev)
            except Exception:
                pass  # teardown race on shutdown: session close cleans up
        with self._lock:
            rep.decode_pending.append((req, cache, tok))
            self._fill_slots_locked(rep)
            self._ensure_decode_locked(rep)

    # ------------------------------------------------------------- decode
    def _fill_slots_locked(self, rep: _Replica):  # holds: _lock
        if rep.decode_inflight:
            # the in-flight decode holds a snapshot of slot_cache; inserting
            # now would be overwritten when it completes (lost update)
            return
        tl = self.timeline
        for slot in range(self.max_num_seqs):
            if not rep.decode_pending:
                break
            if rep.slot_req[slot] is not None:
                continue
            req, single_cache, tok = rep.decode_pending.pop(0)
            sp = None if tl is None else _spans.Span(
                tl, "engine.slot_insert", {"req_id": req.req_id,
                                           "slot": slot})
            rep.slot_cache = _insert_slot(rep.slot_cache, single_cache, slot)
            if sp is not None:
                sp.close()
            rep.slot_req[slot] = req
            rep.lengths[slot] = req.prompt_len
            rep.next_tokens[slot] = tok
            req.slot = slot
            req.state = RequestState.DECODING
            rep.active_count += 1

    def _ensure_decode_locked(self, rep: _Replica):  # holds: _lock
        if rep.decode_inflight or rep.active_count == 0:
            return
        rep.decode_inflight = True
        toks = torch.tensor(rep.next_tokens, dtype=torch.long,
                            device=self.device)
        lens = torch.tensor(rep.lengths, device=self.device)
        meta = {"tokens": rep.active_count}
        fn, step = self._decode_fn, None
        tl = self.timeline
        if tl is not None:
            rows = [s for s, r in enumerate(rep.slot_req) if r is not None]
            meta["ctx"] = [int(rep.lengths[s]) for s in rows]
            meta["req_id"] = [rep.slot_req[s].req_id for s in rows]
            fn = step = meta["_step"] = _spans.Step(
                tl, "decode", fn, self._cuda, rows=len(rows))
            for name, n in (("slots_active", rep.active_count),
                            ("decode_pending", len(rep.decode_pending)),
                            ("waiting_admission",
                             len(self.waiting_admission)),
                            ("prefilling", rep.prefilling_count)):
                _spans.counter(tl, name, n)
        t0 = time.monotonic()
        fut = rep.client_d.launch(
            rep.stream_d, fn, self.params, toks,
            rep.slot_cache, lens, phase=Phase.DECODE, meta=meta)
        fut.add_done_callback(
            lambda f, rp=rep, t=t0, st=step: self._decode_done(rp, f, t, st))

    def _decode_done(self, rep: _Replica, fut, t0: float,
                     step=None) -> None:
        sp = None if step is None else _spans.Span(
            step.tl, "engine.decode_done", {"op_id": step.op_id,
                                            "rows": step.args["rows"]})
        try:
            self._decoded(rep, fut, t0)
        finally:
            if sp is not None:
                sp.close()

    def _decoded(self, rep: _Replica, fut, t0: float) -> None:
        try:
            logits, new_cache = fut.result()
        except Exception:
            with self._lock:
                rep.decode_inflight = False
            return
        now = time.monotonic()
        toks = torch.argmax(logits, dim=-1).tolist()
        with self._lock:
            rep.slot_cache = new_cache
            rep.decode_inflight = False
            rep.observe_step(now - t0)
            for slot in range(self.max_num_seqs):
                req = rep.slot_req[slot]
                if req is None:
                    continue
                rep.lengths[slot] += 1
                tok = int(toks[slot])
                req.record_token(now)
                req.output_tokens.append(tok)
                rep.next_tokens[slot] = tok
                if req.done_decoding:
                    rep.slot_req[slot] = None
                    rep.lengths[slot] = 0
                    rep.active_count -= 1
                    self._finish_locked(req)
            self._drain_admission_locked()
            self._fill_slots_locked(rep)
            self._ensure_decode_locked(rep)

    def _finish_locked(self, req: Request):  # holds: _lock
        req.state = RequestState.DONE
        req.finish_time = time.monotonic()
        self.finished.append(req)
        self.outstanding -= 1
        if self.on_request_done is not None:
            self.on_request_done(req)
        # a finished sequence releases its slot claim: gated admission may
        # now let the next request in (also covers requests that finish at
        # prefill, which never reach the decode-completion drain)
        self._drain_admission_locked()
        self._all_done.notify_all()

    def _fail_locked(self, req: Request):  # holds: _lock
        """Terminal FAILED with full ledger release: finish_time stamped,
        the outstanding count dropped, admission re-drained (a failed
        prefill/transfer releases its slot claim exactly like a finished
        one), and run() waiters woken."""
        req.state = RequestState.FAILED
        req.finish_time = time.monotonic()
        self.outstanding -= 1
        if self.on_request_done is not None:
            self.on_request_done(req)
        self._drain_admission_locked()
        self._all_done.notify_all()

"""Session-based virtual device API (v2) — the application entry point.

The paper's deployment story is many NPUs behind one narrow boundary: each
physical device runs its own FlexDaemon; an application opens a *session*
spanning N virtual devices and addresses them through device-scoped clients.
``connect`` is the factory::

    from repro_torch.core import connect

    sess = connect(mode="flex", devices=2)       # threaded, real execution
    sess.set_device(0)
    h = sess.malloc(1 << 20, tag="kv")
    s = sess.create_stream(phase=Phase.PREFILL)
    sess.launch(s, fn, *args, phase=Phase.PREFILL)
    sess.synchronize(s)
    sess.close()

Modes:
  * ``flex``        — one threaded FlexDaemon per device executing on the
                      real (PyTorch) backend; the paper's interposed path.
  * ``passthrough`` — direct submission, no interception (Table 1 baseline).
  * ``sim``         — one stepped FlexDaemon per device; the discrete-event
                      simulator drives ``select_next``/``mark_complete``
                      against a virtual clock (caller supplies the backend).

Every device has its **own handle tables and memory accounting** — handles
are only meaningful on the device that issued them, and clients carry an
instance tag so co-located logical instances cannot free each other's
buffers (per-instance handle isolation).  Events come in two scopes:
device-scoped (positive handles: a ``record_event``/``wait_event`` pair
links two streams of the same device) and **session-scoped** (negative
handles from ``create_shared_event()``: record on device A, wait on device
B — the happens-before graph spans devices).  Cross-device data movement
goes through ``memcpy_peer``, dispatched on the source device's copy-engine
stream so it overlaps with compute.
"""
from __future__ import annotations

import copy as _copy
from typing import Callable, Dict, List, Optional, Union

from repro_torch.core.api import ENGINE_COMPUTE, Future, MemcpyKind, Phase, RuntimeAPI
from repro_torch.core.client import FlexClient, PassthroughClient
from repro_torch.core.daemon import FlexDaemon, RealBackend
from repro_torch.core.handles import SharedEventTable
# flexlint: ignore[layering] -- documented cycle-break (see repro_torch.core.daemon)
from repro_torch.sched.dispatch import DispatchPolicy as SchedulerPolicy

MODES = ("flex", "passthrough", "sim")


def _policy_for(policy, device_id: int):
    """Resolve the per-device policy: factory, prototype, or None (FIFO)."""
    if policy is None or isinstance(policy, SchedulerPolicy):
        if policy is not None and device_id > 0:
            return _copy.deepcopy(policy)   # policies hold mutable state
        return policy
    return policy(device_id)                # factory: callable(device_id)


def _backend_for(backend, device_id: int):
    if backend is None:
        return RealBackend()
    if callable(backend) and not hasattr(backend, "now"):
        return backend(device_id)           # factory: callable(device_id)
    return backend                          # shared (e.g. one sim clock)


class Session(RuntimeAPI):
    """A multi-device handle on the virtual NPU runtime.

    The session itself implements :class:`RuntimeAPI` by delegating to the
    *current* device (``set_device``); ``device(i)`` returns the underlying
    device-scoped client for code that pins a device explicitly."""

    def __init__(self, mode: str, clients: List[RuntimeAPI],
                 daemons: List[Optional[FlexDaemon]],
                 shared_events: Optional[SharedEventTable] = None,
                 sanitizer=None, timeline=None):
        self.mode = mode
        self._clients = clients
        self.daemons = daemons
        self.shared_events = shared_events
        # happens-before checker shared by every daemon of this session
        # (FLEX_SANITIZE=1; see repro_torch.analysis.hazards) — None when off
        self.sanitizer = sanitizer
        # per-op Chrome-trace recorder shared by every daemon
        # (FLEX_PROFILE=1; see repro_torch.core.profiler.Timeline) — None when off
        self.timeline = timeline
        self._current = 0
        self._closed = False

    # -- device addressing --------------------------------------------------
    def device_count(self) -> int:
        return len(self._clients)

    def set_device(self, device_id: int) -> None:
        if not 0 <= device_id < len(self._clients):
            raise IndexError(
                f"device {device_id} out of range "
                f"(session has {len(self._clients)})")
        self._current = device_id

    @property
    def current_device(self) -> int:
        return self._current

    def device(self, device_id: int) -> RuntimeAPI:
        if not 0 <= device_id < len(self._clients):
            raise IndexError(
                f"device {device_id} out of range "
                f"(session has {len(self._clients)})")
        return self._clients[device_id]

    def daemon(self, device_id: int) -> Optional[FlexDaemon]:
        return self.daemons[device_id]

    # -- RuntimeAPI delegation to the current device ------------------------
    def malloc(self, nbytes: int, *, tag: str = "") -> int:
        return self._clients[self._current].malloc(nbytes, tag=tag)

    def free(self, vhandle: int) -> None:
        self._clients[self._current].free(vhandle)

    def memcpy(self, dst, src, nbytes: Optional[int] = None, *,
               kind: Optional[MemcpyKind] = None, vstream: int = 0,
               meta: Optional[Dict] = None) -> Future:
        return self._clients[self._current].memcpy(
            dst, src, nbytes, kind=kind, vstream=vstream, meta=meta)

    def memcpy_peer(self, dst_device, dst, src, nbytes: Optional[int] = None,
                    *, vstream: Optional[int] = None, link=None,
                    meta: Optional[Dict] = None) -> Future:
        """Cross-device copy from the CURRENT device to ``dst_device``
        (a device index, or a daemon/client object), dispatched on the
        source device's copy-engine stream by default."""
        if isinstance(dst_device, int):
            if not 0 <= dst_device < len(self._clients):
                raise IndexError(
                    f"device {dst_device} out of range "
                    f"(session has {len(self._clients)})")
            d = self.daemons[dst_device]
            dst_device = d if d is not None else self._clients[dst_device]
        return self._clients[self._current].memcpy_peer(
            dst_device, dst, src, nbytes, vstream=vstream, link=link,
            meta=meta)

    def create_stream(self, *, phase: Phase = Phase.OTHER,
                      engine: str = ENGINE_COMPUTE,
                      queue: Optional[int] = None) -> int:
        return self._clients[self._current].create_stream(
            phase=phase, engine=engine, queue=queue)

    def bind_stream_queue(self, vstream: int,
                          queue: Optional[int]) -> None:
        self._clients[self._current].bind_stream_queue(vstream, queue)

    def copy_engine_stream(self) -> int:
        return self._clients[self._current].copy_engine_stream()

    def destroy_stream(self, vstream: int) -> None:
        self._clients[self._current].destroy_stream(vstream)

    def create_event(self) -> int:
        return self._clients[self._current].create_event()

    def destroy_event(self, vevent: int) -> None:
        self._clients[self._current].destroy_event(vevent)

    # -- session-scoped (cross-device) events -------------------------------
    def create_shared_event(self) -> int:
        """An event visible to EVERY device of this session (negative
        handle): record it on one device's stream and wait on another's —
        the daemons' happens-before graph then spans devices."""
        if self.shared_events is None:
            raise RuntimeError(
                "shared events need daemon-backed devices "
                "(mode='flex' or 'sim', not 'passthrough')")
        return self.shared_events.create()

    def destroy_shared_event(self, vevent: int) -> None:
        if self.shared_events is None:
            raise RuntimeError("session has no shared events")
        self.shared_events.destroy(vevent)

    def record_event(self, vevent: int, vstream: int) -> Future:
        return self._clients[self._current].record_event(vevent, vstream)

    def wait_event(self, vevent: int, vstream: int) -> Future:
        return self._clients[self._current].wait_event(vevent, vstream)

    def launch(self, vstream: int, fn: Optional[Callable], *args,
               phase: Phase = Phase.OTHER, meta: Optional[Dict] = None,
               **kwargs) -> Future:
        return self._clients[self._current].launch(
            vstream, fn, *args, phase=phase, meta=meta, **kwargs)

    def synchronize(self, vstream: Optional[int] = None) -> None:
        self._clients[self._current].synchronize(vstream)

    def synchronize_all(self) -> None:
        for c in self._clients:
            c.synchronize(None)

    # -- lifecycle / introspection ------------------------------------------
    def stats(self) -> Dict[int, Dict[str, int]]:
        """Per-device handle + memory accounting (leak checks, dashboards)."""
        out = {}
        for i, d in enumerate(self.daemons):
            if d is None:
                c = self._clients[i]
                out[i] = {"streams": len(getattr(c, "_streams", ())),
                          "events": len(getattr(c, "_events", ())),
                          "buffers": len(getattr(c, "_buffers", ())),
                          "allocated_bytes": sum(
                              b["nbytes"]
                              for b in getattr(c, "_buffers", {}).values())}
            else:
                out[i] = {"streams": len(d.streams),
                          "events": len(d.events),
                          "buffers": len(d.memory),
                          "allocated_bytes": d.allocated_bytes,
                          "peak_bytes": d.peak_bytes}
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for d in self.daemons:
            if d is not None:
                d.closed = True   # reject new work before the thread winds down
                d.stop()
        for c in self._clients:
            if isinstance(c, PassthroughClient):
                c.close()
        if self.timeline is not None:
            # dump before the sanitizer can raise: the trace of a hazardous
            # run is exactly what you want on disk
            self.trace_path = self.timeline.dump()
        if self.sanitizer is not None and self.sanitizer.hazards:
            hazards = self.sanitizer.drain()
            raise RuntimeError(
                "FLEX_SANITIZE found %d happens-before hazard(s):\n  %s"
                % (len(hazards), "\n  ".join(hazards)))

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def connect(mode: str = "flex", devices: int = 1, *,
            policy: Union[SchedulerPolicy, Callable, None] = None,
            backend=None, instance: str = "", queues=None) -> Session:
    """Open a session over ``devices`` virtual NPUs.

    ``policy`` may be a SchedulerPolicy prototype (deep-copied per device so
    per-device scheduling state stays independent) or a factory
    ``callable(device_id) -> SchedulerPolicy``.  ``backend`` likewise: a
    shared backend object (e.g. one simulator clock facade) or a factory.
    ``queues`` configures each device's execution queues (a
    ``repro_torch.core.queues`` spec — ``{"compute": 2, "copy": 1}`` or
    ``"compute:2,copy:1"`` — or a factory ``callable(device_id) -> spec``;
    None = one queue per engine class, the v3 behavior).  ``mode='sim'``
    requires a caller-supplied backend and leaves the daemons stepped
    (never threaded); the simulator drives them."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if devices < 1:
        raise ValueError("a session needs at least one device")
    if mode == "sim" and backend is None:
        raise ValueError("mode='sim' requires a stepped backend "
                         "(e.g. SimBackend over the event-loop clock)")
    clients: List[RuntimeAPI] = []
    daemons: List[Optional[FlexDaemon]] = []
    shared = SharedEventTable() if mode != "passthrough" else None
    sanitizer = None
    timeline = None
    if mode != "passthrough":
        from repro_torch.analysis.hazards import HazardSanitizer, sanitize_enabled
        if sanitize_enabled():
            sanitizer = HazardSanitizer()   # one checker spans the session
        from repro_torch.core.profiler import Timeline, profile_enabled
        if profile_enabled():
            timeline = Timeline()           # one recorder spans the session
    for i in range(devices):
        if mode == "passthrough":
            clients.append(PassthroughClient())
            daemons.append(None)
            continue
        d = FlexDaemon(i, _backend_for(backend, i),
                       policy=_policy_for(policy, i), shared_events=shared,
                       queues=queues(i) if callable(queues) else queues,
                       sanitizer=sanitizer, timeline=timeline)
        if mode == "flex":
            d.start()
        clients.append(FlexClient(d, instance=instance))
        daemons.append(d)
    return Session(mode, clients, daemons, shared_events=shared,
                   sanitizer=sanitizer, timeline=timeline)

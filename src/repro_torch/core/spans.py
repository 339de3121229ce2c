"""Spans and counters inside the serving path, on the session's Timeline.

With ``FLEX_PROFILE=1`` the session's :class:`~repro_torch.core.profiler.
Timeline` records, beside its one event an op, spans of the host work
around and inside the ops and counters of the engine's queues: Chrome
``"X"`` events with ``"cat": "span"`` and ``"C"`` events, in the same list
and the same file, on the ops' monotonic clock
(:meth:`~repro_torch.core.profiler.Timeline.to_profiler_ns` maps it onto
torch.profiler's).

A span's ``args`` hold its ``id``; its ``parent``, the span open on the
same thread when it began (None at the top of a thread); across threads
the ``op_id`` of the op that encloses or caused it, and the ``req_id`` of
the request it serves, where one request did.

A model step: while tracing, the engine launches a :class:`Step` in place
of its step function.  It runs the function inside a ``step.issue`` span
and owns the spans its thread opens meanwhile (:func:`model_span`: each
layer's attention, MoE or MLP, the logits) and the host readbacks the step
makes (:func:`readback`).  On a CUDA device, one step of each kind
(prefill, decode) in ``TIMED_EVERY`` also takes CUDA events on its stream
around each of those spans: recording an event costs the host about what
launching a kernel does, so timing every step of a decode that the host
paces would slow it by as many events as it has spans.  Once the op has
completed on the card, ``Timeline.record`` hands the op to
:meth:`Step.complete`, which reads each span's stream time and writes the
spans with the op's id.

Off, a site costs one load of a module-level reference (``profiler.ACTIVE``
in the model, the engine's ``timeline``) and one ``None`` check: no span
object is made.
"""
from __future__ import annotations

import collections
import itertools
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

_IDS = itertools.count(1)
_local = threading.local()      # .stack: open spans; .step: the running Step
_PID = os.getpid()              # host spans' row, beside the devices' rows
TIMED_EVERY = 8                 # one step of a kind in this many: stream times
_STEPS: Dict[str, "itertools.count"] = collections.defaultdict(itertools.count)


def _stack() -> List["Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _cuda_event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()                 # on this thread's current stream
    return ev


class Span:
    """A span open on this thread; :meth:`close` ends and records it (a
    step's spans wait for the op to complete, see :class:`Step`)."""

    __slots__ = ("tl", "name", "args", "step", "id", "parent", "ev0", "t0")

    def __init__(self, tl, name: str, args: Dict,
                 step: Optional["Step"] = None):
        stack = _stack()
        self.tl, self.name, self.args, self.step = tl, name, args, step
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        self.ev0 = _cuda_event() if step is not None and step.cuda else None
        stack.append(self)
        self.t0 = time.monotonic_ns()

    def close(self, **args) -> None:
        t1 = time.monotonic_ns()
        stack = _stack()
        if self in stack:           # and any span a failure left open above
            del stack[stack.index(self):]
        ev = {"name": self.name, "cat": "span", "ph": "X",
              "ts": self.t0 / 1e3, "dur": (t1 - self.t0) / 1e3,
              "pid": _PID, "tid": threading.current_thread().name,
              "args": dict(self.args, id=self.id, parent=self.parent,
                           **args)}
        if self.step is None:
            self.tl.add(ev)
        else:
            ev1 = _cuda_event() if self.ev0 is not None else None
            self.step.spans.append((ev, self.ev0, ev1))


class Step:
    """A model step launched as a daemon op while tracing: the op's
    callable and, in its meta under ``"_step"``, the link that
    ``Timeline.record`` completes.  ``cuda``: it runs on a card, where one
    step of its ``kind`` in ``TIMED_EVERY`` takes CUDA events."""

    __slots__ = ("tl", "kind", "fn", "cuda", "args", "spans", "readbacks",
                 "op_id")

    def __init__(self, tl, kind: str, fn: Callable, cuda: bool, **args):
        self.tl, self.kind, self.fn = tl, kind, fn
        self.cuda = cuda and next(_STEPS[kind]) % TIMED_EVERY == 0
        self.args = args
        self.spans: List[tuple] = []    # (event, CUDA start, CUDA end)
        self.readbacks = 0
        self.op_id: Optional[int] = None

    def __call__(self, *a, **kw):
        stack = _stack()
        depth = len(stack)
        outer = getattr(_local, "step", None)
        _local.step = self
        sp = Span(self.tl, "step.issue", dict(self.args, kind=self.kind),
                  step=self)
        try:
            return self.fn(*a, **kw)
        finally:
            sp.close(readbacks=self.readbacks)
            del stack[depth:]
            _local.step = outer

    def complete(self, tl, op) -> None:
        """The op has completed on the card: write the step's spans with
        its id, each with its stream time where it took CUDA events."""
        self.op_id = op.op_id
        for ev, e0, e1 in self.spans:
            ev["args"]["op_id"] = op.op_id
            if e0 is not None:
                try:
                    ev["args"]["stream_ms"] = e0.elapsed_time(e1)
                except RuntimeError:
                    pass            # a step that failed before recording
            tl.add(ev)
        self.spans = []


def model_span(name: str, **args) -> Optional[Span]:
    """A span of the step running on this thread, or None outside one."""
    step = getattr(_local, "step", None)
    if step is None:
        return None
    return Span(step.tl, name, args, step=step)


def readback() -> None:
    """Count one device-to-host read inside the step on this thread."""
    step = getattr(_local, "step", None)
    if step is not None:
        step.readbacks += 1


def counter(tl, name: str, value: float) -> None:
    tl.add({"name": name, "ph": "C", "ts": time.monotonic_ns() / 1e3,
            "pid": _PID, "args": {name: value}})

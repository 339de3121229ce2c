"""The traced run: what the per-layer readers read.

* The engine's op timeline (``FLEX_PROFILE=1``: one event an op, with its
  phase, dispatch time, execution time to completion on the card, queue
  delay, and meta ``tokens``), kept from the window.
* The benchmark's own record of each step it drove: ``Recorder`` wraps
  the engine's prefill and decode functions and notes, at each call, the
  host time (monotonic and Unix ns), and the step's shapes from the
  benchmark's own requests: a prefill's prompt length, a decode step's
  context length in every row of its batch.
* ``torch.profiler`` over a sub-window of a few seconds (CUDA activity
  only: the card's kernels, copies and sets, on the profiler's Unix-ns
  clock), taken apart here into kernels by name and busy intervals.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List, Tuple


@dataclasses.dataclass
class Step:
    kind: str                 # "prefill" | "decode"
    t: float                  # monotonic, at the call
    t_ns: int                 # Unix ns, at the call
    prompt: int = 0           # prefill: prompt tokens
    rows: Tuple[int, ...] = ()    # decode: positions each row attends
    active: Tuple[int, ...] = ()  # decode: the same, rows holding a request


class Recorder:
    """Wraps ``engine._prefill_fn`` and ``engine._decode_fn``."""

    def __init__(self, engine, ring: int):
        self.steps: List[Step] = []
        self.ring = ring          # slots of a windowed layer's ring cache
        rep = engine.replicas[0]
        prefill, decode = engine._prefill_fn, engine._decode_fn

        def prefill_fn(p, toks, cache):
            self.steps.append(Step("prefill", time.monotonic(),
                                   time.time_ns(), prompt=toks.shape[1]))
            return prefill(p, toks, cache)

        def decode_fn(p, toks, cache, lens):
            # while a decode is in flight the engine changes no slot: the
            # requests in the slots, and the tokens each has, are fixed
            rows = []
            for req in rep.slot_req:
                n = 1 if req is None else req.prompt_len + len(req.times)
                rows.append(min(n, ring) if ring else n)
            active = tuple(n for n, req in zip(rows, rep.slot_req)
                           if req is not None)
            self.steps.append(Step("decode", time.monotonic(),
                                   time.time_ns(), rows=tuple(rows),
                                   active=active))
            return decode(p, toks, cache, lens)

        engine._prefill_fn = prefill_fn
        engine._decode_fn = decode_fn


@dataclasses.dataclass
class Kernel:
    name: str
    start: int                # Unix ns
    end: int


class DeviceTrace:
    """``torch.profiler`` over a sub-window, started and stopped by the
    traffic loop's timers."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda          # False: a CPU run, whose trace holds no
        self.prof = None          # device event
        self.span: Tuple[int, int] = (0, 0)       # Unix ns
        self.host: Tuple[float, float] = (0.0, 0.0)   # monotonic, around
        self.kernels: List[Kernel] = []               # start and stop

    def prime(self) -> None:
        """Start and stop once in set-up, so that the profiler's own
        set-up is not timed, and free that first profiler now: left to a
        collection inside the window, freeing it while the second one runs
        can abort the process."""
        self.start()
        self.stop()
        self.prof = None
        gc.collect()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        t = time.monotonic()
        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                        else ProfilerActivity.CPU])
        self.prof.start()
        self.span = (time.time_ns(), 0)
        self.host = (t, 0.0)

    def stop(self) -> None:
        if self.prof is None:
            return
        self.span = (self.span[0], time.time_ns())
        self.prof.stop()
        self.host = (self.host[0], time.monotonic())

    def collect(self) -> None:
        """Device events inside the span, as kernels by name."""
        from torch.autograd import DeviceType
        p0, p1 = self.span
        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            s = e.start_ns()
            t = s + e.duration_ns()
            if t <= p0 or s >= p1:
                continue
            out.append(Kernel(e.name(), max(s, p0), min(t, p1)))
        self.kernels = sorted(out, key=lambda k: k.start)
        self.prof = None


def busy_intervals(kernels: List[Kernel]) -> List[Tuple[int, int]]:
    """The union of the kernels' intervals."""
    merged: List[List[int]] = []
    for k in kernels:
        if merged and k.start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], k.end)
        else:
            merged.append([k.start, k.end])
    return [(a, b) for a, b in merged]


@dataclasses.dataclass
class View:
    """What a per-layer reader reads (``metrics/<name>.py``: ``read(view)``
    returns a number, or None where it finds nothing to read)."""
    model: Dict               # the configuration file's model sizes
    engine: Dict              # max_num_seqs, max_len
    window: Tuple[float, float]           # monotonic
    ops: List[Dict]           # timeline events dispatched in the window
    steps: List[Step]         # the benchmark's record of every step
    span: Tuple[int, int]     # the device trace's sub-window, Unix ns
    kernels: List[Kernel]     # device events inside it

    def steps_in_span(self, kind: str) -> List[Tuple[Step, List[Kernel]]]:
        """Each step of ``kind`` that began inside the device trace's span
        and was followed by another step inside it, with the kernels that
        started between the two (ops run one at a time, each waited for)."""
        steps = [s for s in self.steps
                 if self.span[0] <= s.t_ns <= self.span[1]]
        out = []
        ki = 0
        ks = self.kernels
        for s, nxt in zip(steps, steps[1:]):
            while ki < len(ks) and ks[ki].start < s.t_ns:
                ki += 1
            kj = ki
            while kj < len(ks) and ks[kj].start < nxt.t_ns:
                kj += 1
            if s.kind == kind:
                out.append((s, ks[ki:kj]))
        return out

    def ops_of(self, phase: str) -> List[Dict]:
        return [o for o in self.ops if o["name"].startswith(phase + ":")]


def window_ops(events: List[Dict], window: Tuple[float, float],
               skip: Tuple[float, float] = (0.0, 0.0),
               settle: float = 0.0) -> List[Dict]:
    """Timeline launch events dispatched inside the window, but for those
    dispatched while the device trace ran (``skip``: its host times) or
    within ``settle`` seconds after: starting the profiler can hold the
    host for seconds, and what queued meanwhile drains after."""
    w0, w1 = window
    s0, s1 = skip[0] * 1e6, (skip[1] + settle) * 1e6
    return [e for e in events if e["name"].endswith(":launch")
            and w0 * 1e6 <= e["ts"] < w1 * 1e6
            and not s0 <= e["ts"] < s1]


def breakdown(view: View, offset_ns: int) -> Dict[str, List]:
    """The device operations that took most time in the span, and the
    device's idle time by what the host was doing (inside a prefill or a
    decode op of the engine's timeline, or between ops).  ``offset_ns``
    takes monotonic ns to Unix ns."""
    by_name: Dict[str, float] = {}
    for k in view.kernels:
        by_name[k.name] = by_name.get(k.name, 0.0) + (k.end - k.start) / 1e9
    ops = sorted(((o["ts"] * 1e3 + offset_ns,
                   (o["ts"] + o["dur"]) * 1e3 + offset_ns,
                   o["name"].split(":")[0]) for o in view.ops))
    idle: Dict[str, float] = {}
    busy = busy_intervals(view.kernels)
    edges = [view.span[0]] + [x for b in busy for x in b] + [view.span[1]]
    oi = 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        while oi < len(ops) and ops[oi][1] <= a:
            oi += 1
        inside = oi < len(ops) and ops[oi][0] <= a
        label = (f"host issuing a {ops[oi][2]} op" if inside
                 else "between ops: engine and daemon")
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps]}


def busy_s(view: View) -> float:
    return sum(b - a for a, b in busy_intervals(view.kernels)) / 1e9


def span_s(view: View) -> float:
    return (view.span[1] - view.span[0]) / 1e9


def clock_offset_ns() -> int:
    """Unix ns minus monotonic ns, read back to back."""
    a = time.time_ns()
    m = time.monotonic_ns()
    b = time.time_ns()
    return (a + b) // 2 - m

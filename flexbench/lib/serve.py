"""The traffic loop: builds the port's model and ``RealEngine`` from a cell's
files, warms it up, then feeds it the cell's traffic through
``RealEngine.submit`` and times every request from when it was due.

Each request is a ``Timed`` request: the port's ``Request`` that also
keeps the time of every token it is handed (``times``), when it was due
(``due``) and when it was sent (``sent``).
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from flexbench.lib import traffic as TR


def model_config(model: Dict):
    """The port's ``ModelConfig`` of a configuration file's ``model``.
    Keys the port has no field for (``norm_eps``,
    ``rotary_fraction``) state what it does; the reference reads
    them."""
    from repro_torch.configs.base import (Activation, Family, ModelConfig,
                                          MoEConfig, Norm, PosEmb)
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in model.items() if k in fields}
    kw["family"] = Family(kw["family"])
    kw["activation"] = Activation(kw["activation"])
    kw["norm"] = Norm(kw["norm"])
    kw["pos_emb"] = PosEmb(kw["pos_emb"])
    if kw.get("moe"):
        kw["moe"] = MoEConfig(**kw["moe"])
    return ModelConfig(**kw)


def timed_request_class():
    from repro_torch.serving.request import Request

    class Timed(Request):
        """A ``Request`` that keeps the time of each token it is handed."""

        def record_token(self, now: float) -> None:
            super().record_token(now)
            self.times.append(now)

    return Timed


def make_requests(items: List[TR.Item]):
    Timed = timed_request_class()
    out = []
    for it in items:
        r = Timed(prompt_len=len(it.prompt), max_new_tokens=it.max_new,
                  prompt_tokens=it.prompt.tolist())
        r.times, r.due, r.sent = [], -1.0, -1.0
        out.append(r)
    return out


def build_engine(model, params, engine_cfg: Dict, device):
    from repro_torch.serving.engine import RealEngine
    return RealEngine(model, params, mode=engine_cfg.get("mode",
                                                         "dynamic_pd"),
                      max_num_seqs=int(engine_cfg["max_num_seqs"]),
                      max_len=int(engine_cfg["max_len"]), device=device)


def warm_up(engine, traffic: Dict, vocab: int, timeout: float = 600.0):
    """One prompt at the mix's shortest and one at its longest length,
    each decoding a few tokens in a batch, before any timing: every
    kernel the traffic runs is built and loaded here."""
    rng = np.random.default_rng(0)
    lens = (traffic["prompt"]["min"], traffic["prompt"]["max"])
    items = [TR.Item(prompt=rng.integers(0, vocab, n), max_new=4)
             for n in lens]
    reqs = make_requests(items)
    for r in reqs:
        engine.submit(r)
    wait_drained(engine, timeout)
    return reqs


def wait_drained(engine, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    with engine._all_done:
        while engine.outstanding > 0:
            left = deadline - time.monotonic()
            if left <= 0:
                return False
            engine._all_done.wait(min(left, 0.1))
    return True


@dataclasses.dataclass
class Run:
    requests: List            # every request sent, in order
    window: Tuple[float, float]
    start: float              # traffic start (monotonic)
    drained: bool


class Timers:
    """Callbacks due at fixed times (the trace's start and stop), run by
    the traffic loop between sends."""

    def __init__(self, events: List[Tuple[float, Callable]]):
        self.events = sorted(events, key=lambda e: e[0])

    def next_time(self) -> float:
        return self.events[0][0] if self.events else float("inf")

    def fire_due(self, now: float) -> None:
        while self.events and self.events[0][0] <= now:
            self.events.pop(0)[1]()


def _sleep_until(t: float, timers: Timers) -> None:
    while True:
        now = time.monotonic()
        timers.fire_due(now)
        wake = min(t, timers.next_time())
        if now >= t:
            return
        time.sleep(max(0.0, min(wake, t) - now))


def _send(engine, req, due: float) -> None:
    req.due = due
    req.arrival_time = due          # the engine keeps a set arrival time
    req.sent = time.monotonic()
    engine.submit(req)


def drive(engine, traffic: Dict, items: List[TR.Item], seed: int,
          seconds: float, timers_at: Optional[List] = None,
          drain_s: float = 120.0) -> Run:
    """Feed the cell's traffic, measure ``seconds`` after the lead-in, then
    send nothing more and wait until every request sent has ended.
    ``timers_at``: (seconds from the window's start, callback) pairs."""
    reqs = make_requests(items)
    t0 = time.monotonic()
    w0 = t0 + TR.lead_s(traffic)
    w1 = w0 + seconds
    timers = Timers([(w0 + dt, fn) for dt, fn in (timers_at or [])])
    sent: List = []
    if traffic["loop"] == "open":
        due = TR.arrivals(traffic, seed, seconds)
        for req, dt in zip(reqs, due):
            if t0 + dt >= w1:
                break
            _sleep_until(t0 + dt, timers)
            _send(engine, req, t0 + dt)
            sent.append(req)
    else:
        done: "queue.Queue" = queue.Queue()
        engine.on_request_done = lambda r: done.put((r, time.monotonic()))
        starts = [(t0 + float(s), c)
                  for c, s in enumerate(TR.client_starts(traffic))]
        it = iter(reqs)
        owner: Dict[int, int] = {}

        def send(client: int, due: float) -> None:
            req = next(it)
            owner[id(req)] = client
            _send(engine, req, due)
            sent.append(req)

        while True:
            now = time.monotonic()
            timers.fire_due(now)
            if now >= w1:
                break
            while starts and starts[0][0] <= now:
                send(starts[0][1], starts.pop(0)[0])
            wake = min(w1, timers.next_time(),
                       starts[0][0] if starts else float("inf"))
            try:
                r, at = done.get(timeout=max(1e-4, wake - now))
            except queue.Empty:
                continue
            if id(r) in owner and at < w1:
                send(owner[id(r)], at)
        engine.on_request_done = None
    _sleep_until(w1, timers)
    timers.fire_due(float("inf"))
    drained = wait_drained(engine, drain_s)
    return Run(requests=sent, window=(w0, w1), start=t0, drained=drained)

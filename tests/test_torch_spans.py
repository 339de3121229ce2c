"""Spans and counters inside the port's serving path (``core/spans.py``),
on the session's Timeline (``core/profiler.py``), on the CPU.

With ``FLEX_PROFILE=1`` a ``RealEngine`` on a reduced mixtral-8x7b serves
a few requests: every span is there with its parent, a request's spans
share its ``req_id``, each ``step.issue`` lies inside its op's dispatch and
completion, and a decode op's meta ``ctx`` holds its slots' lengths.  Off,
the engine has no timeline and makes no span.  Beside them: the map onto
the device trace's clock, and the Profiler's busy deque trimmed to its
horizon with ``device_utilization`` unchanged.
"""
import collections
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import profiler, spans
from repro_torch.core.api import OpDescriptor, OpType, Phase
from repro_torch.models import build_model
from repro_torch.predict import features
from repro_torch.sched.dispatch import PredictedSJFPolicy
from repro_torch.serving.engine import RealEngine
from repro_torch.serving.request import Request

ENGINE_SPANS = ("engine.submit", "engine.prefill_setup",
                "engine.prefill_done", "engine.slot_insert",
                "engine.decode_done")
MODEL_SPANS = ("attention", "moe", "logits")
COUNTERS = ("slots_active", "decode_pending", "waiting_admission",
            "prefilling")


@pytest.fixture(scope="module")
def mixtral():
    cfg = get_config("mixtral-8x7b").reduced()
    model = build_model(cfg)
    return cfg, model, model.init(0, device="cpu")


def serve(mixtral, n=6):
    """Serve n requests (prompts of 5-12 tokens, 3-8 new ones, 4 slots);
    returns the engine (shut down), its requests and the lengths the
    decode steps were given for the rows in use, in launch order."""
    cfg, model, params = mixtral
    rng = np.random.default_rng(1)
    reqs = [Request(prompt_len=int(p), max_new_tokens=int(m),
                    prompt_tokens=rng.integers(0, cfg.vocab_size,
                                               int(p)).tolist(),
                    arrival_time=0.005 * i)
            for i, (p, m) in enumerate(zip(rng.integers(5, 13, n),
                                           rng.integers(3, 9, n)))]
    eng = RealEngine(model, params, mode="dynamic_pd", max_num_seqs=4,
                     max_len=32, device="cpu")
    given = []
    decode, rep = eng._decode_fn, eng.replicas[0]

    def recorded(p, toks, cache, lens):
        rows = [s for s, r in enumerate(rep.slot_req) if r is not None]
        given.append(lens[rows].tolist())
        return decode(p, toks, cache, lens)

    eng._decode_fn = recorded
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        res = eng.run(reqs, timeout=120)
    finally:
        eng.shutdown()
        torch.set_num_threads(threads)
    assert res["completed"] == n
    return eng, reqs, given


@pytest.fixture(scope="module")
def traced(mixtral, tmp_path_factory):
    """A traced engine's run: the engine, its requests, the decode steps'
    lengths and its timeline's events."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLEX_PROFILE", "1")
        mp.setenv("FLEX_PROFILE_DIR", str(tmp_path_factory.mktemp("tl")))
        eng, reqs, given = serve(mixtral)
    return eng, reqs, given, eng.timeline.events()


def test_traced_engine_records_every_span(mixtral, traced):
    eng, reqs, given, events = traced
    assert profiler.ACTIVE is None          # cleared when it was written
    ops = {e["args"]["op_id"]: e for e in events
           if e["name"].endswith(":launch")}
    sp = [e for e in events if e.get("cat") == "span"]
    by_id = {s["args"]["id"]: s for s in sp}
    names = collections.Counter(s["name"] for s in sp)
    assert set(names) == set(ENGINE_SPANS + MODEL_SPANS + ("step.issue",))
    assert len(by_id) == len(sp)
    n_decode = sum(o["name"] == "decode:launch" for o in ops.values())
    assert names["step.issue"] == len(ops)
    assert names["engine.decode_done"] == n_decode
    layers = mixtral[0].num_layers
    assert names["attention"] == names["moe"] == layers * len(ops)
    assert names["logits"] == len(ops)

    def parent(s):
        return by_id.get(s["args"]["parent"])

    issue = {s["args"]["op_id"]: s for s in sp if s["name"] == "step.issue"}
    for s in sp:
        a = s["args"]
        if s["name"] in MODEL_SPANS:
            # inside its step, on the step's thread
            assert parent(s) is issue[a["op_id"]]
        elif s["name"] == "engine.slot_insert":
            assert parent(s)["name"] in ("engine.prefill_done",
                                         "engine.decode_done")
        elif s["name"] == "engine.prefill_setup":
            assert parent(s)["name"] in ("engine.submit",
                                         "engine.prefill_done",
                                         "engine.decode_done")
        else:                   # the top of a thread: linked by op or request
            assert a["parent"] is None
            assert a.get("op_id") in ops or s["name"] == "engine.submit"
    # each step's issue lies inside its op's dispatch and completion
    for op_id, s in issue.items():
        o = ops[op_id]
        assert o["ts"] <= s["ts"] <= s["ts"] + s["dur"] <= o["ts"] + o["dur"]
        kind = o["name"].split(":")[0]
        assert s["args"]["kind"] == kind
        # one host readback a MoE layer in the sorted prefill dispatch,
        # none in decode's batched one
        assert s["args"]["readbacks"] == (layers if kind == "prefill" else 0)
    assert {s["args"]["op_id"] for s in sp
            if s["name"] == "engine.decode_done"} == {
        i for i, o in ops.items() if o["name"] == "decode:launch"}
    # a request's spans share its id
    for r in reqs:
        mine = collections.Counter(s["name"] for s in sp
                                   if s["args"].get("req_id") == r.req_id)
        assert mine["engine.submit"] == mine["engine.prefill_setup"] == 1
        assert mine["engine.prefill_done"] == mine["step.issue"] == 1
        assert mine["engine.slot_insert"] == (r.max_new_tokens > 1)
        pre = [o for o in ops.values() if o["name"] == "prefill:launch"
               and o["args"]["req_id"] == r.req_id]
        assert len(pre) == 1
        assert issue[pre[0]["args"]["op_id"]]["args"]["req_id"] == r.req_id
    # decode ops: ctx holds the slots' lengths, req_id the rows' requests
    decodes = sorted((o for o in ops.values()
                      if o["name"] == "decode:launch"),
                     key=lambda o: o["args"]["op_id"])
    assert [o["args"]["ctx"] for o in decodes] == given
    steps = collections.defaultdict(list)
    for o in decodes:
        assert len(o["args"]["ctx"]) == len(o["args"]["req_id"]) \
            == o["args"]["tokens"]
        for rid, n in zip(o["args"]["req_id"], o["args"]["ctx"]):
            steps[rid].append(n)
    for r in reqs:      # a request's k-th decode step attends prompt + k
        want = list(range(r.prompt_len, r.prompt_len + r.max_new_tokens - 1))
        assert steps[r.req_id] == want
    # four counters at each decode launch
    counts = collections.Counter(e["name"] for e in events
                                 if e["ph"] == "C")
    assert counts == {c: n_decode for c in COUNTERS}


def test_untraced_engine_makes_no_span(mixtral, monkeypatch):
    monkeypatch.delenv("FLEX_PROFILE", raising=False)
    made = []
    for cls in (spans.Span, spans.Step):
        init = cls.__init__
        monkeypatch.setattr(cls, "__init__",
                            lambda self, *a, _i=init, **k:
                            (made.append(self), _i(self, *a, **k))[1])
    eng, _, _ = serve(mixtral, n=3)
    assert eng.timeline is None and eng.session.timeline is None
    assert all(d.timeline is None for d in eng.session.daemons)
    assert made == []


def test_profiler_clock_map_interpolates_between_anchors(tmp_path):
    was = profiler.ACTIVE
    try:
        tl = profiler.Timeline()
        assert profiler.ACTIVE is tl
        # anchors (monotonic, Unix): offset 1000 at 0, 1100 at 1000
        tl._anchors = [(0, 1000), (1000, 2100)]
        assert tl.to_profiler_ns(-50) == -50 + 1000
        assert tl.to_profiler_ns(500) == 500 + 1050
        assert tl.to_profiler_ns(2000) == 2000 + 1100
        tl.events()                         # a read takes an anchor
        assert len(tl._anchors) == 3
        m, u = tl._anchors[-1]
        assert abs(tl.to_profiler_ns(m) - u) < 1e-3
        tl.dump(str(tmp_path / "t.json"))
        assert profiler.ACTIVE is None
    finally:
        profiler.ACTIVE = was


def test_real_clock_anchor_pairs_the_two_clocks():
    import time
    m, u = profiler._clock_anchor()
    off = time.time_ns() - time.monotonic_ns()
    assert abs((u - m) - off) < 5e6         # 5 ms: a scheduler's slice


def _launch(t0, t1):
    op = OpDescriptor(OpType.LAUNCH, phase=Phase.DECODE)
    op.dispatch_time, op.complete_time = t0, t1
    return op


def test_busy_events_trimmed_to_the_horizon_utilization_unchanged():
    prof = profiler.Profiler(horizon=2.0)
    done = []
    rng = np.random.default_rng(0)
    t = 0.0
    for i in range(400):
        d = float(rng.uniform(0.01, 0.2))
        gap = float(rng.uniform(0.0, 0.1))
        prof.on_complete(_launch(t + gap, t + gap + d))
        done.append((t + gap, t + gap + d))
        t += gap + d
        # never more than the horizon's worth of launches kept
        assert all(e >= t - 2.0 for _, e in prof._busy_events)
        if i % 37 == 0:
            now = t + float(rng.uniform(0, 1.0))
            lo = now - 2.0
            want = sum(min(e, now) - max(s, lo) for s, e in done
                       if min(e, now) > max(s, lo))
            assert prof.device_utilization(now) == pytest.approx(
                min(1.0, want / 2.0), abs=1e-12)
    assert len(prof._busy_events) < 60


def test_phase_stats_keep_what_the_policy_reads():
    prof = profiler.Profiler()
    op = _launch(0.0, 0.01)
    op.meta["bytes"] = 3.35e10 * 0.01 / 100
    prof.on_complete(op)
    s = prof.stats[Phase.DECODE]
    assert s.ewma_exec == pytest.approx(0.01)
    assert prof.decode_bandwidth_util() == pytest.approx(
        s.ewma_bytes / 0.01 / profiler.HBM_BW_BYTES)
    for gone in ("ewma_flops", "ops_completed", "tokens_done", "busy_time",
                 "compute_util"):
        assert not hasattr(s, gone)
    assert not hasattr(prof, "snapshot")


def test_traced_ctx_changes_no_prediction(traced):
    """A decode op's ``ctx`` exists only while traced: the latency
    predictor's features and the policy read the op as if untraced."""
    events = traced[3]
    ops = [e for e in events if e["name"].endswith(":launch")]
    assert any(isinstance(e["args"].get("ctx"), list) for e in ops)
    bare = [dict(e, args={k: v for k, v in e["args"].items()
                          if k != "ctx"}) for e in ops]
    assert features.samples_from_events(ops) == \
        features.samples_from_events(bare)

    class Latency:
        def predict(self, phase, tokens, ctx):
            return 1e-3 * tokens + 1e-6 * ctx

    policy = PredictedSJFPolicy()
    policy.bind_predictor(Latency())
    for e in ops:
        traced_op = OpDescriptor(OpType.LAUNCH, phase=Phase.DECODE,
                                 meta=dict(e["args"]))
        untraced = OpDescriptor(OpType.LAUNCH, phase=Phase.DECODE,
                                meta={"tokens": e["args"]["tokens"]})
        assert policy._predicted(traced_op) == policy._predicted(untraced)


def test_span_cost_summary_of_a_traced_run(mixtral, traced):
    """``scripts/span_cost.py``'s summary: each span a step, the logits'
    product (widened on the CPU), the host readbacks a step, the
    counters' means at each decode launch."""
    path = Path(__file__).resolve().parents[1] / "scripts" / "span_cost.py"
    spec = importlib.util.spec_from_file_location("span_cost", path)
    span_cost = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(span_cost)
    eng, reqs, _, events = traced
    got = span_cost.summarize(events)
    layers = mixtral[0].num_layers
    for kind in ("prefill", "decode"):
        assert got["a_step"][f"{kind}/step.issue"] == 1
        assert got["a_step"][f"{kind}/attention"] == layers
        assert got["a_step"][f"{kind}/moe"] == layers
        assert got["a_step"][f"{kind}/logits"] == 1
        assert got["host_ms"][f"{kind}/attention"] > 0
        assert set(got["products"][f"{kind}/logits"]) == {"widened_f32"}
    assert got["readbacks"] == {"prefill": layers, "decode": 0}
    assert got["stream_ms"] == {}           # CUDA events only on a card
    assert set(got["counters"]) == set(COUNTERS)
    launches = [e for e in events if e["name"] == "decode:launch"]
    assert got["counters"]["slots_active"] == pytest.approx(
        np.mean([e["args"]["tokens"] for e in launches]))
    # the engine's own spans with no op are a request's
    assert got["a_step"]["-/engine.submit"] == 1
    assert {k for k in got["host_ms"] if k.startswith("-/")} == {
        "-/engine.submit", "-/engine.prefill_setup", "-/engine.slot_insert"}
    # kept ops only: the decode steps dropped, their spans go too
    keep = {e["args"]["op_id"] for e in events
            if e["name"] == "prefill:launch"}
    assert not any(k.startswith("decode/")
                   for k in span_cost.summarize(events, keep)["host_ms"])


def test_one_step_of_a_kind_in_timed_every_takes_cuda_events(monkeypatch):
    """On a card a traced step takes CUDA events (its spans' stream times)
    once in ``TIMED_EVERY`` steps of its kind, whatever the other kind
    does; off a card never."""
    import itertools
    monkeypatch.setattr(spans, "_STEPS",
                        collections.defaultdict(itertools.count))
    was = profiler.ACTIVE
    tl = profiler.Timeline()
    try:
        kinds = ["decode", "prefill", "decode"] * (4 * spans.TIMED_EVERY)
        timed = [spans.Step(tl, k, None, True).cuda for k in kinds]
        assert not any(spans.Step(tl, "decode", None, False).cuda
                       for _ in range(2 * spans.TIMED_EVERY))
    finally:
        profiler.ACTIVE = was
    for kind in ("decode", "prefill"):
        mine = [t for k, t in zip(kinds, timed) if k == kind]
        assert mine[::spans.TIMED_EVERY] == [True] * (
            len(mine) // spans.TIMED_EVERY)
        assert sum(mine) == len(mine) // spans.TIMED_EVERY

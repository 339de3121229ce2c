#!/usr/bin/env python3
"""What the serving path's spans cost, and what they show, on the card.

    python3 scripts/span_cost.py cost --cells <cell>... --seeds <n>...
    python3 scripts/span_cost.py traced --cells <cell>... --seeds <n>...
    python3 scripts/span_cost.py step --cells <cell>... --seeds <n>

Each run is a process of its own, serving a benchmark cell for the
benchmark's ``run_seconds`` through ``flexbench/run.py``'s ``run_cell``.
``cost`` runs each cell untraced (no device trace) with the program's
timeline, spans and counters on (``FLEX_PROFILE=1``) and off, each seed in
turns (off, on; then on, off), and prints every run's end-to-end metrics
and each side's medians.  ``traced`` makes ``run.py``'s traced run and
prints, beside its per-layer metrics, the device's launches a decode step,
the cross-check of ``decode_issue_idle_ms`` against the breakdown's idle
time inside decode ops, and the spans summed by name (:func:`summarize`).
A ``cost`` run with the timeline on prints that summary too.  ``step``
times one decode step of each cell's model (every slot in use, contexts
of 1,024) in turns with tracing off, with spans but no CUDA events, as
traced (CUDA events on one step in ``spans.TIMED_EVERY``) and with every
step timed: the means of the host's issue time, of the step's time to the
card's end, and of the traced step's completion.  Lines go to
``bench-out/span_cost.jsonl`` as well.  Exits 2 without a CUDA card, as
``run.py`` does.
"""
import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "bench-out" / "span_cost.jsonl"
E2E = ("ttft_p95_ms", "tpot_p95_ms", "output_tokens_per_s", "setup_s")


def summarize(events, keep=None):
    """Spans and counters of a timeline's events, by step kind: each
    span's mean and median host time, mean stream time and count a step,
    the logits' spans counted by the product they name, the readbacks a
    step, each counter's mean.  ``keep``: the op ids to
    read (all where None, the set-up's first steps among them)."""
    kind = {e["args"]["op_id"]: e["name"].split(":")[0] for e in events
            if e.get("ph") == "X" and e["name"].endswith(":launch")
            and (keep is None or e["args"]["op_id"] in keep)}
    reqs = {e["args"]["req_id"] for e in events
            if e.get("ph") == "X" and e["args"].get("op_id") in kind
            and e["name"] == "prefill:launch"}
    host, stream, readbacks, counters, products = {}, {}, {}, {}, {}
    for e in events:
        if e.get("ph") == "C":
            counters.setdefault(e["name"], []).append(e["args"][e["name"]])
            continue
        if e.get("cat") != "span":
            continue
        a = e["args"]
        if a.get("op_id") is not None:
            if a["op_id"] not in kind:
                continue
            k = kind[a["op_id"]]
        elif a.get("req_id") in reqs:
            k = "-"
        else:
            continue
        key = f"{k}/{e['name']}"
        if "product" in a:              # the logits' product (models/model.py)
            n = products.setdefault(key, {})
            n[a["product"]] = n.get(a["product"], 0) + 1
        host.setdefault(key, []).append(e["dur"] / 1e3)
        if "stream_ms" in a:
            stream.setdefault(key, []).append(a["stream_ms"])
        if e["name"] == "step.issue":
            readbacks.setdefault(k, []).append(a["readbacks"])
    steps = {k.split("/")[0]: len(v) for k, v in host.items()
             if k.endswith("/step.issue")}
    mean = statistics.fmean
    return {"host_ms": {k: mean(v) for k, v in sorted(host.items())},
            "host_ms_median": {k: statistics.median(v)
                               for k, v in sorted(host.items())},
            "stream_ms": {k: mean(v) for k, v in sorted(stream.items())},
            "a_step": {k: len(v) / steps.get(k.split("/")[0], len(v))
                       for k, v in sorted(host.items())},
            "products": products,
            "readbacks": {k: mean(v) for k, v in readbacks.items()},
            "counters": {k: mean(v) for k, v in counters.items()}}


def _one(cell_name: str, seed: int, profile: int, trace: int) -> int:
    """One run in this process; prints its line after ``SPANCOST``."""
    spec_ = importlib.util.spec_from_file_location(
        "flexbench_run", ROOT / "flexbench" / "run.py")
    run = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(run)
    run.environment(bool(trace))            # sets FLEX_PROFILE to trace
    os.environ["FLEX_PROFILE"] = str(profile)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="span_cost_", dir=ROOT / "build")
    os.environ["FLEX_PROFILE_DIR"] = tmp    # the untraced timeline's file
    from flexbench.lib import spec, spans
    from repro_torch.core import profiler
    seen = {}
    read = spec.read_metrics

    def read_metrics(cell, view, here=spec.HERE):
        # the traced run's view, while its timeline is still the active one
        keep = {o["args"]["op_id"] for o in view.ops}
        launches = [len(ks) for _, ks in view.steps_in_span("decode")]
        idle = spans.decode_issue_idle_ms(view)
        seen.update(spans=summarize(profiler.ACTIVE.events(), keep),
                    launches_a_decode_step=statistics.fmean(launches)
                    if launches else None,
                    decode_steps_in_subwindow=len(idle),
                    idle_inside_issue_s=sum(idle) / 1e3)
        return read(cell, view, here)

    spec.read_metrics = read_metrics
    cell = spec.load_cell(cell_name, ROOT)
    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())[
        "run_seconds"]
    res = run.run_cell(cell, seed, seconds, bool(trace), "cuda",
                       run.T_PROCESS)
    line = {"cell": cell_name, "seed": seed, "profile": profile,
            "trace": trace, "correct": res["correct"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "device": res["device"]}
    if trace:
        line.update(seen, breakdown=res["breakdown"],
                    breakdown_decode_op_idle_s=dict(
                        res["breakdown"]["idle_gaps"]).get(
                        "host issuing a decode op"))
    for name in os.listdir(tmp):
        if profile and not trace:
            with open(os.path.join(tmp, name)) as f:
                line["spans"] = summarize(json.load(f)["traceEvents"])
        os.remove(os.path.join(tmp, name))
    os.rmdir(tmp)
    print("SPANCOST " + json.dumps(line), flush=True)
    return 0


def _step_cost(cell_name: str, seed: int, n: int = 48) -> int:
    """One cell's decode step, untraced and traced, timed in this process;
    prints its line after ``SPANCOST``."""
    from types import SimpleNamespace

    import torch

    from flexbench.lib import serve, spec, weights
    from repro_torch.core import profiler, spans
    from repro_torch.models import build_model
    cell = spec.load_cell(cell_name, ROOT)
    model = build_model(serve.model_config(cell.config["model"]))
    params = weights.make(model, seed, "cuda", cell.config.get("init"))
    rows = int(cell.engine["max_num_seqs"])
    cache = model.init_cache(rows, int(cell.engine["max_len"]),
                             device="cuda")
    toks = torch.zeros(rows, dtype=torch.long, device="cuda")
    lens = torch.full((rows,), 1024, dtype=torch.int32, device="cuda")
    tl = profiler.Timeline()
    every = spans.TIMED_EVERY
    times = {v: {"issue_ms": [], "step_ms": [], "complete_ms": []}
             for v in ("off", "spans", "traced", "timed")}
    for i in range(n + every):              # the first ones: warm-up
        for v, t in times.items():
            profiler.ACTIVE = None if v == "off" else tl
            spans.TIMED_EVERY = 1 if v == "timed" else every
            # a kind of its own for "timed": the traced steps' count
            fn = model.decode if v == "off" else spans.Step(
                tl, "timed" if v == "timed" else "decode", model.decode,
                v != "spans", rows=rows)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(params, toks, cache, lens)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if v != "off":
                fn.complete(tl, SimpleNamespace(op_id=i))
            t3 = time.perf_counter()
            if i >= every:
                t["issue_ms"].append(1e3 * (t1 - t0))
                t["step_ms"].append(1e3 * (t2 - t0))
                t["complete_ms"].append(1e3 * (t3 - t2))
    profiler.ACTIVE, spans.TIMED_EVERY = None, every
    mean = {v: {k: statistics.fmean(x) for k, x in t.items()}
            for v, t in times.items()}
    print("SPANCOST " + json.dumps({"cell": cell_name, "seed": seed,
                                    "step_mean": mean, "steps": n}),
          flush=True)
    return 0


def spawn(cell: str, seed: int, profile: int = 0, trace: int = 0,
          step: bool = False):
    """Run ``_one`` (or, with ``step``, ``_step_cost``) in a process of its
    own; returns its line."""
    what = "step" if step else f"profile {profile} trace {trace}"
    cmd = [sys.executable, __file__, "one", cell, str(seed),
           "step" if step else f"{profile},{trace}"]
    t = time.monotonic()
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("SPANCOST ")]
    if p.returncode or not lines:
        print(f"{cell} seed {seed} {what}: exit {p.returncode}\n"
              f"{p.stderr[-3000:]}", flush=True)
        return None
    line = json.loads(lines[-1][len("SPANCOST "):])
    line["wall_s"] = time.monotonic() - t
    OUT.parent.mkdir(exist_ok=True)
    with open(OUT, "a") as f:
        f.write(json.dumps(line) + "\n")
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    if argv is None and sys.argv[1:2] == ["one"]:   # a run spawned below
        cell, seed, what = sys.argv[2:5]
        if what == "step":
            return _step_cost(cell, int(seed))
        profile, trace = map(int, what.split(","))
        return _one(cell, int(seed), profile, trace)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("cost", "traced", "step"))
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("span_cost.py needs a CUDA card; found none", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    for cell in args.cells:
        lines = []
        for i, seed in enumerate(args.seeds):
            if args.mode == "traced":
                lines.append(spawn(cell, seed, 1, 1))
                continue
            if args.mode == "step":
                lines.append(spawn(cell, seed, step=True))
                continue
            for profile in ((0, 1) if i % 2 == 0 else (1, 0)):
                lines.append(spawn(cell, seed, profile, 0))
        if args.mode == "cost":
            for profile in (0, 1):
                got = [ln for ln in lines if ln and ln["profile"] == profile]
                med = {k: statistics.median(ln["metrics"][k] for ln in got)
                       for k in E2E if got}
                print(f"{cell} FLEX_PROFILE={profile}: medians {med}, "
                      f"correct {[ln['correct'] for ln in got]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

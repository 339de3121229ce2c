#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card this process finds.

    python3 flexbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Reads ``BENCHMARK.json`` at the checkout's root and the cell's files
under ``flexbench/``; serves the cell's traffic through the port's
``RealEngine`` (``repro_torch``, ``mode="dynamic_pd"``) for ``--seconds``
after a lead-in; checks what was served against the plain reference; and
prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``compared`` (each number the check compared, beside
its limit; also the last lines on standard error).

Exits 2 without a result where there is no CUDA card or fewer than the
cell asks for, and 3 where JAX, flax or the JAX package ``repro`` is
loaded once the window has closed.
"""
import time

T_PROCESS = time.monotonic()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_AT = 0.4            # the device trace starts this far into the window
TRACE_S = 4.0             # and lasts at most this long


def environment(trace: bool) -> None:
    """Caches inside the checkout, at fixed paths; the engine's op
    timeline on only in the traced run; nothing that loads JAX."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["FLEX_PROFILE"] = "1" if trace else "0"
    os.environ["FLEX_SANITIZE"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(device, chips: int):
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def _finite(x: float) -> float:
    return x if math.isfinite(x) else 1e12


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device,
             t_process: float, here: Path = None) -> dict:
    """One run of ``cell`` (a ``spec.Cell``); returns the result line."""
    import torch

    from flexbench.lib import check, e2e, serve, spec, trace, weights
    from flexbench.lib import traffic as TR
    from repro_torch.models import build_model
    from repro_torch.serving.request import RequestState

    here = here or spec.HERE
    model_file = cell.config["model"]
    model = build_model(serve.model_config(model_file))
    vocab = int(model_file["vocab_size"])
    t = time.monotonic()
    params = weights.make(model, seed, device, cell.config.get("init"))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    log(f"weights {time.monotonic() - t:.3f} s")
    eng = serve.build_engine(model, params, cell.engine, device)
    window = int(model_file.get("sliding_window", 0))
    ring = min(int(cell.engine["max_len"]), window) if window else 0
    recorder = trace.Recorder(eng, ring) if trace_on else None
    devtrace = trace.DeviceTrace(torch.device(device).type == "cuda") \
        if trace_on else None
    timers = []
    if trace_on:
        devtrace.prime()
        at = TRACE_AT * seconds
        timers = [(at, devtrace.start),
                  (at + min(TRACE_S, 0.25 * seconds), devtrace.stop)]
    t = time.monotonic()
    serve.warm_up(eng, cell.traffic, vocab)
    log(f"warm-up {time.monotonic() - t:.3f} s")
    items = TR.items(cell.traffic, seed, vocab, seconds)
    if trace_on:
        # a collection that walks set-up's objects while the profiler
        # stops has aborted the process; frozen, they are not walked.
        # Only the traced run: the end-to-end runs serve as the port does
        gc.freeze()
    run = serve.drive(eng, cell.traffic, items, seed, seconds, timers)
    if trace_on:
        gc.unfreeze()
    setup_s = run.window[0] - t_process
    dev = device_info(device, cell.chips)
    result = {"correct": False, "attempted": len(e2e.due_in_window(run)),
              "failed": sum(e2e.missing(r) for r in e2e.due_in_window(run))}
    if trace_on:
        devtrace.collect()
        # how long starting and stopping the profiler held the host
        held = max(0.0, devtrace.host[1] - devtrace.host[0]
                   - (devtrace.span[1] - devtrace.span[0]) / 1e9)
        events = eng.session.timeline.events()
        eng.session.timeline = None     # nothing written at close
        view = trace.View(model=model_file, engine=cell.engine,
                          window=run.window,
                          ops=trace.window_ops(events, run.window,
                                               devtrace.host, held),
                          steps=recorder.steps, span=devtrace.span,
                          kernels=devtrace.kernels)
        result["metrics"] = spec.read_metrics(cell, view, here)
        dev["busy_s"] = trace.busy_s(view)
        dev["window_s"] = trace.span_s(view)
        result["device"] = dev
        result["breakdown"] = trace.breakdown(
            dataclasses.replace(view, ops=trace.window_ops(events,
                                                            run.window)),
            trace.clock_offset_ns())
        log(f"device trace: start and stop held the host {held:.3f} s "
            f"beyond its {trace.span_s(view):.3f} s")
    else:
        values = dict(e2e.end_to_end(run), setup_s=setup_s)
        result["metrics"] = {m["name"]: {"value": _finite(values[m["name"]]),
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = dev
    late = e2e.lateness_ms(run)
    log(f"sent {len(run.requests)}, due in window {result['attempted']}, "
        f"missing {result['failed']}, drained {run.drained}, send lateness "
        f"ms p50 {late['p50']:.3f} max {late['max']:.3f}, set-up "
        f"{setup_s:.3f} s")

    finished = [r for r in run.requests if r.state == RequestState.DONE]
    eng.shutdown()
    del eng, recorder, run
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    limits = cell.traffic["check"]
    reqs = check.sample(finished, seed, limits["min_tokens"],
                        limits["min_requests"], limits["max_requests"])
    t = time.monotonic()
    ref = spec.reference(cell.config["reference"])
    cmp = check.compare(ref, params, model_file, reqs, device) if reqs \
        else {}
    log(f"reference over {len(reqs)} requests "
        f"{time.monotonic() - t:.3f} s")
    v = check.verdict(cmp, reqs, limits)
    result["correct"] = v["correct"]
    result["compared"] = {k: {"value": c["value"], "limit": c["limit"],
                              "holds": c["holds"]}
                          for k, c in v["checks"].items()}
    return result


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment(bool(args.trace))
    from flexbench.lib import spec
    cell = spec.load_cell(args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_PROCESS)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process once the window had closed: {found}")
        return 3
    compared = result.pop("compared")
    result["compared"] = compared           # the key that comes last
    for k, c in compared.items():
        word = "at most" if c["holds"] == "max" else "at least"
        log(f"compared {k} {c['value']} limit ({word}) {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

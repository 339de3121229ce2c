#!/usr/bin/env python3
"""Start and stop the benchmark's device trace again and again while a
cell is served traced, to see whether stopping it crashes the process.

    python3 scripts/profiler_stop_stress.py <cell> <seed> [--no-events]

Serves the cell's traffic for the benchmark's ``run_seconds`` with the
program's timeline on (``FLEX_PROFILE=1``) and set-up's objects frozen, as
``flexbench/run.py``'s traced run does, but starts
``flexbench/lib/trace.py::DeviceTrace`` every 2 s and stops it a second
later, printing each stop it survives.  ``faulthandler`` prints every
thread's stack if the process dies.  ``--no-events``: the engine's traced
steps take no CUDA events.  Needs a CUDA card.
"""
import faulthandler
import gc
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PERIOD_S = 2.0


def main() -> int:
    faulthandler.enable(all_threads=True)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    os.environ.update(FLEX_PROFILE="1", FLEX_SANITIZE="0", USE_JAX="0",
                      PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
                      TRITON_CACHE_DIR=str(ROOT / "build" / "triton"))
    cell_name, seed = sys.argv[1], int(sys.argv[2])
    from flexbench.lib import serve, spec, trace, weights
    from flexbench.lib import traffic as TR
    from repro_torch.models import build_model
    cell = spec.load_cell(cell_name, ROOT)
    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())[
        "run_seconds"]
    model_file = cell.config["model"]
    vocab = int(model_file["vocab_size"])
    model = build_model(serve.model_config(model_file))
    params = weights.make(model, seed, "cuda", cell.config.get("init"))
    eng = serve.build_engine(model, params, cell.engine, "cuda")
    if "--no-events" in sys.argv:
        eng._cuda = False
    dev = trace.DeviceTrace(True)
    dev.prime()
    serve.warm_up(eng, cell.traffic, vocab)
    items = TR.items(cell.traffic, seed, vocab, seconds)
    stops = [0]

    def stop():
        dev.stop()
        dev.collect()
        stops[0] += 1
        print(f"stop {stops[0]} survived, {len(dev.kernels)} kernels",
              flush=True)

    timers, t = [], 0.5
    while t + 1.5 < seconds:
        timers += [(t, dev.start), (t + 1.0, stop)]
        t += PERIOD_S
    gc.freeze()
    serve.drive(eng, cell.traffic, items, seed, seconds, timers)
    gc.unfreeze()
    print(f"{stops[0]} stops survived", flush=True)
    eng.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())

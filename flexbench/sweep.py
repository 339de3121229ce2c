#!/usr/bin/env python3
"""The knee of an open-loop cell: its traffic at each of a few fixed
rates, one after another in one process on one engine.

    python3 flexbench/sweep.py --workload <cell> --seed <n> \\
        --seconds <s> --rates <r> [<r> ...]

A rate is sustained when the requests in the system (sent, not yet
ended) do not grow through the window: one JSON line a rate with that
count at the window's start and end, the share of due requests still
without a first token at the window's end, and the end-to-end metrics.
The sweep stops at the first rate whose count doubles through the window
(past the knee the engine admits every prompt, and each admitted prompt
holds a cache of ``max_len`` slots until a decode slot frees).
The cell's rate is set once from this sweep, at about four fifths of the
highest rate sustained; the benchmark's runs never search for a rate.
"""
import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    import importlib.util
    s = importlib.util.spec_from_file_location("flexbench_run",
                                               ROOT / "flexbench" / "run.py")
    run = importlib.util.module_from_spec(s)
    s.loader.exec_module(run)
    run.environment(False)
    import torch

    from flexbench.lib import e2e, serve, spec, weights
    from flexbench.lib import traffic as TR
    from repro_torch.models import build_model

    cell = spec.load_cell(args.workload, ROOT)
    mf = cell.config["model"]
    model = build_model(serve.model_config(mf))
    params = weights.make(model, args.seed, "cuda", cell.config.get("init"))
    eng = serve.build_engine(model, params, cell.engine, "cuda")
    serve.warm_up(eng, cell.traffic, mf["vocab_size"])
    for rate in args.rates:
        traffic = copy.deepcopy(cell.traffic)
        traffic["arrival"]["rate"] = rate
        items = TR.items(traffic, args.seed, mf["vocab_size"], args.seconds)
        seen = {}
        marks = [i * args.seconds / 6 for i in range(6)] + \
            [args.seconds - 1e-3]
        timers = [(t, lambda t=t: seen.__setitem__(t, eng.outstanding))
                  for t in marks]
        r = serve.drive(eng, traffic, items, args.seed, args.seconds, timers,
                        drain_s=90.0)
        due = e2e.due_in_window(r)
        late = sum(1 for q in due if not q.times or q.times[0] >= r.window[1])
        counts = [seen.get(t) for t in marks]
        row = dict(rate=rate, in_system_w0=counts[0],
                   in_system_w1=counts[-1], in_system=counts,
                   no_first_token_at_close=late / max(1, len(due)),
                   due=len(due), drained=r.drained,
                   **e2e.end_to_end(r))
        print(json.dumps(row), flush=True)
        if not r.drained or row["in_system_w1"] > 2 * row["in_system_w0"]:
            break                   # past the knee: the backlog grows
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

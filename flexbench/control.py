#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the card.

    python3 flexbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> [<n> ...]

For each seed, in one process: the cell's weights and engine, its traffic
for ``--seconds`` after the lead-in, drained; then the check's sample
through the fp32 reference (the program's readings) and through the
control, the reference in fp8 (and int4 where the configuration caches
int8), each reading the gap of the token it puts first.  One JSON line a
seed on standard output, then one with the program's largest and the
control's smallest reading of each number.  The limits in the cell's
traffic file lie between the two.  The benchmark's own runs never run
the control.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def one_seed(cell, model, ref, seed: int, seconds: float, device,
             warm: bool = False) -> dict:
    """One seed's readings: the program's and the control's."""
    import torch

    from flexbench.lib import check, serve, weights
    from flexbench.lib import traffic as TR
    from repro_torch.serving.request import RequestState

    mf, limits = cell.config["model"], cell.traffic["check"]
    params = weights.make(model, seed, device, cell.config.get("init"))
    eng = serve.build_engine(model, params, cell.engine, device)
    if warm:
        serve.warm_up(eng, cell.traffic, mf["vocab_size"])
    items = TR.items(cell.traffic, seed, mf["vocab_size"], seconds)
    r = serve.drive(eng, cell.traffic, items, seed, seconds)
    done = [q for q in r.requests if q.state == RequestState.DONE]
    eng.shutdown()
    del eng, r
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    reqs = check.sample(done, seed, limits["min_tokens"],
                        limits["min_requests"], limits["max_requests"])
    return dict(check.compare(ref, params, mf, reqs, device, control=True),
                seed=seed, requests=len(reqs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import importlib.util
    s = importlib.util.spec_from_file_location("flexbench_run",
                                               ROOT / "flexbench" / "run.py")
    run = importlib.util.module_from_spec(s)
    s.loader.exec_module(run)
    run.environment(False)
    import torch

    from flexbench.lib import serve, spec
    from repro_torch.models import build_model

    cell = spec.load_cell(args.workload, ROOT)
    model = build_model(serve.model_config(cell.config["model"]))
    ref = spec.reference(cell.config["reference"])
    rows = []
    for i, seed in enumerate(args.seeds):
        t = time.monotonic()
        row = one_seed(cell, model, ref, seed, args.seconds, "cuda",
                       warm=i == 0)
        row["seconds"] = time.monotonic() - t
        gc.collect()
        torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"workload": args.workload,
               "card": torch.cuda.get_device_name(0)}
    for k in ("gap", "gap_mean"):
        summary[f"program_{k}_max"] = max(r[k] for r in rows)
        summary[f"control_{k}_min"] = min(r[f"control_{k}"] for r in rows)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

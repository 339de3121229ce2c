"""Adding a cell and a per-layer metric is adding files and entries: a
throwaway cell (gamma arrivals) and a throwaway metric, written into a
checkout in a temporary directory, are found by name and run, traced."""
import json

import flexbench_tiny as tiny

READER = '''"""Throwaway: prefill ops in the window."""


def read(view):
    return float(len(view.ops_of("prefill"))) or None
'''


def test_new_cell_and_metric_are_found_by_name(tmp_path):
    root = tiny.make(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    here = root / "flexbench"
    new = "mixtral-8x7b-l8.burst"
    t = json.loads((here / "workloads" / "mixtral-8x7b-l8.chat.json")
                   .read_text())
    t["arrival"] = {"process": "gamma", "rate": 8.0, "cv": 3.0}
    (here / "workloads" / f"{new}.json").write_text(json.dumps(t))
    bench["workloads"].append({"name": new, "config": "mixtral-8x7b-l8",
                               "traffic": "burst", "chips": 1,
                               "why": "throwaway"})
    (here / "metrics" / "prefill_ops.py").write_text(READER)
    bench["per_layer"].append({"name": "prefill_ops", "unit": "ops",
                               "better": "lower",
                               "source": "program_counter",
                               "layer": "engine: serving/engine.py",
                               "moves": "ttft_p95_ms", "workloads": [new]})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append(new)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = tiny.run(root, new, seconds=3.0, trace=True)
    assert res["correct"], res["compared"]
    assert res["metrics"]["prefill_ops"]["value"] >= 1
    assert "decode_step_ms" in res["metrics"]
    # the device readers find no device events off a card: left out
    assert "idle_share" not in res["metrics"]
    assert res["device"]["window_s"] > 0 and "breakdown" in res

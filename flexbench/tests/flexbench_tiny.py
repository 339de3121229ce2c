"""Tiny copies of the benchmark's cells for the CPU tests: the same files,
laid out as in a checkout (``BENCHMARK.json`` at a root, the cell's files
under ``flexbench/``), at smoke widths, with a short lead-in."""
from __future__ import annotations

import contextlib
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {
    "mixtral-8x7b-l8": dict(num_layers=2, d_model=64, num_heads=4,
                            num_kv_heads=2, head_dim=16, d_ff=128,
                            vocab_size=512),
    "nemotron-4-340b-l4": dict(num_layers=2, d_model=96, num_heads=6,
                               num_kv_heads=2, head_dim=16, d_ff=192,
                               vocab_size=512),
}
ENGINE = {"mode": "dynamic_pd", "max_num_seqs": 4, "max_len": 48}
TRAFFIC = {
    "open": {"loop": "open", "arrival": {"process": "poisson", "rate": 16.0},
             "warm_s": 0.5},
    "closed": {"loop": "closed", "clients": 4, "ramp_s": 0.3,
               "warm_s": 0.2, "pool": 256},
}
LENGTHS = {"prompt": {"dist": "lognormal", "mean": 6, "cv": 1.0, "min": 2,
                      "max": 12},
           "output": {"dist": "lognormal", "mean": 12, "cv": 1.0, "min": 4,
                      "max": 30}}
# every finished request is compared.  At smoke width the served tokens'
# mean gap reads 0.0001-0.002 and the fp8 control's 0.01-0.02; the widest
# gap of the dense model 0.016-0.026 against the control's 0.25-0.35,
# while the MoE model's swings to 0.8 (a near tie routed the other way)
CHECK = {"gap_mean_limit": 0.006, "min_tokens": 24, "min_requests": 64,
         "max_requests": 64}
GAP_LIMIT = {"mixtral-8x7b-l8.chat": None, "nemotron-4-340b-l4.docs": 0.1}


def make(tmp: Path) -> Path:
    """A checkout-like root under ``tmp`` holding every cell of the real
    ``BENCHMARK.json`` at smoke size; returns the root."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    here = tmp / "flexbench"
    for d in ("configs", "workloads", "metrics"):
        (here / d).mkdir(parents=True, exist_ok=True)
    for f in (ROOT / "flexbench" / "metrics").glob("*.py"):
        shutil.copy(f, here / "metrics" / f.name)
    bench["configs"] = [c for c in bench["configs"] if c["name"] in SMALL]
    bench["workloads"] = [w for w in bench["workloads"]
                          if w["config"] in SMALL]
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["model"].update(SMALL[c["name"]])
        cfg["engine"] = dict(ENGINE)
        c["file"] = f"flexbench/configs/{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        real = json.loads((ROOT / "flexbench" / "workloads" /
                           f"{w['name']}.json").read_text())
        t = dict(TRAFFIC[real["loop"]], **LENGTHS,
                 check=dict(CHECK, gap_limit=GAP_LIMIT.get(w["name"])),
                 base_seed=real["base_seed"])
        (here / "workloads" / f"{w['name']}.json").write_text(json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@contextlib.contextmanager
def few_threads(n: int = 2):
    """Two torch threads while a tiny run or reference works: six test
    workers of eight threads each would otherwise crowd the CPU."""
    import torch
    was = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(was)


def run_module():
    """flexbench/run.py as a module (it is a script, not a package member)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "flexbench_run_script", ROOT / "flexbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(root: Path, cell: str, *, seed: int = 2 ** 31 + 7,
        seconds: float = 2.0, trace: bool = False) -> dict:
    """One run of a tiny cell on the CPU, as ``run.py`` makes it past its
    look for a card."""
    import os
    import time

    from flexbench.lib import spec
    mod = run_module()
    saved = dict(os.environ)
    try:
        mod.environment(trace)
        c = spec.load_cell(cell, root, root / "flexbench")
        with few_threads():
            return mod.run_cell(c, seed, seconds, trace, "cpu",
                                time.monotonic(), here=root / "flexbench")
    finally:
        os.environ.clear()
        os.environ.update(saved)

"""No process the benchmark starts loads JAX, flax, the JAX package
``repro``, anything under ``benchmarks/`` or ``chip_smoke.py``; the check
compares whole top-level names (``repro_torch`` begins with ``repro`` and
is the port)."""
import os
import subprocess
import sys

import flexbench_tiny as tiny


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    mod = tiny.run_module()
    fake = {"repro_torch": 1, "repro_torch.serving": 1, "jaxtyping": 1,
            "reprox": 1, "flaxen": 1}
    monkeypatch.setattr(sys, "modules", fake)
    assert mod.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", dict(fake, **{"repro.core": 1,
                                                      "jax.numpy": 1}))
    assert mod.forbidden_modules() == ["jax", "repro"]


CHILD = r"""
import sys, tempfile, json
from pathlib import Path
sys.path.insert(0, {tests!r})
import flexbench_tiny as tiny
root = tiny.make(Path(tempfile.mkdtemp()))
for cell in ("mixtral-8x7b-l8.chat", "nemotron-4-340b-l4.docs"):
    tiny.run(root, cell, seconds=1.0, trace=cell.endswith("docs"))
mod = tiny.run_module()
control = tiny.ROOT / "flexbench" / "control.py"
sweep = tiny.ROOT / "flexbench" / "sweep.py"
import importlib.util
for p in (control, sweep):
    s = importlib.util.spec_from_file_location(p.stem + "_script", p)
    s.loader.exec_module(importlib.util.module_from_spec(s))
files = [str(getattr(m, "__file__", "") or "") for m in list(sys.modules.values())]
bad = [f for f in files if f.startswith(str(tiny.ROOT / "benchmarks"))
       or f.endswith("chip_smoke.py")]
print(json.dumps(mod.forbidden_modules() + bad))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", CHILD.format(tests=str(tiny.ROOT / "flexbench"
                                                      / "tests"))],
        capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"

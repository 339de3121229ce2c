"""What the harness finds by name: ``BENCHMARK.json`` at the checkout's
root, each configuration's file (``configs/<config>.json``), each cell's
traffic file (``workloads/<cell>.json``) and each per-layer metric's
reader (``metrics/<metric>.py``).  Adding a configuration, a cell or a
metric is adding its file and its entry in ``BENCHMARK.json``: nothing
here lists them."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parents[1]        # flexbench/


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict            # the configuration file
    traffic: Dict           # the cell's traffic file
    chips: int
    end_to_end: List[Dict]  # the metrics this cell reports, untraced
    per_layer: List[Dict]   # the metrics this cell reports, traced

    @property
    def engine(self) -> Dict:
        """The engine's settings: the configuration's, overridden by the
        traffic file's."""
        return {**self.config.get("engine", {}),
                **self.traffic.get("engine", {})}


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files read
    from ``here`` (the benchmark's folder)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads((here / "workloads" / f"{name}.json").read_text())
    return Cell(name=name, config=config, traffic=traffic,
                chips=int(w["chips"]),
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])


def reader(metric: str, here: Path = HERE) -> Callable:
    """The ``read(view)`` function of ``metrics/<metric>.py``."""
    path = here / "metrics" / f"{metric}.py"
    mod_name = "flexbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(name: str):
    """The plain reference module ``reference/<name>.py``."""
    return importlib.import_module(f"flexbench.reference.{name}")


def read_metrics(cell: Cell, view, here: Path = HERE) -> Dict[str, Dict]:
    """Each per-layer metric's reading; a reader that finds nothing to
    read returns None, and its metric is left out."""
    out = {}
    for m in cell.per_layer:
        value: Optional[float] = reader(m["name"], here)(view)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out

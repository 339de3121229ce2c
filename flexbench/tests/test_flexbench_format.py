"""BENCHMARK.json and the files it names: names, units and keys within
the limits of the benchmark's format, every metric's layer and arrow
consistent, every file the harness finds by name present."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
DEPTH = {"num_layers"}
METRIC_KEYS = {"end_to_end": {"name", "unit", "better", "bound", "source"},
               "per_layer": {"name", "unit", "better", "source", "layer",
                             "moves"}}


def metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert all(one_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names), names


def test_units_better_sources():
    for m in metrics():
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metric_keys(kind):
    for m in BENCH[kind]:
        assert set(m) - {"workloads"} == METRIC_KEYS[kind], m


def test_every_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m
        assert one_line(m["layer"])
        for w in BENCH["workloads"]:
            if reports(m, w["name"]):
                assert reports(e2e[m["moves"]], w["name"]), (m, w)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in BENCH["end_to_end"]
               if reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reports(m, w["name"]) for m in BENCH["per_layer"])


def test_cells_configs_and_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "flexbench" / "workloads" /
                f"{w['name']}.json").is_file()
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and one_line(c["source"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        # no width is ever cut
        assert not any(k.endswith(("_dim", "_rank", "_size")) or k in
                       ("d_model", "d_ff", "num_heads", "num_kv_heads")
                       for k in c["reduced"])
        for k in c["reduced"]:
            assert cfg["model"][k] != cfg["published"][k]
        # a key in `reduced` is a cut of depth, or a departure the program
        # forces, named with its reason in the file: nothing else
        forced = cfg.get("forced_by_program", {})
        assert set(forced) <= set(c["reduced"])
        assert all(k in DEPTH or k in forced for k in c["reduced"]), c
        assert (ROOT / "flexbench" / "reference" /
                f"{cfg['reference']}.py").is_file()
    for m in BENCH["per_layer"]:
        assert (ROOT / "flexbench" / "metrics" / f"{m['name']}.py").is_file()


def test_command_names_no_file_outside_paths():
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
            assert (ROOT / word).is_file()

"""The control: the reference in fp8 put in the program's place reads as
not correct at the tiny cells' limits, while the program, on the same
prompts, reads as correct."""
import importlib.util

import pytest

import flexbench_tiny as tiny

CELLS = ("mixtral-8x7b-l8.chat", "nemotron-4-340b-l4.docs")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_holds(root, cell):
    from flexbench.lib import serve, spec
    from repro_torch.models import build_model
    s = importlib.util.spec_from_file_location(
        "flexbench_control_script", tiny.ROOT / "flexbench" / "control.py")
    ctl = importlib.util.module_from_spec(s)
    s.loader.exec_module(ctl)
    c = spec.load_cell(cell, root, root / "flexbench")
    lim = c.traffic["check"]
    model = build_model(serve.model_config(c.config["model"]))
    ref = spec.reference(c.config["reference"])
    with tiny.few_threads():
        r = ctl.one_seed(c, model, ref, 2 ** 31 + 3, 2.0, "cpu")
    assert r["gap_mean"] <= lim["gap_mean_limit"] < r["control_gap_mean"]
    if lim.get("gap_limit") is not None:
        assert r["gap"] <= lim["gap_limit"] < r["control_gap"]

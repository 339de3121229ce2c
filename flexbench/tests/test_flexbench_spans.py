"""The per-layer readers of the program's spans (``metrics/`` of
``decode_issue_ms``, ``decode_issue_idle_ms``, ``decode_handoff_ms``,
``slot_wait_ms``, ``prefill_engine_ms``, ``decode_logits_share``): in a
tiny traced run of each cell on the CPU each returns a finite number, or
None where it reads the card (the device trace's kernels, the steps'
stream times), and none raises; against a program without spans each
returns None."""
import math

import pytest

import flexbench_tiny as tiny

CELLS = ("mixtral-8x7b-l8.chat", "nemotron-4-340b-l4.docs")
HOST = ("decode_issue_ms", "decode_handoff_ms", "slot_wait_ms",
        "prefill_engine_ms")
CARD = ("decode_issue_idle_ms", "decode_logits_share")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("checkout"))


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_spans(root, cell):
    res = tiny.run(root, cell, trace=True)
    assert res["correct"], res["compared"]
    got = res["metrics"]
    for name in HOST:
        assert math.isfinite(got[name]["value"]) and got[name]["value"] >= 0
    assert not set(CARD) & set(got)
    # the host's issue of a decode step lies inside the step's op
    assert got["decode_issue_ms"]["value"] <= got["decode_step_ms"]["value"]


@pytest.mark.parametrize("metric", HOST + CARD)
def test_a_program_without_spans_gives_none(metric, monkeypatch):
    from flexbench.lib import spec, trace
    from flexbench.lib.trace import Kernel
    from repro_torch.core import profiler
    monkeypatch.delattr(profiler, "ACTIVE")
    ops = [{"name": f"{k}:launch", "ts": 1e6, "dur": 5e3,
            "args": {"op_id": i, "req_id": 1, "tokens": 1}}
           for i, k in enumerate(("prefill", "decode"))]
    view = trace.View(model={}, engine={"max_num_seqs": 4, "max_len": 48},
                      window=(0.0, 10.0), ops=ops, steps=[],
                      span=(0, 10 ** 9), kernels=[Kernel("k", 10, 20)])
    assert spec.reader(metric)(view) is None

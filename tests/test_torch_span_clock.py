"""The program's spans and the device trace share one clock, on an NVIDIA
card; a timed step times its spans on its stream.

200 spans (``repro_torch.core.spans``), each around one launch of a spin
kernel of at least 20 µs and a synchronise, recorded on a Timeline while
``torch.profiler`` traces CUDA activity alone, as the benchmark's traced
run does (``flexbench/lib/trace.py::DeviceTrace``).  Once each span is
mapped onto the device trace's clock (``Timeline.to_profiler_ns``), its
kernel must lie inside it.  The test prints the median and the largest
lead from a span's start to its kernel's start.  Beside it, timed model
steps: each span's stream time from its CUDA events.

It skips without a card and imports no JAX; from the repository root:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -s \\
        tests/test_torch_span_clock.py
"""
import statistics

import pytest
import torch

N_SPANS = 200
SPIN_CYCLES = 200_000           # ~100 µs at the H100's boost clock


@pytest.mark.cuda
def test_every_kernel_lies_inside_its_span_on_the_device_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the device trace's clock)")
    from flexbench.lib.trace import DeviceTrace
    from repro_torch.core import profiler, spans

    was = profiler.ACTIVE
    tl = profiler.Timeline()
    try:
        torch.cuda._sleep(SPIN_CYCLES)          # load the kernel
        torch.cuda.synchronize()
        dev = DeviceTrace()
        dev.prime()
        dev.start()
        for i in range(N_SPANS):
            sp = spans.Span(tl, "clock.probe", {"i": i})
            torch.cuda._sleep(SPIN_CYCLES)
            torch.cuda.synchronize()
            sp.close()
        dev.stop()
        dev.collect()
        events = [e for e in tl.events() if e["name"] == "clock.probe"]
    finally:
        profiler.ACTIVE = was
    kernels = [k for k in dev.kernels if "spin" in k.name]
    assert len(events) == N_SPANS
    assert len(kernels) == N_SPANS, sorted({k.name for k in dev.kernels})
    leads, tails = [], []
    for ev, k in zip(sorted(events, key=lambda e: e["ts"]), kernels):
        a = tl.to_profiler_ns(ev["ts"] * 1e3)
        b = tl.to_profiler_ns((ev["ts"] + ev["dur"]) * 1e3)
        assert k.end - k.start >= 20_000
        leads.append(k.start - a)
        tails.append(b - k.end)
    print(f"\nspan start to kernel start, ns: median "
          f"{statistics.median(leads):.0f}, largest {max(leads):.0f}, "
          f"smallest {min(leads):.0f}; kernel end to span end: median "
          f"{statistics.median(tails):.0f}, smallest {min(tails):.0f}")
    assert min(leads) > 0 and min(tails) > 0


@pytest.mark.cuda
def test_timed_step_times_its_spans_on_the_stream(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA events)")
    from types import SimpleNamespace

    from repro_torch.core import profiler, spans

    def step_fn():
        for name in ("attention", "moe", "logits"):
            sp = spans.model_span(name)
            torch.cuda._sleep(SPIN_CYCLES)
            sp.close()

    monkeypatch.setattr(spans, "TIMED_EVERY", 1)    # every step timed
    was = profiler.ACTIVE
    tl = profiler.Timeline()
    try:
        for i in range(3):
            step = spans.Step(tl, "decode", step_fn, True, rows=1)
            step()
            torch.cuda.synchronize()
            step.complete(tl, SimpleNamespace(op_id=i))
        events = [e for e in tl.events() if e.get("cat") == "span"]
    finally:
        profiler.ACTIVE = was
    assert len(events) == 12                    # the issue and three inside
    for i in range(3):
        mine = {e["name"]: e["args"]["stream_ms"] for e in events
                if e["args"]["op_id"] == i}
        inner = [mine[n] for n in ("attention", "moe", "logits")]
        assert min(inner) > 0.02                # a spin of ~100 µs
        assert mine["step.issue"] >= sum(inner)

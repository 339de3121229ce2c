"""Model step: the model FLOPs of the window's prefill ops (each from the
prompt length of the step the benchmark recorded inside that op) over the
sum of their execution times at the bf16 peak, %."""
from flexbench.lib import arith


def read(view):
    ops = view.ops_of("prefill")
    steps = [s for s in view.steps if s.kind == "prefill"]
    m = arith.ModelArith(view.model)
    flops = secs = 0.0
    i = 0
    for o in sorted(ops, key=lambda o: o["ts"]):
        t0, t1 = o["ts"] / 1e6, (o["ts"] + o["dur"]) / 1e6
        while i < len(steps) and steps[i].t < t0:
            i += 1
        if i < len(steps) and steps[i].t <= t1:
            flops += m.prefill_flops(steps[i].prompt)
            secs += o["dur"] / 1e6
    if secs <= 0:
        return None
    return 100.0 * flops / (secs * arith.PEAK_BF16_FLOPS)

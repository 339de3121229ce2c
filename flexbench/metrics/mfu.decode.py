"""Model step: the model FLOPs of the window's decode ops (the rows that
hold a request, each at its context length from the benchmark's record of
the step) over the sum of their execution times at the bf16 peak, %."""
from flexbench.lib import arith


def read(view):
    ops = view.ops_of("decode")
    steps = [s for s in view.steps if s.kind == "decode"]
    m = arith.ModelArith(view.model)
    flops = secs = 0.0
    i = 0
    for o in sorted(ops, key=lambda o: o["ts"]):
        t0, t1 = o["ts"] / 1e6, (o["ts"] + o["dur"]) / 1e6
        while i < len(steps) and steps[i].t < t0:
            i += 1
        if i < len(steps) and steps[i].t <= t1:
            flops += m.decode_flops(steps[i].active)
            secs += o["dur"] / 1e6
    if secs <= 0:
        return None
    return 100.0 * flops / (secs * arith.PEAK_BF16_FLOPS)

"""Engine (``serving/engine.py``): the decode completion handler on the
host (``engine.decode_done``: the tokens' readback, each slot's
bookkeeping, admission, slot inserts, the next step's inputs and launch),
mean over the window's decode ops, ms."""
from flexbench.lib import spans


def read(view):
    ops = spans.op_ids(view, "decode")
    m = spans.mean([s["dur"] for s in spans.named("engine.decode_done")
                    if s["args"].get("op_id") in ops])
    return None if m is None else m / 1e3

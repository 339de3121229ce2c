"""Model step (``models/*``): the host's time issuing a decode step, from
the step function's entry to its return before the completion wait (the
program's ``step.issue`` span), mean over the window's decode ops, ms."""
from flexbench.lib import spans


def read(view):
    ops = spans.op_ids(view, "decode")
    m = spans.mean([s["dur"] for s in spans.named("step.issue")
                    if s["args"].get("op_id") in ops])
    return None if m is None else m / 1e3

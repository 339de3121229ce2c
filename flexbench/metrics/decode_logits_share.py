"""Model step (``models/*``): the logits' time on the card's stream (the
``logits`` span's CUDA events) over the decode step's (its ``step.issue``
span's), summed over the window's decode ops, %."""
from flexbench.lib import spans


def read(view):
    ops = spans.op_ids(view, "decode")
    t = {"logits": 0.0, "step.issue": 0.0}
    for s in spans.named("logits", "step.issue"):
        a = s["args"]
        if a.get("op_id") in ops and "stream_ms" in a:
            t[s["name"]] += a["stream_ms"]
    if t["step.issue"] <= 0:
        return None
    return 100.0 * t["logits"] / t["step.issue"]

"""Engine (``serving/engine.py``): how long a prefilled request waits for
its decode slot, from its prefill op's completion (the op timeline) to
the start of its ``engine.slot_insert``, mean over the requests whose
prefill is among the window's ops, ms."""
from flexbench.lib import spans


def read(view):
    done = {o["args"]["req_id"]: o["ts"] + o["dur"]
            for o in view.ops_of("prefill") if "req_id" in o["args"]}
    m = spans.mean([s["ts"] - done[s["args"]["req_id"]]
                    for s in spans.named("engine.slot_insert")
                    if s["args"].get("req_id") in done])
    return None if m is None else m / 1e3

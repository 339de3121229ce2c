"""Engine (``serving/engine.py``): a request's host time in the engine
around its prefill, ``engine.submit`` (admission, the prompt sent to the
card, its one-sequence cache made, the op enqueued) plus
``engine.prefill_done`` (the first token read back, bookkeeping, the slot
insert or decode queue), mean over the requests whose prefill is among
the window's ops, ms."""
from flexbench.lib import spans


def read(view):
    reqs = {o["args"].get("req_id") for o in view.ops_of("prefill")}
    sub = {s["args"].get("req_id"): s["dur"]
           for s in spans.named("engine.submit")}
    done = {s["args"].get("req_id"): s["dur"]
            for s in spans.named("engine.prefill_done")}
    m = spans.mean([sub[r] + done[r] for r in reqs
                    if r in sub and r in done])
    return None if m is None else m / 1e3

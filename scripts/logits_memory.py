#!/usr/bin/env python3
"""The fp32 logits' memory on the card under disagg, whole head against
chunks.

    python3 scripts/logits_memory.py [--runs N] [--budgets GIB ...]

``Model._logits`` computes fp32 products and sums, as the JAX twin's
``preferred_element_type=float32`` does, by widening the head to fp32.
Widened whole, nemotron-4-340b's untied 256000 x 18432 head is an 18.9 GB
copy a call, and disagg runs prefill and decode on two daemon threads on
one card, so two calls may hold two copies at once beside the 46.5 GB of
its 4-layer cut.  For each way of widening the head, the whole head (the
port's ``_logits`` before it chunked the head) and ``Model._logits``'s
chunks along the vocab at each budget (``LOGITS_CHUNK_BYTES``, in GiB;
by default only the module's own), this prints the peak memory above
the parameters of two concurrent calls at batch 4 and what they raised,
and the time of one call (CUDA events around 5 calls), then serves
``chip_smoke.py``'s engine traffic (8 requests, 32 new tokens each, 960
slots) in disagg N times, printing every failed request's exception.  The chunked logits are also held
against the whole-head ones.  Needs an NVIDIA card with 80 GB; random
weights from seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import os
import sys
import threading
import traceback

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def whole_head_logits(model, params, x):
    """The head widened to fp32 whole, in one product."""
    from repro_torch.models import model as M
    head = (params["embed"].t() if model.cfg.tie_embeddings
            else params["head"])
    logits = torch.einsum("...d,dv->...v", x.float(), head.float())
    return M._softcap(logits, model.cfg.final_logit_softcap)


def concurrent_peak(fn, model, params, x):
    """Peak bytes above the parameters of two concurrent ``fn`` calls on
    two threads, and the names of what they raised."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    raised = []

    def call():
        try:
            with torch.inference_mode():
                fn(model, params, x)
        except RuntimeError as e:              # OutOfMemoryError among them
            raised.append(type(e).__name__)

    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base, raised


def call_ms(fn, model, params, x, iters: int = 5) -> float:
    """Mean time of one ``fn`` call, from CUDA events around ``iters``."""
    with torch.inference_mode():
        fn(model, params, x)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(model, params, x)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--budgets", type=float, nargs="*", default=None,
                    help="chunk budgets in GiB (default: the module's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("logits_memory: needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    from repro_torch.serving.request import Request

    print(torch.cuda.get_device_name(0), flush=True)
    failed_locked = E.RealEngine._fail_locked

    def report_failure(self, req):
        # called inside the engine's except block: print what it caught
        print(f"  request {req.req_id} failed: "
              f"{traceback.format_exc().strip().splitlines()[-1]}",
              flush=True)
        return failed_locked(self, req)

    E.RealEngine._fail_locked = report_failure
    cfg = dataclasses.replace(get_config("nemotron-4-340b"), num_layers=4)
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in rng.integers(128, 1025, 8)]
    x = torch.randn(4, cfg.d_model, device="cuda").bfloat16()
    chunked, budget = M.Model._logits, M.LOGITS_CHUNK_BYTES
    budgets = ([int(b * (1 << 30)) for b in args.budgets]
               if args.budgets else [budget])
    with torch.inference_mode():
        diff = float((chunked(model, params, x)
                      - whole_head_logits(model, params, x)).abs().max())
    print(f"chunked logits vs the whole head's: max abs diff {diff!r}")
    ways = [("whole head", whole_head_logits, budget)] + [
        (f"chunks of {b / (1 << 30):g} GiB", chunked, b) for b in budgets]
    for name, fn, b in ways:
        M.LOGITS_CHUNK_BYTES = b
        gc.collect()
        torch.cuda.empty_cache()
        peak, raised = concurrent_peak(fn, model, params, x)
        print(f"{name}: two concurrent _logits calls: peak {peak} bytes "
              f"above the parameters, raised {raised}; one call "
              f"{call_ms(fn, model, params, x)!r} ms", flush=True)
        M.Model._logits = fn
        for run in range(args.runs):
            reqs = [Request(prompt_len=len(p), max_new_tokens=32,
                            prompt_tokens=p, arrival_time=0.0)
                    for p in prompts]
            eng = E.RealEngine(model, params, mode="disagg",
                               max_num_seqs=4, max_len=960, device="cuda")
            try:
                res = eng.run(reqs, timeout=600)
            finally:
                eng.shutdown()
            print(f"{name}: disagg run {run}: completed={res['completed']} "
                  f"failed={res['failed']}", flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    M.Model._logits, M.LOGITS_CHUNK_BYTES = chunked, budget
    return 0


if __name__ == "__main__":
    sys.exit(main())

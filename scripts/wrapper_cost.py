#!/usr/bin/env python3
"""Host cost and device time of the kernels' wrappers, and the prefill and
decode times they feed, for the port in one checkout.

    python3 scripts/wrapper_cost.py [--root DIR] [--iters N] [--repeats R]

Builds the kernels of ``DIR/src/repro_torch`` (default: this checkout) and
calls its ``flash_attention_cuda``, ``paged_attention_cuda`` and
``ssd_scan_cuda`` at ``chip_smoke.py``'s main shapes (flash q/k/v
[1, 891, 16, 128] bf16 causal; paged q [4, 16, 128] over the
[4, 960, 16, 128] bf16 slot cache; SSD x [1, 891, 48, 64] bf16, B/C
[1, 891, 1, 128], with initial state, chunk 256) with that script's
timers, R times each:

- ``ms``: CUDA events around N back-to-back calls, the pace a caller sees
  (set by the host where a call's host-side work outlasts its kernel);
- ``device_ms``: the same calls queued behind a spin kernel, the card
  alone;
- ``host_us``: the host's time to issue one call.

Then the host clock of one olmo-1b decode step at the engine's shape (4
sequences over the 960-slot cache, full width, random weights from seed
0), R runs of 8 steps, each to a synchronize, as ``chip_smoke.py`` takes
it; and mamba2-780m's prefill of the 891-token prompt at full width, R
runs on the host clock and one traced with torch.profiler (device busy
time, launches, and the device time of the SSD scan's kernels), as
``chip_smoke.py::profile_prefill`` takes it.  Run it on two checkouts on
one card to compare them.  Needs an NVIDIA card; prints one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402  (its timers, traffic and inputs)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wrapper_cost: needs an NVIDIA card", file=sys.stderr)
        return 1
    src = os.path.join(os.path.abspath(args.root), "src")
    sys.path.insert(0, src)
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models import build_model
    from repro_torch.models.layers import page_size
    assert FA.__file__.startswith(src), FA.__file__
    build.build()
    build.load()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    prompts, max_len = CS.engine_traffic(0, get_config("olmo-1b").vocab_size)
    lens = [len(p) for p in prompts]
    S = max(lens)
    q, k, v = (torch.randn(1, S, 16, 128, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    ps = page_size(max_len)
    main_lens = [min(n + CS.MAX_NEW // 2, max_len)
                 for n in lens[:CS.MAX_NUM_SEQS]]
    pargs = CS.paged_inputs(CS.MAX_NUM_SEQS, 16, 16, 128, ps, max_len // ps,
                            torch.bfloat16, gen, identity=True,
                            lengths=main_lens)
    sargs, sst = CS.ssd_inputs(1, S, 48, 64, 1, 128, torch.bfloat16, gen,
                               init=True)
    calls = {
        "flash_attention": lambda: FA.flash_attention_cuda(
            q, k, v, scale=128 ** -0.5),
        "paged_attention": lambda: PA.paged_attention_cuda(
            *pargs, scale=128 ** -0.5),
        "ssd_scan": lambda: SSD.ssd_scan_cuda(*sargs, chunk=256,
                                              initial_state=sst),
    }
    result = {"root": os.path.abspath(args.root), "card": CS.card_line()}
    for name, fn in calls.items():
        r = result[name] = dict(ms=[], device_ms=[], host_us=[])
        for _ in range(args.repeats):
            r["ms"].append(CS.time_ms(fn, args.iters))
            device_ms, host_us = CS.time_held(fn, args.iters)
            r["device_ms"].append(device_ms)
            r["host_us"].append(host_us)

    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    params = model.init(0, device="cuda")
    cache = model.init_cache(CS.MAX_NUM_SEQS, max_len, device="cuda")
    toks = torch.zeros(CS.MAX_NUM_SEQS, dtype=torch.long, device="cuda")
    step_lens = torch.tensor(lens[:CS.MAX_NUM_SEQS], dtype=torch.int32,
                             device="cuda")

    def steps(n=8):
        t0 = time.perf_counter()
        for _ in range(n):
            model.decode(params, toks, cache, step_lens)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    steps()                                         # warm up
    result["decode_step_host_ms"] = [steps() for _ in range(args.repeats)]
    del params, cache
    torch.cuda.empty_cache()

    cfg = get_config("mamba2-780m")
    params = build_model(cfg).init(0, device="cuda")
    with contextlib.redirect_stdout(sys.stderr):     # its report, to stderr
        pre = CS.profile_prefill(cfg, params, S, 0, runs=args.repeats)
    ssd = {}                                         # device ms by kernel
    for k, ms in pre["by_kernel"].items():
        if "ssd" in k:
            name = re.search(r"ssd_\w+", k).group(0)
            ssd[name] = ssd.get(name, 0.0) + ms
    result["mamba2_prefill"] = dict(
        host_ms=pre["host_ms"], busy_ms=pre["busy_ms"],
        launches=pre["launches"], ssd_kernels_ms=sum(ssd.values()),
        ssd_by_kernel=ssd)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

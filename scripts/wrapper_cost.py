#!/usr/bin/env python3
"""Host cost and device time of the attention kernels' wrappers, for the
port in one checkout.

    python3 scripts/wrapper_cost.py [--root DIR] [--iters N] [--repeats R]

Builds the kernels of ``DIR/src/repro_torch`` (default: this checkout) and
calls its ``flash_attention_cuda`` and ``paged_attention_cuda`` at
``chip_smoke.py``'s main shapes (flash q/k/v [1, 891, 16, 128] bf16
causal; paged q [4, 16, 128] over the [4, 960, 16, 128] bf16 slot cache)
with that script's timers, R times each:

- ``ms``: CUDA events around N back-to-back calls, the pace a caller sees
  (set by the host where a call's host-side work outlasts its kernel);
- ``device_ms``: the same calls queued behind a spin kernel, the card
  alone;
- ``host_us``: the host's time to issue one call.

Then the host clock of one olmo-1b decode step at the engine's shape (4
sequences over the 960-slot cache, full width, random weights from seed
0), R runs of 8 steps, each to a synchronize, as ``chip_smoke.py`` takes
it.  Run it on two checkouts on one card to compare their wrappers.  Needs an
NVIDIA card; prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
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
    calls = {
        "flash_attention": lambda: FA.flash_attention_cuda(
            q, k, v, scale=128 ** -0.5),
        "paged_attention": lambda: PA.paged_attention_cuda(
            *pargs, scale=128 ** -0.5),
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
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

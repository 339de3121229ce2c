#!/usr/bin/env python3
"""What taking the stacked parameters apart costs a training step:
``torch.unbind`` once a pass against indexing each layer.

    python3 scripts/train_select_cost.py [--steps N] [--rounds R]

``models/transformer.py`` keeps each parameter of a layer stack as one
tensor with a leading repeats axis.  ``stack_forward`` takes it apart
with one ``torch.unbind`` a tensor a pass (``_unbind``); its backward
stacks the layers' gradients into one tensor.  Indexing each layer
(``v[r]``, what ``_layer`` does for the caches) has a backward that
allocates a zero tensor of the whole stack for every layer and adds it
into the gradient.  This runs olmo-1b at full width (batch 4 x 2048
tokens, the launcher's train step, remat as the config sets it) both
ways, in turns (unbind, index, index, unbind, ...) on one card, and
prints each way's host clock a step (median of ``--steps``, after one
warm-up step), the device's busy time of one step (torch.profiler),
its kernel launches, and the peak memory.  The two ways' gradients are
held against each other first (they must be equal).  Needs an NVIDIA
card; random weights from seed 0.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

B, S = 4, 2048


def indexed(tree, R):
    """Each layer of a stacked tree by indexing: ``_layer`` for every r."""
    from repro_torch.models import transformer as T
    return [T._layer(tree, r) for r in range(R)]


def run_way(way, step, params, opt, batch, steps: int):
    """(host ms of each step, busy ms of a traced step, launches, peak
    bytes) of ``steps`` steps (after one warm-up) the given way."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    T._unbind = way
    step(params, opt, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host = []
    for _ in range(steps):
        t0 = time.monotonic()
        _, _, m = step(params, opt, batch)
        float(m["loss"])
        host.append(1e3 * (time.monotonic() - t0))
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, m = step(params, opt, batch)
        float(m["loss"])
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    return host, busy, sum(e.count for e in kernels), peak


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch import tree as TR
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_batch,
                                      make_train_step)
    from repro_torch.training.train_step import loss_and_grads
    torch.backends.cuda.matmul.allow_tf32 = False
    name = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    print(name)
    cfg = get_config("olmo-1b")
    model = build_model(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-4, warmup_steps=3,
                                       total_steps=40))
    params, opt = init_train_state(model, tcfg, 0, device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in make_batch(cfg, B, S, step=0).items()}
    ways = {"unbind": T._unbind, "index": indexed}

    grads = {}
    for label, way in ways.items():
        T._unbind = way
        grads[label] = loss_and_grads(model, params, batch)[2]
    same = all(torch.equal(a, b) for a, b in
               zip(TR.leaves(grads["unbind"]), TR.leaves(grads["index"])))
    print(f"gradients equal both ways: {same}")
    del grads
    torch.cuda.empty_cache()

    step = make_train_step(model, tcfg)
    order = [w for r in range(args.rounds)
             for w in (("unbind", "index") if r % 2 == 0
                       else ("index", "unbind"))]
    results = {label: [] for label in ways}
    for label in order:
        host, busy, launches, peak = run_way(ways[label], step, params, opt,
                                             batch, args.steps)
        results[label].append((host, busy, launches, peak))
        print(f"{label}: host ms a step {[round(h, 2) for h in host]} "
              f"(median {float(np.median(host))!r}); busy {busy!r} ms; "
              f"{launches} launches; peak {peak} bytes")
    T._unbind = ways["unbind"]
    for label, runs in results.items():
        host = [h for r in runs for h in r[0]]
        print(f"summary {label}: median host {float(np.median(host))!r} ms "
              f"over {len(host)} steps; busy "
              f"{[round(r[1], 3) for r in runs]} ms; peak "
              f"{max(r[3] for r in runs)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end training driver: a ~100M-parameter dense LM for a few
hundred steps with checkpoint/restart (kill it mid-run and rerun: it
resumes) — the port's copy of ``examples/train_100m.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_100m --device cpu \\
        --steps 20 --batch 2 --seq 64

Runs on the card by default.
"""
import argparse
import dataclasses
import time

import torch


def main():
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.device import require_device
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_batch,
                                      make_train_step)

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_100m")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = require_device(args.device)

    # ~100M-param config in the olmo family
    cfg = dataclasses.replace(
        get_config("olmo-1b"), name="olmo-100m", num_layers=14, d_model=640,
        num_heads=10, num_kv_heads=10, head_dim=64, d_ff=2560,
        vocab_size=16_384, remat=False)
    print(f"model: {cfg.param_count() / 1e6:.0f}M params")

    model = build_model(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(
        lr=6e-4, warmup_steps=30, total_steps=args.steps))
    params, opt = init_train_state(model, tcfg, 0, device=dev)
    step_fn = make_train_step(model, tcfg)

    ckpt = Checkpointer(args.ckpt_dir, keep=2)
    start = ckpt.latest_step() or 0
    if start:
        state = ckpt.restore(start, {"params": params, "opt": opt})
        params, opt = state["params"], state["opt"]
        print(f"resumed from step {start}")

    t0 = time.time()
    for i in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 make_batch(cfg, args.batch, args.seq, step=i).items()}
        params, opt, m = step_fn(params, opt, batch)
        if i % 10 == 0 or i == args.steps - 1:
            dt = time.time() - t0
            print(f"step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"({(i - start + 1) / max(dt, 1e-9):.2f} steps/s)")
        if (i + 1) % 50 == 0:
            ckpt.save(i + 1, {"params": params, "opt": opt}, blocking=False)
    ckpt.save(args.steps, {"params": params, "opt": opt}, blocking=True)
    print("done; checkpoints:", ckpt.all_steps())


if __name__ == "__main__":
    main()

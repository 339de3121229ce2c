"""Training launcher: the twin of ``repro/launch/train.py``.

    python -m repro_torch.launch.train --arch olmo-1b --steps 100 \\
        --batch 4 --seq 2048

Trains the model at its full published width on one CUDA card by default;
``--device cpu --reduced`` trains the smoke-test width on the CPU:

    python -m repro_torch.launch.train --arch olmo-1b --reduced \\
        --device cpu --steps 20

Checkpoint/restart (auto-resume from the latest committed step of
``--ckpt-dir``), async checkpointing, loss logging, optional int8 gradient
compression, as the JAX launcher.  Every family the JAX launcher trains
trains here: the dense and attention-variant decoders, Mamba-2, the MoE
decoders and jamba's hybrid (capacity routing through the sorted expert
dispatch), and the encoder-decoder on fp32 frames:

    python -m repro_torch.launch.train --arch mixtral-8x7b --reduced \
        --device cpu --steps 2

As the JAX launcher's code does, it trains on one device, so a model must
fit one card; ``chip_smoke.py`` trains mixtral-8x7b cut to 2 of its 32
layers.  The port's distributed layer stands beside it:
``distributed.sharding`` lays a model's annotated parameters
(``Model.init_annotated``) out over a ``DeviceMesh`` (``launch/mesh.py``),
``make_train_step(..., group=)`` averages the ranks' gradients before the
int8 fake-quant, as the JAX twin's sharded step does, and
``distributed.fault_tolerance.run_with_restarts`` drives a train step
through failures.
"""
from __future__ import annotations

import argparse
import os
import time


def run_training(arch: str, *, reduced: bool = True, steps: int = 50,
                 batch: int = 8, seq: int = 128, lr: float = 3e-4,
                 ckpt_dir: str = "", save_every: int = 25,
                 grad_compression: str = "none", log_every: int = 10,
                 seed: int = 0, resume: bool = True, verbose: bool = True,
                 device="cuda"):
    """Returns (params, opt_state, losses): the losses of the steps this
    call ran (from the resumed step on)."""
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.device import require_device
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_batch,
                                      make_train_step)

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    dev = require_device(device)
    model = build_model(cfg)
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                        total_steps=steps),
        grad_compression=grad_compression)
    params, opt_state = init_train_state(model, tcfg, seed, device=dev)
    step_fn = make_train_step(model, tcfg)

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    start = 0
    if ckpt and resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        state = ckpt.restore(start, {"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        if verbose:
            print(f"resumed from step {start}")

    losses = []
    t0 = time.time()
    for i in range(start, steps):
        np_batch = make_batch(cfg, batch, seq, step=i, seed=seed)
        tbatch = {k: torch.from_numpy(v).to(dev) for k, v in np_batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, tbatch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {float(metrics['lr']):.2e}")
        if ckpt and ((i + 1) % save_every == 0 or i == steps - 1):
            ckpt.save(i + 1, {"params": params, "opt": opt_state},
                      blocking=False)
    if ckpt:
        ckpt.wait()
    dt = time.time() - t0
    if verbose:
        print(f"{steps - start} steps in {dt:.1f}s "
              f"({(steps - start) / max(dt, 1e-9):.2f} steps/s)")
    return params, opt_state, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    # full width fills a good part of the card: expandable segments let
    # the allocator reuse freed blocks for tensors of other sizes (set
    # before the first CUDA allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    run_training(args.arch, reduced=args.reduced, steps=args.steps,
                 batch=args.batch, seq=args.seq, lr=args.lr,
                 ckpt_dir=args.ckpt_dir, save_every=args.save_every,
                 grad_compression=args.grad_compression, device=args.device)


if __name__ == "__main__":
    main()

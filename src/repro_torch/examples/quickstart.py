"""Quickstart: build an architecture, train it briefly, tour the session
API, then serve requests through FlexNPU's dynamic PD co-location — the
port's copy of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--arch olmo-1b] [--device cpu]

On the card (the default) the model runs at its full published width,
every attention layer's backward runs the flash attention backward
kernel, which takes every head dim the forward does (gemma2-2b's 256
and nemotron-4-340b's 192 too), and every Mamba-2 layer's the SSD-scan
backward kernel (mamba2-780m); ``--device cpu`` runs the smoke-test
width.  It trains
first and serves the same parameters after: serving runs under inference
mode, whose tensors autograd cannot use.  Every arch is offered, as in
the JAX quickstart; the engine serves token prompts, so the
encoder-decoder and the VLM stop after training.
"""
import argparse

import numpy as np
import torch


def main():
    from repro_torch.configs import get_config, list_archs
    from repro_torch.core import Phase, connect
    from repro_torch.device import require_device
    from repro_torch.models import build_model
    from repro_torch.serving.engine import RealEngine
    from repro_torch.serving.request import Request
    from repro_torch.training import (AdamWConfig, TrainConfig,
                                      init_train_state, make_batch,
                                      make_train_step)

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b",
                    choices=list_archs())
    ap.add_argument("--train-steps", type=int, default=10)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    dev = require_device(args.device)
    cfg = get_config(args.arch)
    if dev.type == "cpu":
        cfg = cfg.reduced()
    print(f"== {args.arch} ({cfg.param_count() / 1e6:.1f}M params, "
          f"family={cfg.family.value}, on {dev}) ==")
    model = build_model(cfg)

    # --- 1. a few training steps
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                       total_steps=args.train_steps))
    params, opt = init_train_state(model, tcfg, 0, device=dev)
    step = make_train_step(model, tcfg)
    for i in range(args.train_steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in make_batch(cfg, 8, 64, step=i).items()}
        params, opt, m = step(params, opt, batch)
        if i % 2 == 0:
            print(f"  train step {i}: loss={float(m['loss']):.3f}")

    # --- 2. the virtual-device session API in five lines
    with connect(mode="flex", devices=1) as sess:
        stream = sess.create_stream(phase=Phase.OTHER)
        buf = sess.malloc(1 << 16, tag="demo")
        sess.memcpy(buf, np.arange(64, dtype=np.float32), vstream=stream)
        ev = sess.create_event()
        sess.record_event(ev, stream)          # happens-before edge source
        sess.wait_event(ev, stream).result()
        back = sess.memcpy(None, buf, vstream=stream).result()
        sess.synchronize(stream)
        sess.destroy_event(ev)
        sess.destroy_stream(stream)
        sess.free(buf)
        print(f"  session round-trip through a device buffer: "
              f"sum={float(back.sum()):.0f} (expect 2016), "
              f"leak-free={sess.stats()[0]['buffers'] == 0}")

    if cfg.is_encdec or cfg.frontend_stub:
        print("  (serving demo uses token-input archs; done)")
        return

    # --- 3. serve through FlexNPU dynamic PD co-location
    rng = np.random.default_rng(0)
    reqs = [Request(prompt_len=12, max_new_tokens=8,
                    prompt_tokens=rng.integers(0, cfg.vocab_size, 12).tolist(),
                    arrival_time=i * 0.02)
            for i in range(args.requests)]
    eng = RealEngine(model, params, mode="dynamic_pd", max_num_seqs=2,
                     max_len=64, device=dev)
    try:
        res = eng.run(reqs, timeout=300)
    finally:
        eng.shutdown()
    print(f"  served {res['completed']} requests: "
          f"{res['output_tokens_per_s']:.1f} tok/s, "
          f"TTFT p50 {res['ttft_p50_s'] * 1e3:.0f}ms, "
          f"TPOT {res['tpot_mean_s'] * 1e3:.1f}ms")
    print("  sample output:", reqs[0].output_tokens)


if __name__ == "__main__":
    main()

"""Serving launcher — both execution paths:

  * real:  RealEngine under any FlexNPU mode and policy:
           python -m repro_torch.launch.serve --arch olmo-1b \\
               --mode dynamic_pd --requests 16 --rate 4
  * sim:   384-card cluster simulation with the paper's deployments:
           python -m repro_torch.launch.serve --sim --arch mixtral-8x7b \\
               --deployment dynamic --workload 1k1k

The real path runs the model at its full published width on one CUDA
card by default; ``--device cpu --reduced`` runs the smoke-test width on
the CPU.
``--layers N`` cuts the stack to its first N layers at full width, and
``--experts N`` an MoE model to its first N experts: a model too large
for one card (mixtral-8x7b, nemotron-4-340b, jamba-1.5-large) is served as
such a cut, every matrix at its published shape:

    python -m repro_torch.launch.serve --arch jamba-1.5-large-398b \\
        --layers 8 --experts 8 --mode dynamic_pd

An encoder-decoder (seamless-m4t-medium) is refused: the engine feeds
token prompts, and its prefill needs frame embeddings.

The sim path does no device work: it models a cluster of H100 instances
through ``serving/costmodel.py`` (the card's peaks and its fitted
derates) and needs no card.

Both paths go through the session API (``repro_torch.core.connect``): the
real engine opens a one-device session; the cluster simulator opens one
session with a device per serving instance.  ``--show-session`` prints the
session's per-device handle/memory accounting after the run.
"""
from __future__ import annotations

import argparse
import os


def run_real(arch: str, mode: str, n_requests: int, rate: float,
             prompt_len: int = 16, max_new: int = 16,
             max_num_seqs: int = 4, seed: int = 0, verbose: bool = True,
             show_session: bool = False, policy: str = "",
             device="cuda", reduced: bool = False, layers: int = 0,
             experts: int = 0):
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import RealEngine
    from repro_torch.serving.request import Request

    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if experts:
        if cfg.moe is None or not cfg.moe.top_k <= experts <= \
                cfg.moe.num_experts:
            raise ValueError(f"--experts {experts}: {cfg.name} routes "
                             f"top-k over its experts ({cfg.moe})")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=experts))
    model = build_model(cfg)
    params = model.init(seed, device=device)
    rng = np.random.default_rng(seed)
    reqs = [Request(prompt_len=prompt_len, max_new_tokens=max_new,
                    prompt_tokens=rng.integers(
                        0, cfg.vocab_size, prompt_len).tolist(),
                    arrival_time=i / rate)
            for i in range(n_requests)]
    eng = RealEngine(model, params, mode=mode, max_num_seqs=max_num_seqs,
                     max_len=prompt_len + max_new + 8,
                     policy=policy or None, device=device)
    try:
        res = eng.run(reqs, timeout=600)
        if show_session and verbose:
            print(f"  session[{eng.session.mode}] "
                  f"devices={eng.session.device_count()} "
                  f"stats={eng.session.stats()}")
    finally:
        eng.shutdown()
    if verbose:
        for k, v in res.items():
            print(f"  {k}: {v:.4f}" if isinstance(v, float) else f"  {k}: {v}")
    return res


def run_sim(arch: str, deployment: str, workload: str, verbose: bool = True,
            show_session: bool = False, link_bw: float = 0.0,
            cluster_policy: str = "", dispatch_policy: str = "",
            drive: str = "stepped"):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving import (Cluster, SimConfig, deployment_6p2d,
                                     deployment_dynamic,
                                     deployment_role_switch)
    from repro_torch.serving.simulator import DeploymentSpec
    from repro_torch.traffic import (bursty_phase_shift, deepseek_1k1k,
                                     deepseek_1k4k)

    cfg = get_config(arch)
    deploy = {
        "6p2d": deployment_6p2d(),
        "dynamic": deployment_dynamic(),
        "role_switch": deployment_role_switch(),
        "static_colocate": DeploymentSpec(mode="static_colocate",
                                          colocated_instances=3,
                                          colocated_chips=128),
    }[deployment]
    # control-plane overrides: any registry name is sweepable from the CLI
    if cluster_policy or dispatch_policy:
        deploy = dataclasses.replace(
            deploy, cluster_policy=cluster_policy or deploy.cluster_policy,
            dispatch_policy=dispatch_policy or deploy.dispatch_policy)
    wl = {"1k1k": deepseek_1k1k, "1k4k": deepseek_1k4k,
          "bursty": bursty_phase_shift}[workload]()
    sim_cfg = SimConfig(transfer_bw=link_bw * 1e9) if link_bw else None
    cluster = Cluster(cfg, deploy, sim_cfg=sim_cfg, drive=drive)
    res = cluster.run(wl, until=7200)
    if show_session and verbose:
        print(f"  session[sim] devices={cluster.session.device_count()}")
        for dev, st in cluster.session.stats().items():
            print(f"    {cluster.instances[dev].name}: {st}")
    if verbose:
        for k, v in res.items():
            print(f"  {k}: {v:.4f}" if isinstance(v, float) else f"  {k}: {v}")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--sim", action="store_true")
    ap.add_argument("--mode", default="dynamic_pd",
                    choices=["passthrough", "static_colocate", "dynamic_pd",
                             "disagg"])
    ap.add_argument("--deployment", default="dynamic",
                    choices=["6p2d", "dynamic", "role_switch",
                             "static_colocate"])
    ap.add_argument("--workload", default="1k1k",
                    choices=["1k1k", "1k4k", "bursty"])
    ap.add_argument("--policy", default="",
                    help="real path: dispatch-policy registry name "
                         "(repro_torch.sched) overriding the mode default")
    ap.add_argument("--cluster-policy", default="",
                    help="sim: cluster-policy registry name "
                         "(least_loaded, role_switch, ...)")
    ap.add_argument("--dispatch-policy", default="",
                    help="sim: per-instance dispatch-policy registry name")
    ap.add_argument("--drive", default="stepped",
                    choices=["stepped", "threaded"],
                    help="sim: discrete-event or real-thread drive")
    ap.add_argument("--link-bw", type=float, default=0.0,
                    help="sim: KV-transfer link bandwidth in GB/s "
                         "(0 = default 50)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--show-session", action="store_true",
                    help="print per-device session handle/memory stats")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's smoke-test width (for the CPU)")
    ap.add_argument("--layers", type=int, default=0,
                    help="serve only the first N layers (a depth cut)")
    ap.add_argument("--experts", type=int, default=0,
                    help="an MoE model's first N experts (a cut)")
    args = ap.parse_args()
    if args.sim:
        run_sim(args.arch, args.deployment, args.workload,
                show_session=args.show_session, link_bw=args.link_bw,
                cluster_policy=args.cluster_policy,
                dispatch_policy=args.dispatch_policy, drive=args.drive)
        return
    # a cut that fills most of the card draws each stacked tensor in fp32
    # before it casts: expandable segments let the allocator reuse those
    # temporaries' memory (set before the first CUDA allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    run_real(args.arch, args.mode, args.requests, args.rate,
             show_session=args.show_session, policy=args.policy,
             device=args.device, reduced=args.reduced, layers=args.layers,
             experts=args.experts)


if __name__ == "__main__":
    main()

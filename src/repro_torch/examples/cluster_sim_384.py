"""Paper-scale experiment (Table 3): 384-chip cluster, static 6P2D PD
disaggregation vs FlexNPU dynamic PD co-location, 1K-1K and 1K-4K workloads
— with a mid-run instance failure to exercise the fault-tolerance path.

The KV transport layer is configurable: ``--topology shared_spine
--spine-bw 2e9`` routes disaggregation transfers over a shared spine
(path-aware contention) and ``--kv-chunk-tokens 512`` streams each
request's KV as layer-wise chunks instead of one blob.  Control-plane v3
policies are swept by registry name (``--cluster-policy role_switch``).

Traffic (v5): ``--traffic tiered_burst`` swaps the fixed 1K-1K/1K-4K pair
for any ``repro_torch.traffic`` registry workload (multi-tenant SLO tiers, MMPP
bursts, closed-loop pools) and prints the per-tier SLO attainment
breakdown; pair with ``--admission-policy slo_aware`` for tiered
admission.

    PYTHONPATH=src python -m repro_torch.examples.cluster_sim_384 \\
        [--arch grok-1-314b]
        [--topology flat|shared_spine] [--kv-chunk-tokens N]
        [--cluster-policy NAME] [--dispatch-policy NAME]
        [--traffic NAME] [--admission-policy NAME]
"""
import argparse
import copy
import dataclasses

from repro_torch.configs import get_config
from repro_torch.serving import (Cluster, SimConfig, deployment_6p2d,
                           deployment_dynamic, make_workload)
from repro_torch.transport import make_topology


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--requests", type=int, default=600)
    ap.add_argument("--fail-instance", action="store_true")
    # KV transport knobs (repro_torch.transport)
    ap.add_argument("--topology", default="flat",
                    choices=["flat", "shared_spine"],
                    help="interconnect topology for disagg KV transfers")
    ap.add_argument("--spine-bw", type=float, default=4e9,
                    help="shared-spine bandwidth, bytes/s")
    ap.add_argument("--kv-chunk-tokens", type=int, default=0,
                    help="layer-wise KV streaming granularity "
                         "(0 = one blob per request)")
    # control-plane v3 policy flags (repro_torch.sched registry names)
    ap.add_argument("--cluster-policy", default="",
                    help="cluster policy (least_loaded, role_switch)")
    ap.add_argument("--dispatch-policy", default="",
                    help="per-daemon dispatch policy (fifo, static_slice, "
                         "dynamic_pd)")
    # traffic-engine v5 flags (repro_torch.traffic registry names)
    ap.add_argument("--traffic", default="",
                    help="replace the fixed 1K-1K/1K-4K pair with a "
                         "repro_torch.traffic workload (see list below); "
                         "closed-loop entries self-throttle under load")
    ap.add_argument("--admission-policy", default="",
                    help="admission policy (ungated, gated, slo_aware)")
    # prefix-cache tier v6 flags (repro_torch.cache registry names)
    ap.add_argument("--prefix-cache", default="",
                    help="per-instance prefix cache (none, lru, lfu, ttl);"
                         " pair with --cluster-policy prefix_affinity and"
                         " --traffic multi_turn to see reuse")
    args = ap.parse_args()
    cfg = get_config(args.arch)

    topology = (make_topology("shared_spine", spine_bw=args.spine_bw)
                if args.topology == "shared_spine" else None)
    sim_cfg = SimConfig(topology=topology,
                        kv_chunk_tokens=args.kv_chunk_tokens,
                        prefix_cache=args.prefix_cache or "none")

    if args.traffic:
        workloads = [(args.traffic, None, None)]
    else:
        workloads = [("1K-1K", 1024, 1024), ("1K-4K", 1024, 4096)]
    for wl_name, i, o in workloads:
        if args.traffic:
            from repro_torch.traffic import make_traffic, traffic_is_closed_loop
            closed = traffic_is_closed_loop(args.traffic)
            wl = make_traffic(args.traffic)
        else:
            closed = False
            n = args.requests if o == 1024 else args.requests // 3
            wl = make_workload(n, i, o, rate=1e5, seed=3)
        results = {}
        for name, deploy in (("static 6P2D", deployment_6p2d()),
                             ("FlexNPU dynamic 3x128", deployment_dynamic())):
            deploy = dataclasses.replace(
                deploy, cluster_policy=args.cluster_policy,
                dispatch_policy=args.dispatch_policy,
                admission_policy=args.admission_policy)
            cluster = Cluster(cfg, deploy, sim_cfg=sim_cfg)
            if args.fail_instance:
                victim = cluster.instances[0].name
                cluster.loop.at(1.0, lambda c=cluster, v=victim:
                                c.fail_instance(v))
            if closed:
                res = cluster.run(traffic=copy.deepcopy(wl), until=72000)
            else:
                res = cluster.run(copy.deepcopy(wl), until=72000)
            cluster.check_kv_conservation()
            results[name] = res
            extra = f" retries={res.get('retries', 0)}" if args.fail_instance \
                else ""
            if res.get("transfers"):
                extra += (f" transfers={res['transfers']}"
                          f" stall_s={res.get('decode_stall_s', 0):.1f}")
            if res.get("shed_requests"):
                extra += f" shed={res['shed_requests']}"
            if res.get("prefix_cache"):
                pc = res["prefix_cache"]
                extra += (f" hit_rate={pc['hit_rate']:.3f}"
                          f" fetches={pc['remote_fetches']}")
            print(f"[{wl_name}] {name:24s} rps={res['requests_per_s']:8.2f} "
                  f"tok/s={res['output_tokens_per_s']:10.0f}{extra}")
            for tier, t in sorted(res.get("tenants", {}).items()):
                print(f"[{wl_name}]   {tier:12s} "
                      f"slo_attainment={t['slo_attainment']:.3f} "
                      f"ttft_p99={t['ttft_p99_s']:.3f}s "
                      f"tpot_p99={t['tpot_p99_s']:.3f}s "
                      f"rejected={t['rejected']}")
        gain = (results["FlexNPU dynamic 3x128"]["requests_per_s"]
                / results["static 6P2D"]["requests_per_s"] - 1)
        if args.traffic:
            print(f"[{wl_name}] dynamic vs disagg: {gain:+.2%}\n")
        else:
            paper = "+26.33%" if wl_name == "1K-1K" else "+5.15%"
            print(f"[{wl_name}] dynamic vs disagg: {gain:+.2%} "
                  f"(paper: {paper})\n")
        per_link = results["static 6P2D"].get("per_link", {})
        spine = {k: v for k, v in per_link.items() if k.startswith("spine:")}
        if spine:
            print(f"[{wl_name}] disagg spine contention: "
                  + ", ".join(f"{k} queue_delay={v['queue_delay_s']:.2f}s"
                              for k, v in spine.items()) + "\n")


if __name__ == "__main__":
    main()

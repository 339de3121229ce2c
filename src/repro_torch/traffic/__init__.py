"""repro_torch.traffic: the production traffic engine (v5).

Everything the evaluation stack is driven by lives here: composable
arrival processes and length samplers, Zipf prompt-class mixes, tenant
tiers with SLO targets, closed-loop client pools, and the
``make_traffic`` registry that makes every workload sweepable by name
(the same pattern as ``make_policy`` / ``make_topology``).
"""
from repro_torch.serving.request import SLO
from repro_torch.traffic.arrivals import (ARRIVALS, list_arrivals, make_arrivals,
                                    register_arrival)
from repro_torch.traffic.closed_loop import ClosedLoopPool
from repro_torch.traffic.lengths import (LENGTHS, list_lengths, make_lengths,
                                   register_lengths)
from repro_torch.traffic.registry import (list_traffic, make_traffic,
                                    register_traffic,
                                    traffic_is_closed_loop)
from repro_torch.traffic.spec import (DEFAULT_CLASSES, PromptClass, TrafficSpec,
                                zipf_probs)
from repro_torch.traffic.tenants import TenantClass, default_tiers
from repro_torch.traffic.workloads import (bursty_phase_shift, closed_loop,
                                     deepseek_1k1k, deepseek_1k4k,
                                     make_workload, multi_turn, qwen_grid,
                                     tiered, tiered_burst)

__all__ = [
    "SLO", "ARRIVALS", "LENGTHS", "DEFAULT_CLASSES",
    "make_arrivals", "list_arrivals", "register_arrival",
    "make_lengths", "list_lengths", "register_lengths",
    "make_traffic", "list_traffic", "register_traffic",
    "traffic_is_closed_loop",
    "PromptClass", "TrafficSpec", "zipf_probs",
    "TenantClass", "default_tiers", "ClosedLoopPool",
    "make_workload", "bursty_phase_shift", "deepseek_1k1k",
    "deepseek_1k4k", "multi_turn", "qwen_grid", "tiered", "tiered_burst",
    "closed_loop",
]

from repro_torch.serving.costmodel import CostModel, InstanceSpec
from repro_torch.serving.kvcache import OutOfPages, PagedAllocator, PagedKVStore
from repro_torch.serving.request import (SLO, Request, RequestState, summarize)
from repro_torch.serving.simulator import (Cluster, DeploymentSpec, EventLoop,
                                     SimConfig, SimInstance,
                                     deployment_6p2d, deployment_dynamic,
                                     deployment_role_switch)
# Workload generators live in repro_torch.traffic (the serving.workload shim
# was removed after its one-release deprecation window, v6); these
# package-level re-exports remain part of the public surface.
# flexlint: ignore[layering] -- compat re-export kept for the public API
from repro_torch.traffic.workloads import (bursty_phase_shift, deepseek_1k1k,
                                     deepseek_1k4k, make_workload, qwen_grid)

# The link/transport classes (LinkModel, LinkTransfer, LinkDriver,
# ThreadedLinkTimer) live in repro_torch.transport; their one-release re-exports
# from this package were removed — import from repro_torch.transport[.drivers].

__all__ = [
    "SLO", "CostModel", "InstanceSpec", "OutOfPages",
    "PagedAllocator", "PagedKVStore", "Request", "RequestState", "summarize",
    "Cluster", "DeploymentSpec", "EventLoop", "SimConfig",
    "SimInstance", "deployment_6p2d", "deployment_dynamic",
    "deployment_role_switch", "bursty_phase_shift", "deepseek_1k1k",
    "deepseek_1k4k", "make_workload", "qwen_grid",
]

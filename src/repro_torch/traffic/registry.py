"""Traffic registry: construct any workload by name.

Mirrors ``repro_torch.sched.make_policy`` / ``repro_torch.transport.make_topology`` /
``repro_torch.cache.make_cache`` — all four ride the shared
:mod:`repro_torch.registry` helper since v6::

    from repro_torch.traffic import make_traffic

    make_traffic("deepseek_1k1k", n=200)          # List[Request]
    make_traffic("multi_turn", conversations=8)    # shared-prefix chat
    make_traffic("closed_loop", users=32)          # ClosedLoopPool

Open-loop entries return a ``List[Request]``; ``closed_loop`` returns a
:class:`~repro_torch.traffic.closed_loop.ClosedLoopPool` — both feed straight
into ``Cluster.run`` (requests positionally, pools via ``traffic=``).
Unknown names raise the unified
:class:`~repro_torch.registry.UnknownNameError` (a ``ValueError``; also a
``KeyError`` through the migration window) listing what IS registered;
unknown knobs raise ``TypeError`` naming the accepted set.
"""
from __future__ import annotations

from typing import Callable, List

from repro_torch.registry import Registry
from repro_torch.traffic import workloads as _w

_REG = Registry("traffic")


def register_traffic(name: str, factory: Callable, knobs: tuple = (),
                     closed_loop: bool = False) -> None:
    """Register a workload constructor under a sweepable name."""
    _REG.register(name, factory, knobs=knobs, closed_loop=closed_loop)


def list_traffic() -> List[str]:
    return _REG.names()


def traffic_is_closed_loop(name: str) -> bool:
    return bool(_REG.meta(name)["closed_loop"])


def make_traffic(name: str, **knobs):
    """Build the workload registered as ``name`` with the given knobs."""
    return _REG.make(name, **knobs)


register_traffic("open_loop", _w.make_workload,
                 knobs=("n", "input_len", "output_len", "rate", "seed",
                        "length_cv", "arrival", "tenant", "cv", "phases"))
register_traffic("bursty_phase_shift", _w.bursty_phase_shift,
                 knobs=("n_bursts", "burst_gap_s", "n_prefill",
                        "prefill_rate", "prefill_io", "n_decode",
                        "decode_rate", "decode_io", "seed"))
register_traffic("deepseek_1k1k", _w.deepseek_1k1k,
                 knobs=("n", "rate", "seed"))
register_traffic("deepseek_1k4k", _w.deepseek_1k4k,
                 knobs=("n", "rate", "seed"))
register_traffic("qwen_grid", _w.qwen_grid)
register_traffic("multi_turn", _w.multi_turn,
                 knobs=("n", "rate", "seed", "conversations",
                        "system_tokens", "turn_tokens", "output_tokens",
                        "zipf_alpha", "arrival", "vocab"))
register_traffic("tiered", _w.tiered,
                 knobs=("n", "rate", "seed", "zipf_alpha", "ttft_scale",
                        "tpot_scale", "tiers"))
register_traffic("tiered_burst", _w.tiered_burst,
                 knobs=("n", "rate", "burst_mult", "base_s", "burst_s",
                        "seed", "zipf_alpha", "ttft_scale", "tpot_scale",
                        "tiers"))
register_traffic("closed_loop", _w.closed_loop,
                 knobs=("users", "think_time_s", "requests_per_user",
                        "seed", "zipf_alpha", "ttft_scale", "tpot_scale",
                        "tiered_tenants", "spec"),
                 closed_loop=True)

"""Tenant tiers (the traffic subsystem, v5).

A :class:`TenantClass` names a tier, its share of the request mix, and its
:class:`~repro_torch.serving.request.SLO` targets.  The default three-tier split
mirrors production serving fleets:

  * ``interactive`` — chat in the hot path: tight TTFT/TPOT, highest
    priority, largest fair-share weight.
  * ``standard``    — API traffic: looser targets, middle priority.
  * ``batch``       — offline eval / summarization: latency-tolerant,
    lowest priority — the tier SLO-aware admission sheds first under
    overload.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.serving.request import SLO


@dataclasses.dataclass(frozen=True)
class TenantClass:
    """One tenant tier: ``share`` is its fraction of the generated mix
    (normalized across the spec's tiers), ``slo`` its latency targets plus
    admission priority / fair-share weight."""
    name: str
    share: float = 1.0
    slo: SLO = SLO()


def default_tiers(ttft_scale: float = 1.0,
                  tpot_scale: float = 1.0) -> Tuple[TenantClass, ...]:
    """The canonical interactive/standard/batch split.  The scales let
    benchmarks tighten or loosen every target together (e.g. to match a
    cost model's absolute latency range) without re-deriving the tiering."""
    return (
        TenantClass("interactive", share=0.25,
                    slo=SLO(ttft_s=1.0 * ttft_scale, tpot_s=0.2 * tpot_scale,
                            priority=2, weight=4.0)),
        TenantClass("standard", share=0.45,
                    slo=SLO(ttft_s=4.0 * ttft_scale, tpot_s=0.5 * tpot_scale,
                            priority=1, weight=2.0)),
        TenantClass("batch", share=0.30,
                    slo=SLO(ttft_s=30.0 * ttft_scale, tpot_s=2.0 * tpot_scale,
                            priority=0, weight=1.0)),
    )

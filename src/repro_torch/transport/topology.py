"""Cluster interconnect topologies: (src, dst) -> multi-hop link paths.

The v2 link layer keyed contention by **destination ingress only** — every
transfer into instance D occupied one link ``("ingress", "D")`` and nothing
else, so two transfers from different sources into different destinations
never contended even when the fabric between them was shared.  Real NPU
pods route cross-instance traffic over shared spine links (cf. the
inter-core-connected-NPU topology studies in PAPERS.md), where path-level
contention dominates at scale.

A :class:`Topology` resolves a (src, dst) instance pair to a **path**: an
ordered tuple of link *segments*, each a ``(kind, name)`` tuple —

    source egress  ->  shared spine  ->  destination ingress

A transfer occupies every segment on its path simultaneously (it is one
flow, not a store-and-forward hop sequence); the path-aware
:class:`~repro_torch.transport.links.LinkModel` rates it at the minimum
per-segment processor share.  Segment bandwidths are per-kind with
per-segment overrides, so heterogeneous fabrics (fat ingress, thin spine)
are one dict away.

``Topology.flat(bw)`` reproduces the v2 behavior exactly: the path is the
single destination-ingress segment.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Hashable, Optional, Tuple

DEFAULT_LINK_BW = 50e9      # one ICI-class inter-device link, bytes/s

Segment = Tuple[str, object]
Path = Tuple[Segment, ...]


@dataclasses.dataclass
class Topology:
    """Resolves instance pairs to link-segment paths with per-kind BWs.

    ``None`` bandwidth for a kind removes that segment class from paths
    entirely (``flat`` keeps only the ingress).  ``n_spines`` stripes
    flows over parallel spine planes by a stable (src, dst) hash, so the
    same pair always rides the same plane (ECMP-style, deterministic
    across runs — ``hash()`` is salted, ``crc32`` is not)."""

    name: str = "shared_spine"
    ingress_bw: float = DEFAULT_LINK_BW
    egress_bw: Optional[float] = DEFAULT_LINK_BW
    spine_bw: Optional[float] = DEFAULT_LINK_BW
    n_spines: int = 1
    bw_overrides: Dict[Hashable, float] = dataclasses.field(
        default_factory=dict)
    failed_spines: set = dataclasses.field(default_factory=set)

    # ------------------------------------------------------------ routing
    def fail_spine(self, index: int) -> None:
        """Take one spine plane out of routing: NEW paths stripe over the
        survivors (in-flight transfers are the cluster's problem — see
        ``Cluster.fail_spine``).  With every plane failed, routing keeps
        returning the nominal stripe — the path still crosses a severed
        segment, which the cluster detects and fails transfers honestly
        instead of sending KV over dead fabric."""
        self.failed_spines.add(index)

    def spine_index(self, src: str, dst: str) -> int:
        alive = [k for k in range(max(1, self.n_spines))
                 if k not in self.failed_spines]
        if not alive:
            alive = list(range(max(1, self.n_spines)))
        if len(alive) == 1:
            return alive[0]
        return alive[zlib.crc32(f"{src}->{dst}".encode()) % len(alive)]

    def path(self, src: str, dst: str) -> Path:
        """Ordered segments a src->dst transfer occupies simultaneously."""
        segs = []
        if self.egress_bw is not None:
            segs.append(("egress", src))
        if self.spine_bw is not None:
            segs.append(("spine", self.spine_index(src, dst)))
        segs.append(("ingress", dst))
        return tuple(segs)

    def segment_bw(self, seg: Hashable) -> Optional[float]:
        """Bandwidth of one segment (None = unknown to this topology)."""
        if seg in self.bw_overrides:
            return self.bw_overrides[seg]
        if isinstance(seg, tuple) and len(seg) == 2:
            kind = seg[0]
            if kind == "ingress":
                return self.ingress_bw
            if kind == "egress":
                return self.egress_bw
            if kind == "spine":
                return self.spine_bw
        return None

    # ---------------------------------------------------------- factories
    @classmethod
    def flat(cls, bw: float = DEFAULT_LINK_BW) -> "Topology":
        """v2 semantics: contention keyed by destination ingress only."""
        return cls(name="flat", ingress_bw=bw, egress_bw=None, spine_bw=None)

    @classmethod
    def shared_spine(cls, ingress_bw: float = DEFAULT_LINK_BW,
                     egress_bw: float = DEFAULT_LINK_BW,
                     spine_bw: float = DEFAULT_LINK_BW,
                     n_spines: int = 1) -> "Topology":
        """Three-hop fabric: egress -> striped spine plane(s) -> ingress."""
        return cls(name="shared_spine", ingress_bw=ingress_bw,
                   egress_bw=egress_bw, spine_bw=spine_bw,
                   n_spines=max(1, n_spines))


from repro_torch.registry import Registry  # noqa: E402  (registry after classes)

_REG = Registry("topology")
_REG.register("flat", Topology.flat, knobs=("bw",))
_REG.register("shared_spine", Topology.shared_spine,
              knobs=("ingress_bw", "egress_bw", "spine_bw", "n_spines"))


def register_topology(name: str, factory, knobs: tuple = ()) -> None:
    _REG.register(name, factory, knobs=knobs)


def make_topology(name: str, **knobs) -> Topology:
    """Registry-style constructor on the shared :mod:`repro_torch.registry`
    helper (mirrors ``make_policy`` / ``make_traffic`` / ``make_cache``)
    so benchmarks and example CLIs sweep topologies by name.  Unknown
    names raise the unified ``UnknownNameError`` (a ``ValueError``);
    unknown knobs raise ``TypeError`` naming the accepted set."""
    return _REG.make(name, **knobs)


def list_topologies():
    return _REG.names()

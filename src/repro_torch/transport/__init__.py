# KV transport subsystem: everything that MOVES KV between instances.
#
#   Topology   — resolves a (src, dst) instance pair to a multi-hop path of
#                link segments (source egress -> shared spine -> destination
#                ingress); ``make_topology(name, **knobs)`` mirrors the
#                policy registry for CLI sweeps.
#   LinkModel  — path-aware occupancy: a transfer occupies every segment on
#                its path and moves at the min over per-segment processor
#                shares; stats() breaks bytes/queueing/concurrency down per
#                segment.
#   LinkDriver / ThreadedLinkTimer — glue the model onto the stepped
#                discrete-event loop and the threaded copy-engine threads.
#   KVStreamer — splits a request's KV into layer-wise chunks pipelined
#                over memcpy_peer so decode can start after the first chunk
#                lands while the tail streams in.
#
# The serving layer (Cluster, RealEngine, realtime drive) consumes this
# package; ``repro_torch.serving.costmodel`` re-exports LinkModel/LinkTransfer
# for one release (see docs/api.md "KV transport & topology").
from repro_torch.transport.drivers import LinkDriver, ThreadedLinkTimer
from repro_torch.transport.links import LinkModel, LinkTransfer, as_path, seg_key
from repro_torch.transport.streamer import KVStreamer
from repro_torch.transport.topology import (DEFAULT_LINK_BW, Path, Segment,
                                      Topology, list_topologies,
                                      make_topology)

__all__ = [
    "DEFAULT_LINK_BW", "KVStreamer", "LinkDriver", "LinkModel",
    "LinkTransfer", "Path", "Segment", "ThreadedLinkTimer", "Topology",
    "as_path", "list_topologies", "make_topology", "seg_key",
]

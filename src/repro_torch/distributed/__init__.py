"""Sharding rules, the int8-compressed all-reduce and fault tolerance:
the twin of ``repro.distributed`` (the same exports)."""
from repro_torch.distributed.sharding import (AxisRules, Param, axes_tree,
                                              make_rules, make_shardings,
                                              logical_spec, set_active,
                                              shard_act, unbox, prepend_axis)

__all__ = [
    "AxisRules", "Param", "axes_tree", "make_rules", "make_shardings",
    "logical_spec", "set_active", "shard_act", "unbox", "prepend_axis",
]

"""Per-rank roofline accounting of one traced step: the twin of
``repro/launch/hlo_analysis.py``.

The reference parses the post-SPMD HLO text that XLA compiles for one
device, because XLA's own ``cost_analysis()`` counts each ``while`` body
once whatever its trip count.  torch has no HLO, and the port's models
unroll their layers in Python at trace time, so there is no loop to
multiply and nothing to parse.  Instead ``StepCounter`` is a
``TorchDispatchMode`` entered around the step, on a ``DeviceMesh`` whose
parameters and inputs are ``DTensor``s over ``meta`` shards.  A mode sees
each op before DTensor does, with the global shapes; it hands those ops
back (``NotImplemented``) so DTensor runs its sharding propagation and
then issues the **local** op, on the rank's own shards, and any
collective it needs, as functional collectives on those shards.  The mode
counts those.  (DTensor also runs each op once on global-shape
``FakeTensor``s to infer the output's metadata; those ops are skipped.)

It returns the three per-rank numerators ``HloRoofline`` returns:

  * FLOPs: 2 * M * N * K of each local matmul (``mm``, with or without
    ``out_dtype``, ``addmm``, ``bmm``, ``baddbmm``; ``einsum``,
    ``matmul`` and ``linear`` reach these), and the other products
    ``torch.utils.flop_counter`` knows;
  * HBM bytes: operand plus result bytes of every local op that is not a
    view, an upper bound with no fusion, as the reference's; an indexed
    write into a cache (``index_put_``) is charged its update window read
    and written, as the reference charges ``dynamic-update-slice``;
  * collective wire bytes by type, for a group of g ranks: all-gather
    (g - 1) / g of its full result, reduce-scatter (g - 1) / g of its full
    input, all-reduce 2 (g - 1) / g of its size, all-to-all and permute
    1x (the factors of ``hlo_analysis.py``; the reference's code applies
    reduce-scatter's factor to its scattered result, 1/g of the full
    size);

and a count of each local op kind, beside ``dot_count``.  ``loop_count``
is 0: no step here has a loop.  ``peak_live_bytes`` is the largest sum of
bytes held at once by the storages the step created, which the dry-run
reports as its temporary memory.  It is taken from the op stream alone,
as a compiler's buffer assignment takes it: a storage is live from the op
that makes it to the last op that reads or writes it (through any view),
or to the step's end if the step returns it (``keep``).  When Python
lets go of a tensor plays no part, so the figure depends only on the
sequence of local ops, not on the torch version that traced them.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import math
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# functional collectives (the native namespace DTensor issues, the older
# Python one, and DTensor's own all-to-all between two sharded dims) by
# the reference's HLO names
COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}
# writes charged their update window only (read it, write it)
WINDOW_WRITES = {"index_put", "index_put_", "_index_put_impl_"}
# ops that move no bytes of their own
NO_TRAFFIC = {"wait_tensor", "_wrap_tensor_autograd", "detach", "lift_fresh",
              "alias", "empty", "empty_strided", "empty_like"}


@dataclasses.dataclass
class StepRoofline:
    """One rank's numerators for the roofline (the reference's
    ``HloRoofline``, with ``op_counts`` and ``peak_live_bytes``)."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_type: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    dot_count: int = 0
    loop_count: int = 0
    op_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(name: str, args) -> int:
    """The size of the group a functional collective runs over."""
    if name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        return int(args[1] if name == "all_gather_into_tensor" else args[2])
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[-1]).size()


def wire_bytes(kind: str, g: int, full_bytes: float) -> float:
    """Bytes a rank sends for one collective over ``g`` ranks whose full
    (unsharded) tensor is ``full_bytes``."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * frac * full_bytes
    if kind in ("all-gather", "reduce-scatter"):
        return frac * full_bytes
    return float(full_bytes)


class StepCounter(TorchDispatchMode):
    """Counts one rank's local ops while active (see the module docstring);
    ``result()`` gives the ``StepRoofline``."""

    def __init__(self):
        super().__init__()
        self.out = StepRoofline()
        self._ops = collections.Counter()
        self._pos = 0           # the local ops counted so far
        # each storage the step made, by its StorageImpl's address: [the
        # op that made it, the last op that touched it, bytes]; the
        # storages themselves are held (``meta`` shards: no memory), so no
        # address is made twice within a step
        self._ranges: Dict[int, List] = {}
        self._held: List = []
        self.last_op = ""       # the last DTensor op, to name a failure

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            self.last_op = f"{func}" + "".join(
                f" {tuple(t.shape)}{t.placements}"
                for t in _tensors((args, kwargs)) if isinstance(t, DTensor))
            return NotImplemented           # let DTensor issue the local ops
        result = func(*args, **kwargs)
        from torch._subclasses.fake_tensor import FakeTensor
        outs = list(_tensors(result))
        if any(isinstance(t, FakeTensor) for t in outs):
            return result                   # DTensor's global-shape pass
        self._count(func, args, kwargs, result, outs)
        return result

    @contextlib.contextmanager
    def naming_failures(self):
        """Re-raise an error inside the block as a ``RuntimeError`` that
        names the last DTensor op this counter saw (the op DTensor could
        not run, when the error is DTensor's)."""
        try:
            yield
        except Exception as e:
            raise RuntimeError(f"at {self.last_op or 'no DTensor op'}: "
                               f"{type(e).__name__}: {e}") from e

    def _count(self, func, args, kwargs, result, outs):
        ns, _, name = func._schema.name.partition("::")
        self._ops[name] += 1
        ins = list(_tensors((args, kwargs)))
        self._pos += 1
        self._touch(ins)    # an output's own storage is an input's or new
        packet = func._overloadpacket
        if packet in flop_registry:
            self.out.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=result)
            self.out.dot_count += 1
        if ns in COLLECTIVE_NAMESPACES and name in COLLECTIVES:
            kind = COLLECTIVES[name]
            g = _group_size(name, args)
            full = _nbytes(outs[0]) if kind == "all-gather" else _nbytes(
                ins[0])
            wb = wire_bytes(kind, g, full)
            self.out.collective_bytes += wb
            self.out.collective_by_type[kind] = \
                self.out.collective_by_type.get(kind, 0.0) + wb
        if not func.is_view and not any(r.alias_info
                                        for r in func._schema.returns):
            for t in outs:                  # new storages, not in-place
                self._make(t)
        if func.is_view or name in NO_TRAFFIC:
            return
        if name in WINDOW_WRITES:
            self.out.hbm_bytes += 2.0 * _nbytes(ins[-1])
        else:
            self.out.hbm_bytes += float(sum(map(_nbytes, ins))
                                        + sum(map(_nbytes, outs)))

    def _touch(self, tensors):
        """Extend the life of each step-made storage among ``tensors`` to
        the current op."""
        for t in tensors:
            rec = self._ranges.get(t.untyped_storage()._cdata)
            if rec is not None:
                rec[1] = self._pos

    def _make(self, t: torch.Tensor):
        """Open a live range for ``t``'s new storage at the current op."""
        storage = t.untyped_storage()
        n = storage.nbytes()
        if n and storage._cdata not in self._ranges:
            self._ranges[storage._cdata] = [self._pos, self._pos, n]
            self._held.append(storage)

    def keep(self, tree):
        """Hold every step-made storage in ``tree`` (the step's outputs;
        a ``DTensor``'s local shard) live to the step's end."""
        from torch.distributed.tensor import DTensor
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            rec = self._ranges.get(t.untyped_storage()._cdata)
            if rec is not None:
                rec[1] = math.inf

    def _peak(self) -> int:
        """The largest sum of bytes of the live ranges over op positions
        (a range covers its first and its last op)."""
        events = collections.Counter()
        for first, last, n in self._ranges.values():
            events[first] += n
            if last != math.inf:
                events[last + 1] -= n
        live = peak = 0
        for pos in sorted(events):
            live += events[pos]
            peak = max(peak, live)
        return peak

    def result(self) -> StepRoofline:
        self.out.op_counts = dict(sorted(self._ops.items()))
        self.out.peak_live_bytes = self._peak()
        return self.out

"""Logical-axis sharding: parameter annotation + rules -> placements.

The twin of ``repro/distributed/sharding.py``.  Models annotate every
parameter with *logical* axis names (``"embed"``, ``"heads"``, ``"mlp"``,
``"vocab"``, ``"expert"``, ...).  ``AxisRules`` maps logical names to mesh
axes with **divisibility-aware fallback**: each logical axis carries an
ordered candidate list of mesh-axis tuples and the first candidate that (a)
evenly divides the dimension and (b) does not reuse a mesh axis already
consumed by an earlier dimension of the same tensor wins.  This lets one
rule set serve all ten assigned architectures (e.g. shard attention over
``heads`` when ``H % tp == 0``, else fall back to ``head_dim``).

Two built-in layouts:
  * ``train``  — FSDP x TP: d_model-like dims sharded over the (pod,) data
    axes, heads/mlp/vocab over ``model``; batch over (pod, data).
  * ``serve``  — TP-first: weights sharded over ``model``; the FSDP dimension
    is only engaged when the per-device weight bytes would exceed the HBM
    budget (large archs), because FSDP re-gathers per decoded token.

A spec is a plain tuple, one entry per leading tensor dim (trailing
``None``s trimmed, as JAX trims a ``PartitionSpec``): ``None``, a mesh-axis
name, or a tuple of names.  ``placements`` maps it onto a
``torch.distributed.device_mesh.DeviceMesh``: each mesh dim gets
``Shard(d)`` for the tensor dim ``d`` that names it, else ``Replicate()``.
A tuple entry shards one tensor dim over several mesh dims, major first,
as JAX's ``NamedSharding`` does.  ``torch.distributed.tensor`` is imported
only where a placement or a ``DTensor`` is made: the models import this
module, and the spec rules need no process group.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

from repro_torch import tree as TR
from repro_torch.configs.base import MeshConfig, ModelConfig

Spec = Tuple[Any, ...]   # per dim: None, a mesh-axis name, or a tuple of them

# --------------------------------------------------------------------------
# Annotated parameters
# --------------------------------------------------------------------------


class Param:
    """A parameter value boxed with logical axis names (one per dim)."""

    __slots__ = ("value", "axes")

    def __init__(self, value, axes: Tuple[Optional[str], ...]):
        self.value = value
        self.axes = tuple(axes)

    def __repr__(self):
        shape = getattr(self.value, "shape", None)
        return f"Param(shape={shape}, axes={self.axes})"


def is_param(x) -> bool:
    return isinstance(x, Param)


def boxed(value, axes: Tuple[Optional[str], ...], box: bool):
    """``Param(value, axes)`` when ``box``, else ``value``: the models'
    initializers return either tree from one body."""
    return Param(value, axes) if box else value


def unbox(tree):
    """Strip Param boxes -> raw value tree."""
    return TR.map_tree(lambda p: p.value if is_param(p) else p, tree)


def axes_tree(tree):
    """Extract the logical-axes tree (same structure as ``unbox(tree)``)."""
    return TR.map_tree(lambda p: p.axes if is_param(p) else None, tree)


def prepend_axis(name: Optional[str], tree):
    """After stacking block params, prepend the stacking axis name."""
    return TR.map_tree(
        lambda p: Param(p.value, (name,) + p.axes) if is_param(p) else p,
        tree)


# --------------------------------------------------------------------------
# Rules
# --------------------------------------------------------------------------

Candidates = Tuple[Tuple[str, ...], ...]   # ordered mesh-axis-tuple candidates


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis -> ordered candidates of mesh-axis tuples."""
    rules: Dict[str, Candidates]
    mesh_axis_sizes: Dict[str, int]
    # behavioural flags read by model code via active_flag(), e.g.
    # "single_q_block": sequence-parallel attention computes all q positions
    # in one (seq-sharded) block instead of scanning q blocks.
    flags: Tuple[str, ...] = ()

    def spec_for(self, axes: Sequence[Optional[str]],
                 shape: Sequence[int]) -> Spec:
        """Greedy left-to-right assignment with divisibility + reuse checks."""
        if len(axes) != len(shape):
            raise ValueError(f"axes {tuple(axes)} for shape {tuple(shape)}")
        used: set = set()
        out = []
        for name, dim in zip(axes, shape):
            assignment: Optional[Tuple[str, ...]] = None
            for cand in self.rules.get(name or "", ((),)):
                if not cand:
                    assignment = None
                    break
                if any(a in used for a in cand):
                    continue
                size = math.prod(self.mesh_axis_sizes[a] for a in cand)
                if dim % size == 0:
                    assignment = cand
                    break
            if assignment:
                used.update(assignment)
                out.append(assignment if len(assignment) > 1 else assignment[0])
            else:
                out.append(None)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)


def _fsdp_axes(mesh: MeshConfig) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axes else ("data",)


def make_rules(cfg: ModelConfig, mesh: MeshConfig, mode: str = "train",
               *, hbm_budget_bytes: float = 10e9,
               overrides: Optional[Dict[str, Candidates]] = None,
               flags: Tuple[str, ...] = ()) -> AxisRules:
    """Build the layout rules for (arch, mesh, mode).

    mode: "train" (FSDP x TP) or "serve" (TP-first; FSDP only if weights
    would not fit per-device otherwise).
    """
    fsdp = _fsdp_axes(mesh)
    sizes = dict(zip(mesh.axes, mesh.shape))
    tp = ("model",)

    # Does a TP-only layout fit?  bf16 weights / model-axis size.
    bytes_per_param = 2 if "16" in cfg.param_dtype else 4
    tp_only_bytes = cfg.param_count() * bytes_per_param / sizes.get("model", 1)
    serve_needs_fsdp = tp_only_bytes > hbm_budget_bytes

    if mode == "train" or (mode == "serve" and serve_needs_fsdp):
        embed_cands: Candidates = (fsdp, ())
    else:
        embed_cands = ((),)

    rules: Dict[str, Candidates] = {
        # weight dims
        "embed": embed_cands,
        "mlp": (tp, ()),
        "heads": (tp, ()),
        "kv_heads": (tp, ()),
        "head_dim": (tp, ()),         # fallback when heads don't divide
        "vocab": (tp, ()),
        "expert": (tp, ()),           # falls back to mlp->model when E % tp != 0
        "ssm_inner": (tp, ()),
        "ssm_heads": (tp, ()),
        "state": ((),),
        "conv": ((),),
        "layers": ((),),
        # activation dims
        "batch": (fsdp, ()),
        "seq": ((),),
        "act_seq": ((),),             # override -> ("model",): Megatron-SP
        "act_embed": ((),),           # activations keep d_model replicated (TP)
        "act_vocab": (tp, ()),        # logits sharded over model
        "act_heads": (tp, ()),
        # never shard the head_dim of *activations*: contracting a sharded
        # head_dim inside attention puts a reduction in every (q, kv)
        # block wherever kv_heads don't divide tp.  Weight head_dim
        # sharding stays allowed (gathered once per layer).
        "act_head_dim": ((),),
        # KV-cache dims
        "cache_batch": (fsdp, ()),
        # flash-decoding layout: when kv_heads don't divide tp, shard the
        # cache by SEQUENCE over model (partial-softmax reductions of
        # [B,H,D] stats) instead of head_dim (which re-gathers the cache
        # each step).
        "cache_seq": ((),),
        "cache_kv_heads": (tp, ()),
        "cache_head_dim": ((),),
    }
    if mode == "serve":
        # shard the KV cache by sequence position: over `data` for batch=1
        # long-context, over `model` when batch already owns `data`
        # (flash-decoding: per-shard partial attention + tiny stat reductions).
        rules["cache_seq"] = (("data",), ("model",), ())
        rules["seq"] = ((),)
    if overrides:
        rules.update(overrides)
    return AxisRules(rules=rules, mesh_axis_sizes=sizes, flags=tuple(flags))


# --------------------------------------------------------------------------
# Specs onto DeviceMesh placements
# --------------------------------------------------------------------------


def placements(mesh, spec: Spec, ndim: int) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``
    with ``mesh_dim_names``): one per mesh dim, ``Shard(d)`` for the tensor
    dim ``d`` whose entry names it, else ``Replicate()``.  A tuple entry
    must name its mesh dims in the mesh's order (major first): DTensor
    shards one tensor dim over several mesh dims in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("placements: the DeviceMesh has no mesh_dim_names")
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dims")
    owner: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        group = (entry,) if isinstance(entry, str) else tuple(entry or ())
        order = [names.index(a) for a in group if a in names]
        if len(order) != len(group):
            raise ValueError(f"spec {spec} names a mesh axis outside {names}")
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for a in group:
            if a in owner:
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the twin of ``jax.sharding.NamedSharding``."""
    mesh: Any          # torch.distributed.device_mesh.DeviceMesh
    spec: Spec

    def placements(self, ndim: int) -> tuple:
        return placements(self.mesh, self.spec, ndim)

    def distribute(self, tensor):
        """``tensor`` (the whole value, on every rank) as a ``DTensor``
        laid out by this sharding."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(tensor, self.mesh,
                                 self.placements(tensor.dim()))


# --------------------------------------------------------------------------
# Active-context activation constraints
# --------------------------------------------------------------------------

_ACTIVE = threading.local()


@contextlib.contextmanager
def set_active(mesh, rules: Optional[AxisRules]):
    prev = getattr(_ACTIVE, "ctx", None)
    _ACTIVE.ctx = (mesh, rules) if mesh is not None else None
    try:
        yield
    finally:
        _ACTIVE.ctx = prev


def _redistribute(x, spec: Spec):
    """``x`` redistributed to ``spec`` on the active mesh, when a context
    is active and ``x`` is a ``DTensor``; else ``x`` itself."""
    ctx = getattr(_ACTIVE, "ctx", None)
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, _ = ctx
    return x.redistribute(mesh, placements(mesh, spec, x.dim()))


def shard_act(x, *names: Optional[str]):
    """Constrain an activation's sharding by logical names (no-op when no
    mesh/rules context is active, or on a plain tensor — smoke tests and
    single-device runs)."""
    ctx = getattr(_ACTIVE, "ctx", None)
    if ctx is None:
        return x
    return _redistribute(x, ctx[1].spec_for(names, x.shape))


def collective_matmul_hint(x, spec: Spec):
    """``shard_act`` with an explicit spec: lay out an intermediate so the
    gather can overlap the product that consumes it."""
    return _redistribute(x, spec)


def active_flag(name: str) -> bool:
    """Model code can branch on layout flags."""
    ctx = getattr(_ACTIVE, "ctx", None)
    if ctx is None:
        return False
    _, rules = ctx
    return name in getattr(rules, "flags", ())


# --------------------------------------------------------------------------
# Building shardings for whole trees
# --------------------------------------------------------------------------


def logical_spec(rules: AxisRules, axes, shape) -> Spec:
    return rules.spec_for(axes, shape)


def make_shardings(mesh, rules: AxisRules, annotated_tree):
    """Annotated Param tree -> NamedSharding tree (same structure, unboxed)."""
    def one(p):
        if not is_param(p):
            return NamedSharding(mesh, ())
        return NamedSharding(mesh, rules.spec_for(p.axes, p.value.shape))
    return TR.map_tree(one, annotated_tree)


def spec_tree(rules: AxisRules, annotated_tree):
    def one(p):
        if not is_param(p):
            return ()
        return rules.spec_for(p.axes, p.value.shape)
    return TR.map_tree(one, annotated_tree)


def batch_shardings(mesh, rules: AxisRules, shapes: Dict[str, Any],
                    axes: Dict[str, Tuple[Optional[str], ...]]):
    return {
        k: NamedSharding(mesh, rules.spec_for(axes[k], shapes[k].shape))
        for k in shapes
    }

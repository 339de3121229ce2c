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


def _constrained(x, layout):
    """``x`` redistributed to ``layout``, and its gradient too: the twin of
    ``jax.lax.with_sharding_constraint``, whose transpose constrains the
    cotangent to the same sharding (a plain ``redistribute`` would hand
    the gradient back in whatever layout it arrives, a partial sum
    included)."""
    import torch

    class Constrain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.redistribute(t.device_mesh, layout)

        @staticmethod
        def backward(ctx, g):
            return g.redistribute(g.device_mesh, layout)
    return Constrain.apply(x)


def _redistribute(x, spec: Spec):
    """``x`` laid out by ``spec`` on the active mesh, forward and backward,
    when a context is active and ``x`` is a ``DTensor``; else ``x``
    itself."""
    ctx = getattr(_ACTIVE, "ctx", None)
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, _ = ctx
    return _constrained(x, placements(mesh, spec, x.dim()))


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


# --------------------------------------------------------------------------
# Per-rank regions: what the models compute on DTensors (the dry-run)
# --------------------------------------------------------------------------
# Each helper is the plain torch call on a plain tensor.  On DTensors it
# lays its operands out as GSPMD would and runs the call on each rank's
# local shards, with the collectives that layout needs, where DTensor's
# own sharding strategies differ between torch versions or gather whole
# tensors.


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def local_shape(x):
    """The shape of this rank's shard of ``x`` (a plain tensor's own)."""
    return x.to_local().shape if is_dtensor(x) else x.shape


def _dtensor(t, mesh):
    """``t`` as a ``DTensor`` on ``mesh``: a plain tensor counts as
    replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim)


def per_rank(fn, mesh, args, layouts, out_layout):
    """``fn`` on each rank's local shards: every tensor of ``args`` laid
    out by its entry of ``layouts`` (placements; None passes the argument
    as it is), ``fn`` called on the local tensors, and its output taken as
    the local shard of a ``DTensor`` laid out by ``out_layout`` (a tuple of
    placements, or a list of them for a tuple of outputs).  The region a
    model computes independently along the dims its shards split, as
    GSPMD partitions it, with no collective inside.  An input replicated
    on a mesh dim that splits the output (sharded or partial there) gets
    a partial gradient there: each rank's share of the work adds its
    own part."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    outs = out_layout if isinstance(out_layout, list) else [out_layout]
    split = [any(not isinstance(lay[i], Replicate) for lay in outs)
             for i in range(mesh.ndim)]
    local = []
    for a, lay in zip(args, layouts):
        if lay is None:
            local.append(a)
            continue
        grad = tuple(Partial() if split[i] and isinstance(p, Replicate)
                     else p for i, p in enumerate(lay))
        local.append(_dtensor(a, mesh).redistribute(mesh, lay).to_local(
            grad_placements=grad))
    out = fn(*local)
    if isinstance(out_layout, list):
        return tuple(DTensor.from_local(o, mesh, lay)
                     for o, lay in zip(out, out_layout))
    return DTensor.from_local(out, mesh, out_layout)


def einsum_per_rank(eq: str, a, b):
    """``torch.einsum(eq, a, b)`` of two operands.  On ``DTensor``s each
    rank multiplies its own shards (``per_rank``), laid out mesh dim by
    mesh dim as GSPMD lays out a dot: one letter is sharded there in both
    operands that carry it, the other operand re-laid along that mesh dim
    (gathered if it lacks the letter); a partial operand is reduced
    first.  The product is sharded where that letter survives and partial
    where it is contracted.  The letter is the one an operand already
    shards there, the first operand's where both do, each a different
    one, unless the first's is contracted: then it is the cheaper by bytes
    (``_relayout_bytes``), the second's where moving the first operand
    and reducing the product moves fewer bytes than moving the second.
    So a decode step's attention output, split by heads, multiplies an
    FSDP weight's blocks in place instead of re-laying the weight by
    heads; a letter the product keeps (the batch) keeps its layout, which
    the layers after it expect.  DTensor's own einsum flattens the
    operands' dims, which some torch versions cannot do for a sharded dim
    behind another."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(a, DTensor) and not isinstance(b, DTensor):
        return torch.einsum(eq, a, b)
    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    a, b = _dtensor(a, mesh), _dtensor(b, mesh)
    ins, out = eq.replace(" ", "").split("->")
    sa, sb = ins.split(",")
    extra = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"       # what "..." stands for
    if "..." in sa or "..." in sb:
        n = (a.dim() - len(sa.replace("...", ""))) if "..." in sa else \
            (b.dim() - len(sb.replace("...", "")))
        sa, sb, out = (t.replace("...", extra[:n]) for t in (sa, sb, out))

    def letter(t, s, i):
        p = t.placements[i]
        return s[p.dim] if isinstance(p, Shard) else None
    letters = [letter(a, sa, i) or letter(b, sb, i) for i in range(mesh.ndim)]
    for i in range(mesh.ndim):
        La, Lb = letter(a, sa, i), letter(b, sb, i)
        if La and Lb and La != Lb and La not in out and _relayout_bytes(
                mesh, i, Lb, (sb, b), (sa, a), out, letters) < \
                _relayout_bytes(mesh, i, La, (sa, a), (sb, b), out, letters):
            letters[i] = Lb
    lay_a, lay_b, lay_o = [], [], []
    for L in letters:
        for s, lay in ((sa, lay_a), (sb, lay_b)):
            lay.append(Shard(s.index(L)) if L and L in s else Replicate())
        lay_o.append(Shard(out.index(L)) if L and L in out else
                     Partial() if L else Replicate())
    return per_rank(lambda x, y: torch.einsum(f"{sa},{sb}->{out}", x, y),
                    mesh, (a, b), (tuple(lay_a), tuple(lay_b)),
                    tuple(lay_o))


def replicated(x):
    """``x`` with the partial sums it holds all-reduced, its other
    placements kept (a plain tensor as it is)."""
    from torch.distributed.tensor import Partial, Replicate
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if isinstance(p, Partial) else p for p in x.placements))


def _relayout_bytes(mesh, i, L, kept, moved, out, letters) -> float:
    """The bytes a rank moves along mesh dim ``i`` of size g when the
    einsum shards letter ``L`` there, which the ``kept`` operand already
    shards ((letters, DTensor) pairs): the ``moved`` operand is re-laid,
    by an all-to-all (its local bytes) if it carries ``L``, else gathered
    ((g - 1) times its local bytes), and a contracted ``L`` leaves a
    partial product to all-reduce (2 (g - 1) / g of its local bytes, the
    product split as ``letters`` gives for the other mesh dims)."""
    g = mesh.size(i)
    (sm, m), (sk, k) = moved, kept
    local = m.to_local()
    nbytes = local.numel() * local.element_size()
    cost = float(nbytes if L in sm else (g - 1) * nbytes)
    if L not in out:
        size = {c: n for s, t in (moved, kept) for c, n in zip(s, t.shape)}
        n_out = math.prod(size[c] for c in out)
        n_out /= math.prod(mesh.size(j) for j, c in enumerate(letters)
                           if j != i and c and c in out)
        cost += 2 * (g - 1) / g * n_out * local.element_size()
    return cost


def shard_dims(x, dim: int) -> list:
    """The mesh dims on which ``x`` shards tensor dim ``dim`` (none for a
    plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, DTensor):
        return []
    return [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim % x.dim()]


def embed_rows(table, tokens):
    """``table[tokens]``: rows of a [V, d] table at integer ``tokens``.  On
    a ``DTensor`` table sharded along V (vocab-parallel) each rank looks up
    the rows it holds, zero elsewhere, and the result is their sum (a
    ``Partial`` placement), laid out over batch as ``tokens``; a table
    sharded along d (FSDP) is gathered first.  DTensor's own gather
    strategy fails on such tables in some torch versions."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    tokens = _dtensor(tokens, mesh)
    vocab = shard_dims(table, 0)
    batch = shard_dims(tokens, 0)
    n = table.shape[0] // math.prod(mesh.size(i) for i in vocab)
    v0 = block_index(mesh, vocab) * n

    def lookup(t, idx):
        rel = idx.long() - v0
        inside = (rel >= 0) & (rel < n)
        rows = t[rel.clamp(0, n - 1)]
        return torch.where(inside[..., None], rows, torch.zeros_like(rows))
    return per_rank(
        lookup, mesh, (table, tokens),
        (tuple(Shard(0) if i in vocab else Replicate()
               for i in range(mesh.ndim)),
         tuple(Shard(0) if i in batch else Replicate()
               for i in range(mesh.ndim))),
        tuple(Shard(0) if i in batch else Partial() if i in vocab
              else Replicate() for i in range(mesh.ndim)))


def put_prefix(dst, x):
    """A prompt's K/V x [B, S, ...] written into a cache dst [B, T, ...] in
    place: slots [0, S) when S < T, else the last T positions, each at
    slot position % T (a ring).  On a ``DTensor`` dst (sharded along B, T
    or later dims) each rank writes its own block of slots from x laid
    out as dst's rows; DTensor has no strategy for the roll."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    S, T = x.shape[1], dst.shape[1]
    if not isinstance(dst, DTensor):
        if S >= T:
            dst[:] = torch.roll(x[:, S - T:], S % T, dims=1)
        else:
            dst[:, :S] = x
        return
    mesh, pl = dst.device_mesh, dst.placements
    split = shard_dims(dst, 1)
    n = T // math.prod(mesh.size(i) for i in split)
    t = block_index(mesh, split) * n + torch.arange(n, device=x.device)
    src = S - T + (t - S % T) % T if S >= T else t   # the position at t
    x = _dtensor(x, mesh).redistribute(mesh, tuple(
        Replicate() if isinstance(p, Shard) and p.dim == 1 else p
        for p in pl)).to_local()
    loc = dst.to_local()
    inside = (src < S).view(1, n, *(1,) * (loc.dim() - 2))
    loc[:] = torch.where(inside, x.index_select(1, src.clamp(max=S - 1)).to(
        loc.dtype), loc)


def laid_out_as(x, like):
    """``x`` redistributed to ``like``'s placements when both are
    ``DTensor``s (a gradient laid out as its parameter, as JAX's jit lays
    it), else ``x`` itself."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) and isinstance(like, DTensor):
        return x.redistribute(like.device_mesh, like.placements)
    return x


def block_index(mesh, dims) -> int:
    """This rank's block along the mesh dims ``dims`` that split one tensor
    dim, major mesh dim first (DTensor's order)."""
    block = 0
    for i in dims:
        block = block * mesh.size(i) + mesh.get_local_rank(i)
    return block


def attend_per_rank(attend, q, k, v, *, part=None, **kw):
    """``attend(q, k, v, **kw)`` for q [B, S, H, D] and k/v [B, T, KVH, D]
    (GQA); on ``DTensor``s, each rank attends its own batch rows and heads
    on its local shards, as GSPMD partitions attention laid out over batch
    and heads.  k/v (and every tensor keyword, such as decode's
    ``lengths`` [B]; a plain one counts as replicated) are laid out as q
    over batch, k/v over heads too where KVH splits as H does; where it
    does not, each rank takes the one KV head its query heads share
    (their count must divide the group size H / KVH), and that head's
    gradient is the sum of the ranks' parts.  q keeps its batch and head
    shards; a partial sum is reduce-scattered over heads where they
    split, else reduced, and any other shard gathered.

    A k/v sharded along T (a decode step's cache) stays so when ``part``
    is given: ``part(q, k, v, t0=..., **kw)`` attends each rank's block of
    slots (q gathered over the heads where the same mesh dim splits T),
    giving its output and log-sum-exp, and the blocks combine by a max
    and two sums over the mesh dims that split T (flash decoding); else
    T is gathered."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(q, DTensor):
        return attend(q, k, v, **kw)
    mesh = q.device_mesh
    batch = shard_dims(q, 0)
    tsplit = ([i for i in shard_dims(k, 1) if i not in batch]
              if part is not None else [])
    heads = [i for i in shard_dims(q, 2) if i not in tsplit]
    for i, p in enumerate(q.placements):     # a partial q: reduce-scatter
        if (isinstance(p, Partial) and i not in tsplit
                and q.shape[2] % math.prod(
                    mesh.size(j) for j in heads + [i]) == 0):
            heads.append(i)
    heads.sort()
    q = q.redistribute(mesh, tuple(
        Shard(0) if i in batch else Shard(2) if i in heads else Replicate()
        for i in range(mesh.ndim)))
    split = math.prod(mesh.size(i) for i in heads)
    H, KVH = q.shape[2], k.shape[2]
    kv_heads = KVH % split == 0
    layout = tuple(Shard(0) if i in batch else Shard(1) if i in tsplit else
                   Shard(2) if i in heads and kv_heads else Replicate()
                   for i in range(mesh.ndim))
    grads = tuple(Partial() if i in heads and not kv_heads else p
                  for i, p in enumerate(layout))
    k, v = (t.redistribute(mesh, layout).to_local(grad_placements=grads)
            for t in (k, v))
    if heads and not kv_heads:
        local, group = H // split, H // KVH
        if group % local:
            raise ValueError(f"{local} query heads a rank over {KVH} KV "
                             f"heads of {group} each: a rank's heads must "
                             f"share one KV head")
        kv0 = block_index(mesh, heads) * local // group
        k, v = k[:, :, kv0:kv0 + 1], v[:, :, kv0:kv0 + 1]
    for name, t in kw.items():
        if isinstance(t, torch.Tensor):
            kw[name] = _dtensor(t, mesh).redistribute(mesh, tuple(
                Shard(0) if i in batch else Replicate()
                for i in range(mesh.ndim))).to_local()
    if not tsplit:
        return DTensor.from_local(attend(q.to_local(), k, v, **kw), mesh,
                                  q.placements)
    o, lse = part(q.to_local(), k, v,
                  t0=block_index(mesh, tsplit) * k.shape[1], **kw)

    def over_t(local, op, head_dim):
        """``local``'s reduction by ``op`` over the mesh dims splitting T."""
        t = DTensor.from_local(local, mesh, tuple(
            Partial(op) if i in tsplit else Shard(0) if i in batch else
            Shard(head_dim) if i in heads else Replicate()
            for i in range(mesh.ndim)))
        return t.redistribute(mesh, tuple(
            Replicate() if i in tsplit else p
            for i, p in enumerate(t.placements))).to_local()
    m = over_t(lse, "max", 1)
    w = torch.exp(lse - m)
    out = (over_t(o * w[:, None, :, None], "sum", 2)
           / over_t(w, "sum", 1)[:, None, :, None])
    return DTensor.from_local(out.to(q.dtype), mesh, q.placements)


def logsumexp_last(x):
    """``torch.logsumexp(x, dim=-1)``.  On a ``DTensor`` sharded along its
    last dim (vocab-parallel logits) each rank reduces its own columns and
    the ranks combine a max and a sum of the per-rank partials (two
    all-reduces of [...]), as GSPMD partitions a reduction along a sharded
    axis, so the logits and their gradient stay sharded; DTensor's own
    strategy gathers the whole [..., V] first."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate
    split = shard_dims(x, -1)
    if not split:
        return torch.logsumexp(x, dim=-1)
    mesh = x.device_mesh

    def combined(local, op):
        part = DTensor.from_local(local, mesh, tuple(
            Partial(op) if i in split else p
            for i, p in enumerate(x.placements)))
        return part.redistribute(mesh, tuple(
            Replicate() if i in split else p
            for i, p in enumerate(x.placements)))
    local = x.to_local()
    m = combined(local.detach().amax(-1), "max")
    total = combined(torch.exp(local - m.to_local()[..., None]).sum(-1),
                     "sum")
    return torch.log(total) + m


def put_rows(dst, slots, x):
    """``dst[b, slots[b]] = x[b]`` for every row b, in place: dst
    [B, T, ...], slots [B] integer, x [B, ...].  On a ``DTensor`` dst
    (sharded along B, T or later dims) each rank writes the rows it holds
    at the slots inside its own block of T: a decode step's cache write,
    with no collective beyond laying x and slots out as dst's rows."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(dst, DTensor):
        dst[torch.arange(dst.shape[0], device=dst.device), slots] = x
        return
    mesh, pl = dst.device_mesh, dst.placements

    def local(t, layout):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim)
        return t.redistribute(mesh, layout).to_local()
    # x and slots laid out as dst's rows (T dropped: later dims move up)
    x = local(x, tuple(Shard(p.dim - (p.dim > 1)) if isinstance(p, Shard)
                       and p.dim != 1 else Replicate() for p in pl))
    slots = local(slots, tuple(p if isinstance(p, Shard) and p.dim == 0
                               else Replicate() for p in pl))
    loc = dst.to_local()
    n = loc.shape[1]
    split = shard_dims(dst, 1)
    rel = slots.long() - block_index(mesh, split) * n
    inside = ((rel >= 0) & (rel < n)).view(-1, *(1,) * (x.dim() - 1))
    rows = torch.arange(loc.shape[0], device=loc.device)
    rel = rel.clamp(0, n - 1)
    loc[rows, rel] = torch.where(inside, x.to(loc.dtype), loc[rows, rel])


def take_last(x, idx):
    """``x``'s entries at ``idx`` along its last dim: [..., V] at [...]
    integer indices -> [...], a ``torch.gather`` on a plain tensor.  On a
    ``DTensor`` each rank gathers from its own shard, idx laid out as x's
    leading dims; where x is sharded along its last dim (vocab-parallel
    logits) it takes the columns it holds, zero elsewhere, and the result
    is the sum of those partials (a ``Partial`` placement), as GSPMD
    partitions a gather along a sharded axis.  DTensor's own gather
    cannot reduce its masked partial on ``meta`` shards, and its backward
    makes a zero gradient of x's global shape on every rank."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor):
        return torch.gather(x, -1, idx[..., None].long())[..., 0]
    mesh = x.device_mesh
    split = shard_dims(x, -1)
    n = x.shape[-1] // math.prod(mesh.size(i) for i in split)
    v0 = block_index(mesh, split) * n
    layout = tuple(Replicate() if isinstance(p, Partial) else p
                   for p in x.placements)

    def gather(xl, il):
        rel = il.long() - v0
        got = torch.gather(xl, -1, rel.clamp(0, n - 1)[..., None])[..., 0]
        inside = (rel >= 0) & (rel < n)
        return torch.where(inside, got, torch.zeros_like(got))
    return per_rank(gather, mesh, (x, idx), (
        layout, tuple(Replicate() if i in split else p
                      for i, p in enumerate(layout))),
        tuple(Partial() if i in split else p for i, p in enumerate(layout)))


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

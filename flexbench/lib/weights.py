"""The weights, made by the benchmark on the device from the run's seed
and handed alike to the program and to the reference.

The program's tree of parameters is read from ``Model.init`` on the
``meta`` device (shapes and dtypes, nothing drawn).  Each dtype's leaves
share one flat buffer, filled with N(0, 1) by a ``torch.Generator`` on the
device in calls of at most 2**30 values, in the dtype the leaf is served
in; each leaf is a view of it, scaled by its rule:

* a matrix: 1 / sqrt(fan-in), the fan-in the product of the dimensions
  the rule names (negative, from the end);
* the embedding: N(0, 1);
* a norm's ``scale``: 1 + 0.1 N(0, 1), its ``bias``: 0.1 N(0, 1), so that
  both are tested.

The rules are the configuration file's ``init`` (``"parent.leaf": [dims]``)
over the defaults below.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 30
ALIGN = 256                       # elements: each leaf starts aligned

# (parent key, leaf key) -> the dimensions of the fan-in, from the end
FAN_DIMS = {
    ("attn", "wq"): (-3,), ("attn", "wk"): (-3,), ("attn", "wv"): (-3,),
    ("attn", "wo"): (-3, -2),
    ("mlp", "wi"): (-2,), ("mlp", "wg"): (-2,), ("mlp", "wo"): (-2,),
    ("moe", "router"): (-2,), ("moe", "w_up"): (-2,),
    ("moe", "w_gate"): (-2,), ("moe", "w_down"): (-2,),
    ("", "head"): (-2,),
}


def _leaves(tree, path=()) -> List[Tuple[tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree) for x in _leaves(t,
                                                               path + (i,))]
    return [(path, tree)]


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _rule(path, rules: Dict[str, List[int]]):
    """('embed' | 'scale' | 'bias' | 'matrix', fan dims) of a leaf."""
    leaf = path[-1]
    parent = next((p for p in reversed(path[:-1]) if isinstance(p, str)),
                  "")
    if path == ("embed",):
        return "embed", ()
    if leaf in ("scale", "bias"):
        return leaf, ()
    key = f"{parent}.{leaf}" if parent else leaf
    if key in rules:
        return "matrix", tuple(rules[key])
    if (parent, leaf) in FAN_DIMS:
        return "matrix", FAN_DIMS[(parent, leaf)]
    raise ValueError(f"no init rule for parameter {'/'.join(map(str, path))}"
                     f": give one in the configuration's \"init\"")


@torch.no_grad()
def make(model, seed: int, device, rules: Dict[str, List[int]] = None):
    """The parameter tree of ``model`` (a ``repro_torch`` Model), drawn
    from ``seed`` on ``device``."""
    rules = rules or {}
    tree = model.init(0, device="meta")
    leaves = _leaves(tree)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    by_dtype: Dict[torch.dtype, list] = {}
    for path, t in leaves:
        by_dtype.setdefault(t.dtype, []).append((path, t))
    for dtype in sorted(by_dtype, key=str):
        group = by_dtype[dtype]
        offsets, n = [], 0
        for _, t in group:
            offsets.append(n)
            n += -(-t.numel() // ALIGN) * ALIGN
        flat = torch.empty(n, dtype=dtype, device=device)
        for c in flat.split(CHUNK):
            c.normal_(generator=gen)
        for (path, t), off in zip(group, offsets):
            x = flat[off:off + t.numel()].view(t.shape)
            kind, dims = _rule(path, rules)
            if kind == "scale":
                x.mul_(0.1).add_(1.0)
            elif kind == "bias":
                x.mul_(0.1)
            elif kind == "matrix":
                fan = math.prod(t.shape[d] for d in dims)
                x.mul_(1.0 / math.sqrt(fan))
            _set(tree, path, x)
    return tree

"""Parameter and optimizer trees: nested dicts and lists of tensors.

The port's stand-in for ``jax.tree_util`` where the training and checkpoint
code need one: leaves in JAX's order (dict keys sorted, lists in order),
each named by its path as ``jax.tree_util.keystr`` names it
(``['blocks'][0]['attn']['wq']``), so both packages list a tree's leaves
alike.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in JAX's leaf order."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in flatten_with_paths(tree[key],
                                               f"{prefix}[{key!r}]")]
    if isinstance(tree, (list, tuple)):
        return [item for i, sub in enumerate(tree)
                for item in flatten_with_paths(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def map_tree(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), called in JAX's leaf order, in
    a tree of that structure."""
    if isinstance(tree, dict):
        return {key: map_tree(fn, tree[key], *(r[key] for r in rest))
                for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, sub, *(r[i] for r in rest))
                          for i, sub in enumerate(tree))
    return fn(tree, *rest)


def unflatten_like(like, values: List[Any]):
    """A tree shaped like ``like`` whose leaves are ``values``, taken in
    ``flatten_with_paths`` order."""
    values = list(values)
    n = len(flatten_with_paths(like))
    if len(values) != n:
        raise ValueError(f"{len(values)} values for a tree of {n} leaves")
    it = iter(values)
    return map_tree(lambda _: next(it), like)

"""Nested dicts of tensors, flattened in JAX's ``tree_flatten`` order.

JAX flattens a dict by its sorted keys, depth first. The optimizer's
per-leaf stochastic-rounding seeds depend on a leaf's index in that order,
so the port walks its parameter dicts the same way.
"""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """Leaves of a nested dict, sorted keys, depth first."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_paths(tree, prefix: str = "") -> list:
    """'/'-joined key paths of the leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for key in sorted(tree)
                for p in tree_paths(tree[key], f"{prefix}{key}/")]
    return [prefix.rstrip("/")]


def tree_unflatten(like, leaves) -> dict:
    """A tree shaped like ``like`` holding ``leaves`` (in leaf order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {key: build(node[key]) for key in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (nested dicts, lists and tuples)
    and the matching leaves of ``rest``; the result has ``tree``'s shape."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)

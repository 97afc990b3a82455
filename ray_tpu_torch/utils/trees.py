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

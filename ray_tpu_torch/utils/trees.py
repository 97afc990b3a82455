"""Nested dicts of tensors, flattened in JAX's ``tree_flatten`` order.

JAX flattens a dict by its sorted keys, depth first. The optimizer's
per-leaf stochastic-rounding seeds depend on a leaf's index in that order,
so the port walks its parameter dicts the same way.
"""

from __future__ import annotations

import numpy as np


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


def _path_leaves(tree, path=()) -> list:
    """(path, leaf) pairs in JAX's flatten order over nested dicts (sorted
    keys), lists and tuples (in order); None holds no leaf, as in JAX.
    A path is the tuple of keys and indices from the root."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for key in sorted(tree)
                for pl in _path_leaves(tree[key], path + (key,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree)
                for pl in _path_leaves(x, path + (i,))]
    return [(path, tree)]


def tree_num_params(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(int(np.prod(x.shape)) for _, x in _path_leaves(tree))


def tree_size_bytes(tree) -> int:
    """Total bytes across all leaves (numpy arrays or torch tensors)."""
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for _, x in _path_leaves(tree))


def path_name(path) -> str:
    """Slash-joined name of a path of keys and indices ('a/b/0/c')."""
    return "/".join(str(p) for p in path)


def tree_map_with_path_names(fn, tree):
    """Like ``tree_map``, but ``fn`` receives ('a/b/c', leaf)."""
    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(node[k], path + (k,)) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(x, path + (i,)) for i, x in enumerate(node))
        return fn(path_name(path), node)

    return walk(tree, ())

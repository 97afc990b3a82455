"""Parameter trees, walked in JAX's ``tree_flatten`` order.

One walker (:func:`_rebuild`) serves every helper here. Dicts are walked
by their sorted keys, lists and tuples in order, and ``None`` is an empty
subtree, as in ``jax.tree_util``; anything else is a leaf, a tuple
subclass included (the port's ``NamedSharding`` is a NamedTuple and
stands for JAX's ``NamedSharding``, which is a leaf). As in JAX,
``is_leaf(node)`` true makes a node a leaf (a tree of logical-axis
tuples takes ``lambda x: isinstance(x, tuple)``). The optimizer's
per-leaf stochastic-rounding seeds depend on a leaf's index in that
order, so the port walks its parameter trees the same way. A rebuilt dict
keeps the key order of the tree it was built from.
"""

from __future__ import annotations

import numpy as np


def _rebuild(node, fn, path=(), is_leaf=None):
    """``node`` with each leaf replaced by ``fn(path, leaf)``, the leaves
    visited in JAX's flatten order; a path is the tuple of keys and
    indices from the root."""
    if is_leaf is not None and is_leaf(node):
        return fn(path, node)
    if node is None:
        return None
    if isinstance(node, dict):
        out = {k: _rebuild(node[k], fn, path + (k,), is_leaf)
               for k in sorted(node)}
        return {k: out[k] for k in node}
    if type(node) in (list, tuple):
        return type(node)(_rebuild(x, fn, path + (i,), is_leaf)
                          for i, x in enumerate(node))
    return fn(path, node)


def _path_leaves(tree, is_leaf=None) -> list:
    """(path, leaf) pairs in JAX's flatten order."""
    out: list = []
    _rebuild(tree, lambda path, leaf: out.append((path, leaf)),
             is_leaf=is_leaf)
    return out


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def tree_leaves(tree, is_leaf=None) -> list:
    """The leaves, in JAX's flatten order."""
    return [leaf for _, leaf in _path_leaves(tree, is_leaf)]


def tree_paths(tree, prefix: str = "", is_leaf=None) -> list:
    """'/'-joined key paths of the leaves, in ``tree_leaves`` order, each
    after ``prefix``."""
    return [prefix + path_name(path)
            for path, _ in _path_leaves(tree, is_leaf)]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in leaf order)."""
    it = iter(leaves)
    sentinel = object()

    def take(path, _):
        leaf = next(it, sentinel)
        if leaf is sentinel:
            raise ValueError("fewer leaves than the tree has")
        return leaf

    out = _rebuild(like, take)
    if next(it, sentinel) is not sentinel:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of ``tree``'s shape); the result has ``tree``'s
    shape."""
    return _rebuild(tree, lambda path, leaf: fn(
        leaf, *(_at(r, path) for r in rest)))


def tree_num_params(tree) -> int:
    """Total number of elements across all leaves."""
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def tree_size_bytes(tree) -> int:
    """Total bytes across all leaves (numpy arrays or torch tensors)."""
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize
               for x in tree_leaves(tree))


def path_name(path) -> str:
    """Slash-joined name of a path of keys and indices ('a/b/0/c')."""
    return "/".join(str(p) for p in path)


def tree_map_with_path_names(fn, tree):
    """Like ``tree_map``, but ``fn`` receives ('a/b/c', leaf)."""
    return _rebuild(tree, lambda path, leaf: fn(path_name(path), leaf))

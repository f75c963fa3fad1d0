"""Nested dicts, lists and tuples of tensors: flatten, rebuild, map.

Dict keys flatten in sorted order, as ``jax.tree_util`` does, so a leaf
list (and every bucket built from one) is laid out as in the reference.
``None`` is an empty subtree, not a leaf.
"""
from __future__ import annotations

_LEAF, _NONE, _DICT = "leaf", "none", "dict"


def _walk(t, leaves):
    if isinstance(t, dict):
        keys = sorted(t)
        return (_DICT, keys, [_walk(t[k], leaves) for k in keys])
    if isinstance(t, (list, tuple)):
        return (type(t), None, [_walk(x, leaves) for x in t])
    if t is None:
        return (_NONE, None, [])
    leaves.append(t)
    return (_LEAF, None, [])


def tree_flatten(tree):
    """tree -> (leaves, treedef).  The walk is a module-level function: a
    nested one that calls itself is a reference cycle, which would keep
    the leaves it collected alive until the next garbage-collector pass
    (a whole optimizer state a step, at a backbone's width)."""
    leaves = []
    return leaves, _walk(tree, leaves)


def _build(node, it):
    kind, keys, kids = node
    if kind == _LEAF:
        return next(it)
    if kind == _NONE:
        return None
    if kind == _DICT:
        return {k: _build(c, it) for k, c in zip(keys, kids)}
    return kind(_build(c, it) for c in kids)


def tree_unflatten(treedef, leaves):
    return _build(treedef, iter(leaves))


def tree_leaves(tree) -> list:
    return tree_flatten(tree)[0]


def tree_map(f, tree, *rest):
    """``f`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(r) for r in rest]
    return tree_unflatten(treedef, [f(*xs) for xs in zip(leaves, *others)])

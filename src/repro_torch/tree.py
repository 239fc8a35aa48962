"""The port's trees: what ``jax.tree_util`` does for the JAX package.

A tree is nested dicts, lists, tuples and named tuples (an ``OptState``)
over tensor leaves and :class:`~repro_torch.quant.QTensor` records. It is
walked in JAX's order: dict keys sorted, a ``None`` an empty subtree, a
QTensor's children ``packed``, ``scales``, ``zeros`` and ``inv_act`` as
leaves ``0`` to ``3`` of its path, a named tuple's fields by name. So a
leaf's path is the one the JAX package gives the same leaf, and
``distributed.sharding.path_str`` writes it as the same string.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, List, Tuple

from repro_torch.quant import QTensor

_QT_CHILDREN = ("packed", "scales", "zeros", "inv_act")


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def flatten_with_path(tree, path: Tuple = (), is_leaf=None) -> List:
    """``[(path, leaf)]`` in JAX's order; a path is a tuple of dict keys,
    field names and sequence / QTensor-child indices. ``is_leaf(node)``
    marks a container type as a leaf."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten_with_path(tree[k], path + (k,), is_leaf)]
    if _is_namedtuple(tree):
        return [x for k in tree._fields
                for x in flatten_with_path(getattr(tree, k), path + (k,),
                                           is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flatten_with_path(v, path + (i,), is_leaf)]
    if isinstance(tree, QTensor):
        return [x for i, name in enumerate(_QT_CHILDREN)
                for x in flatten_with_path(getattr(tree, name), path + (i,),
                                           is_leaf)]
    return [(path, tree)]


def map_with_path(fn: Callable, tree, path: Tuple = (), is_leaf=None):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``: the same
    containers (a QTensor copied with its children replaced), leaves
    visited in :func:`flatten_with_path`'s order."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        out = {k: map_with_path(fn, tree[k], path + (k,), is_leaf)
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, k), path + (k,),
                                          is_leaf) for k in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,), is_leaf)
                          for i, v in enumerate(tree))
    if isinstance(tree, QTensor):
        out = copy.copy(tree)
        for i, name in enumerate(_QT_CHILDREN):
            setattr(out, name, map_with_path(fn, getattr(tree, name),
                                             path + (i,), is_leaf))
        return out
    return fn(path, tree)


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(tree, new_leaves) -> Any:
    """``tree``'s structure over ``new_leaves``, given in
    :func:`leaves` order."""
    it = iter(new_leaves)
    out = map_with_path(lambda _, __: next(it), tree)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves at the same place in rest)`` over ``tree``'s
    leaves. The other trees have ``tree``'s structure, except that any of
    their leaves may be ``None`` (a gradient that autograd did not
    reach)."""
    others = [dict(flatten_with_path(r)) for r in rest]
    return map_with_path(lambda path, leaf: fn(leaf, *(o.get(path)
                                                       for o in others)),
                         tree)

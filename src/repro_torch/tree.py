"""Nested dicts and lists of tensors: the port's counterpart of JAX pytrees.

The model's parameters (``Transformer.params()``), the optimiser's moments
and the error-feedback buffer are trees of the same structure: dicts keyed
as the JAX package's pytrees, with the layer stack as a list of per-layer
dicts where JAX stacks a leading ``num_layers`` axis.  Dict leaves are
visited in sorted key order, as ``jax.tree_util`` visits them.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["param_tree", "stacked_groups", "tree_leaves", "tree_map"]


def param_tree(params: Any) -> Any:
    """The parameter tree of a model (its ``params()``: a ``Transformer``), or
    ``params`` itself when it already is a tree of tensors."""
    return params.params() if hasattr(params, "params") else params


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree``, dict keys in sorted order, lists in order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``,
    in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, item, *(r[i] for r in rest))
                          for i, item in enumerate(tree))
    return fn(tree, *rest)


def stacked_groups(tree: Any) -> list[list]:
    """The leaves of ``tree`` grouped as JAX's leaves are: one group per key
    path, holding that path's leaf from every element of a list (the
    layers of a stack, which JAX holds as one array).  Groups in
    ``tree_leaves``' order of their first leaf."""
    groups: dict[tuple, list] = {}

    def walk(t, path):
        if isinstance(t, dict):
            for key in sorted(t):
                walk(t[key], path + (key,))
        elif isinstance(t, (list, tuple)):
            for item in t:
                walk(item, path)
        else:
            groups.setdefault(path, []).append(t)

    walk(tree, ())
    return list(groups.values())

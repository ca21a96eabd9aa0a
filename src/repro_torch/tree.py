"""Trees of tensors: nested dicts, NamedTuples, lists and tuples, with
``None`` as an empty subtree.

The training slice's counterpart of ``jax.tree``: the optimizers map over
the params, the checkpoint flattens a train state by path and the trainer
takes gradients of its leaves.  The leaf order is the reference's: dict
keys sorted, NamedTuple fields and sequence items in order.  DMF-Shampoo
staggers its refreshes by a leaf's index in that order, so the order is
part of its result.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["leaves", "tree_map", "flatten_with_paths", "unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key, child) pairs of an inner node, in leaf order; None for a
    leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _rebuild(tree, values):
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), values))
    if _is_namedtuple(tree):
        return type(tree)(*values)
    return type(tree)(values)


def leaves(tree) -> list:
    """The leaves of ``tree`` in order (``None`` has none)."""
    return [leaf for _, leaf in flatten_with_paths(tree)]


def flatten_with_paths(tree, prefix: str = "") -> list:
    """``(path, leaf)`` pairs, the path the keys joined by ``/``."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += flatten_with_paths(child, f"{prefix}/{key}" if prefix
                                  else str(key))
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; ``None`` subtrees of ``tree`` stay ``None``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [_children(r) for r in rest]
    return _rebuild(tree, [
        tree_map(fn, child, *(o[i][1] for o in others))
        for i, (_, child) in enumerate(kids)])


def unflatten(template, values) -> Any:
    """A tree of ``template``'s structure with the leaves ``values``, in
    order."""
    values = list(values)
    n = len(leaves(template))
    if len(values) != n:
        raise ValueError(f"unflatten: {len(values)} values for a template "
                         f"of {n} leaves")
    it: Iterator = iter(values)
    return tree_map(lambda _: next(it), template)

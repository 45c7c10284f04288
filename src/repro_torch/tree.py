"""Nested-container helpers over the port's state trees (what `jax.tree`
did for the reference): dicts, NamedTuples, tuples and lists of tensors,
with None as an empty subtree. A tuple whose type sets `is_tree_leaf`
(a sharding spec, `distributed.sharding.P`) is a leaf.

Dicts are walked in sorted key order, as `jax.tree_util` walks them, so a
reduction over the leaves (`optim.global_norm`) sums in the reference's
order. `tree_flatten_with_names` names each leaf as the reference's
checkpoint does (`runtime/checkpoint.py::_flatten`): a dict key as itself,
a NamedTuple field as ".field", a sequence index as its number, joined by
"/" — so `TrainState.opt.m["embed"]` is ".opt/.m/embed".
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Tuple

__all__ = ["tree_map", "tree_leaves", "tree_flatten_with_names", "tree_unflatten_like"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[str, object]]:
    """(name, child) pairs of a container, in the reference's order."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    return [(str(i), x) for i, x in enumerate(tree)]


def _is_container(tree) -> bool:
    return isinstance(tree, (dict, tuple, list)) and not getattr(tree, "is_tree_leaf", False)


def tree_map(fn: Callable, tree, *rest):
    """`fn` over the leaves of `tree` (and the matching leaves of `rest`)."""
    if tree is None:
        return None
    if not _is_container(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest)) for i, x in enumerate(tree))
    return fn(tree, *rest)


def _walk(tree, prefix: str) -> Iterator[Tuple[str, object]]:
    if tree is None:
        return
    if not _is_container(tree):
        yield prefix, tree
        return
    for name, child in _children(tree):
        yield from _walk(child, f"{prefix}/{name}" if prefix else name)


def tree_flatten_with_names(tree) -> List[Tuple[str, object]]:
    """[(name, leaf)] in traversal order, named like the reference's checkpoint."""
    return list(_walk(tree, ""))


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in _walk(tree, "")]


def tree_unflatten_like(tree, leaves) -> object:
    """`tree`'s structure with `leaves` (in `tree_leaves` order) as its leaves."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out

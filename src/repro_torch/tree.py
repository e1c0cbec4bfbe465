"""Trees of tensors: the few ``jax.tree_util`` operations the training
stack needs, over dicts, lists, tuples and NamedTuples.

The order and the key strings are JAX's, so that a checkpoint written by
either package restores in the other: dict keys sorted, a list or tuple
child keyed by its index, a NamedTuple field by ``.<name>`` (JAX's
``GetAttrKey`` as ``str`` prints it), and ``None`` a node with no leaves.
``(params, AdamWState)`` thus flattens to keys such as
``0/groups/0/0/A_log`` and ``1/.step``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(type(node), "_fields")


def _children(node) -> List[Tuple[str, Any]] | None:
    """(key, child) pairs of a container in JAX's order; None for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _rebuild(node, new_children: list):
    """A container like ``node`` holding ``new_children`` (in _children's
    order)."""
    if node is None:
        return None
    if isinstance(node, dict):
        return dict(zip(sorted(node), new_children))
    if _is_namedtuple(node):
        return type(node)(*new_children)
    return type(node)(new_children)


def flatten_with_keys(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in JAX's leaf order; keys join the path with ``/``."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for key, child in kids:
        yield from flatten_with_keys(child, f"{prefix}/{key}" if prefix else key)


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_keys(tree)]


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of ``tree``, in a tree of the same structure."""
    kids = _children(tree)
    if kids is None:
        return fn(tree)
    return _rebuild(tree, [tree_map(fn, child) for _, child in kids])


_END = object()


def unflatten_like(template, new_leaves: list):
    """``template``'s structure with ``new_leaves`` in its leaf order."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the template has")
    return out


__all__ = ["flatten_with_keys", "leaves", "tree_map", "unflatten_like"]

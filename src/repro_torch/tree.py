"""Trees of tensors: the port's parameter, gradient and optimizer-state
containers (nested dicts, lists, tuples and NamedTuples of tensors).

Leaves come in the JAX package's tree order (``jax.tree_util``: dict keys
sorted, list and tuple entries by index, NamedTuple fields in order,
``None`` an empty subtree), so a sum over leaves adds them in the order
the reference adds its own. A path is the tuple of keys from the root:
dict keys, field names and list indices.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple


def children(tree) -> Optional[List[Tuple[Any, Any]]]:
    """(key, child) pairs of a container node in tree order, or None for a
    leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _rebuild(like, kids: List[Tuple[Any, Any]]):
    if isinstance(like, dict):
        return {k: v for k, v in kids}
    vals = [v for _, v in kids]
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def leaves_with_path(tree, path: Tuple = (), is_leaf=None
                     ) -> List[Tuple[Tuple, Any]]:
    if tree is None:
        return []
    kids = None if is_leaf is not None and is_leaf(tree) else children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for key, child in kids:
        out += leaves_with_path(child, path + (key,), is_leaf)
    return out


def leaves(tree, is_leaf=None) -> List[Any]:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf=is_leaf)]


def tree_map(fn: Callable, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (and the matching nodes of
    ``rest``, which must have its structure), in ``tree``'s structure.
    ``is_leaf`` marks further nodes as leaves."""
    return tree_map_with_path(lambda _, *x: fn(*x), tree, *rest,
                              is_leaf=is_leaf)


def tree_map_with_path(fn: Callable, tree, *rest, is_leaf=None,
                       _path: Tuple = ()):
    if tree is None:
        return None
    kids = None if is_leaf is not None and is_leaf(tree) else children(tree)
    if kids is None:
        return fn(_path, tree, *rest)
    others = [children(r) for r in rest]
    for o in others:
        if o is None or [k for k, _ in o] != [k for k, _ in kids]:
            raise ValueError(f"tree structures differ at {_path}")
    out = [(k, tree_map_with_path(fn, child, *(o[i][1] for o in others),
                                  is_leaf=is_leaf, _path=_path + (k,)))
           for i, (k, child) in enumerate(kids)]
    return _rebuild(tree, out)


def unflatten(like, items) -> Any:
    """``like``'s structure with its leaves replaced, in tree order, by
    ``items``."""
    it = iter(items)
    out = tree_map(lambda _: next(it), like)
    if next(it, it) is not it:
        raise ValueError("more items than the tree has leaves")
    return out

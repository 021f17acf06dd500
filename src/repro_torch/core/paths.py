"""Canonical parameter paths and the walk over a params tree.

Weights are keyed by the same ``"blocks/attn/wq"``-style path in the port and
in the JAX package, so compression reports, per-leaf plans and ADMM state
line up.  A params tree is nested dicts of tensors; its leaves are visited
with the keys in sorted order, the order of the reference's flattened
pytree.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple


def path_str(path) -> str:
    """Render a sequence of dict keys (or indices) as a ``/``-joined string."""
    return "/".join(str(p) for p in path)


def iter_leaves(tree: Any, prefix: Tuple = ()) -> Iterator[Tuple[str, Any]]:
    """Yield (path, leaf) for every non-None leaf, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_leaves(tree[k], prefix + (k,))
    elif tree is not None:
        yield path_str(prefix), tree


def leaves(tree: Any) -> List[Any]:
    """The leaves of a tree in :func:`iter_leaves` order."""
    return [leaf for _, leaf in iter_leaves(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def rebuild(tree: Any, by_path: Dict[str, Any], prefix: Tuple = ()) -> Any:
    """The structure of ``tree`` with every leaf taken from ``by_path``."""
    if isinstance(tree, dict):
        return {k: rebuild(v, by_path, prefix + (k,)) for k, v in tree.items()}
    return by_path[path_str(prefix)] if tree is not None else None

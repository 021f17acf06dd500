"""Canonical parameter paths and the walk over a params tree.

Weights are keyed by the same ``"blocks/attn/wq"``-style path in the port and
in the JAX package, so compression reports, per-leaf plans and ADMM state
line up.  A params tree is nested dicts and lists of tensors (xLSTM's
``blocks`` is a list of per-layer dicts, so its paths read
``blocks/0/mlstm/wq``); its leaves are visited in the order of the
reference's flattened pytree: dict keys sorted, list elements in index
order.  Never order leaves by their rendered path strings: ``blocks/10``
sorts before ``blocks/2``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple


def path_str(path) -> str:
    """Render a sequence of dict keys (or indices) as a ``/``-joined string."""
    return "/".join(str(p) for p in path)


def children(tree: Any) -> List[Tuple[Any, Any]]:
    """``(key, child)`` of a dict (keys sorted) or a list (index order);
    empty for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, list):
        return list(enumerate(tree))
    return []


def is_node(tree: Any) -> bool:
    """Whether ``tree`` is an inner node of a params tree (a dict or list)."""
    return isinstance(tree, (dict, list))


def iter_leaves(tree: Any, prefix: Tuple = ()) -> Iterator[Tuple[str, Any]]:
    """Yield (path, leaf) for every non-None leaf, in flatten order."""
    if is_node(tree):
        for k, v in children(tree):
            yield from iter_leaves(v, prefix + (k,))
    elif tree is not None:
        yield path_str(prefix), tree


def leaves(tree: Any) -> List[Any]:
    """The leaves of a tree in :func:`iter_leaves` order."""
    return [leaf for _, leaf in iter_leaves(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def map_with_path(fn: Callable[[str, Any], Any], tree: Any, prefix: Tuple = ()) -> Any:
    """The structure of ``tree`` with every leaf (None included) replaced by
    ``fn(path, leaf)``; dicts keep their key order, lists stay lists."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, prefix + (i,)) for i, v in enumerate(tree)]
    return fn(path_str(prefix), tree)


def map_in_order(fn: Callable[[str, Any], Any], tree: Any, *,
                 load: Optional[Callable[[Tuple, Any], Any]] = None,
                 store: Optional[Callable[[Tuple, Any], Any]] = None,
                 prefix: Tuple = ()) -> Any:
    """The structure of ``tree`` with every leaf replaced by ``fn(path,
    leaf)``, the leaves visited in flatten order; dicts come out with their
    keys sorted, lists stay lists.  ``load(keys, leaf)`` and ``store(keys,
    out)``, when given, wrap each leaf in turn (``keys`` its path as a
    tuple): ``fn`` reads what ``load`` returns and the walk keeps what
    ``store`` makes of the result before it reads the next leaf."""
    if is_node(tree):
        done = {k: map_in_order(fn, v, load=load, store=store, prefix=prefix + (k,))
                for k, v in children(tree)}
        return [done[i] for i in range(len(tree))] if isinstance(tree, list) else done
    out = fn(path_str(prefix), tree if load is None else load(prefix, tree))
    return out if store is None else store(prefix, out)


def rebuild(tree: Any, by_path: Dict[str, Any], prefix: Tuple = ()) -> Any:
    """The structure of ``tree`` with every leaf taken from ``by_path``."""
    return map_with_path(lambda p, leaf: by_path[p] if leaf is not None else None,
                         tree, prefix)

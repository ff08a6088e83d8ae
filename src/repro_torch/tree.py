"""Nested-dict parameter trees: the few ``jax.tree`` operations the port
needs. Dicts flatten in sorted-key order (as ``jax.tree_util`` does),
lists and tuples in order, and a :class:`~repro_torch.core.quant.QTensor`
is one leaf."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def flatten_with_path(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """Yield ``(path, leaf)`` pairs; ``path`` is the tuple of keys."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from flatten_with_path(v, prefix + (k,))


def leaves(tree):
    return [l for _, l in flatten_with_path(tree)]


def path_str(path: Tuple) -> str:
    return "/".join(str(k) for k in path)


def map_with_path(fn: Callable, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over every leaf, keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)

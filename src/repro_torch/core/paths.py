"""Tiny helpers for addressing leaves in nested-dict param trees by path."""
from __future__ import annotations

from typing import Any, Tuple


def get_path(tree: Any, path: Tuple) -> Any:
    node = tree
    for p in path:
        node = node[p]
    return node


def set_path(tree: Any, path: Tuple, value: Any) -> Any:
    """Functional set: returns a new tree with tree[path] = value."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    if isinstance(tree, dict):
        out = dict(tree)
        out[head] = set_path(tree[head], rest, value)
        return out
    if isinstance(tree, (list, tuple)):
        seq = list(tree)
        seq[head] = set_path(seq[head], rest, value)
        return type(tree)(seq) if isinstance(tree, tuple) else seq
    raise TypeError(f"cannot set path {path} in {type(tree)}")

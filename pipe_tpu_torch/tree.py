"""Trees of tensors: nested dicts, lists and tuples with tensor (or host
scalar) leaves — the port's form of the JAX package's pytrees."""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of ``tree``; dicts keep their keys, lists
    and tuples their order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree)

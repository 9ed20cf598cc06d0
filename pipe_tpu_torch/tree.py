"""Trees of tensors: nested dicts, lists and tuples with tensor (or host
scalar) leaves — the port's form of the JAX package's pytrees.

:func:`tree_flatten` lists the leaves in the order ``jax.tree.flatten``
gives for the same tree: dict entries by sorted key, lists and tuples in
order, ``None`` an empty node. Checkpoint keys index leaves in that order,
so a checkpoint written by either package restores into the other."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of ``tree``; dicts keep their keys, lists
    and tuples their order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree)


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` is a nested tuple that compares
    equal for trees of the same structure."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return ("none",)
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", tuple(keys), tuple(walk(t[k]) for k in keys))
        if isinstance(t, (list, tuple)):
            kind = "list" if isinstance(t, list) else "tuple"
            return (kind, tuple(walk(v) for v in t))
        leaves.append(t)
        return ("leaf",)

    treedef = walk(tree)
    return leaves, treedef


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        out = [build(c) for c in d[1]]
        return out if kind == "list" else tuple(out)

    return build(treedef)

"""The ``jax.lax`` primitives the ops lean on, in PyTorch.

- :func:`dynamic_slice` and :func:`dynamic_update_slice_` cut and write a
  window along axis 1 at a host-int start with ``lax``'s index rule: a
  negative start counts from the end (``start + n``, as ``lax`` does for
  traced starts too), then the start is clamped into ``[0, n - width]``,
  so the window always fits. Torch slicing does neither, and some ops
  rely on it: the Delay ring's wrapped-write repair writes at a start that
  is negative when the write does not wrap, and the rule lands it where no
  read reaches.
- :func:`prefix_scan` is the inclusive prefix of an associative combine
  over axis 1 (``lax.associative_scan``), by prefix doubling
  (Hillis–Steele): ``pref[i] = combine(pref[i - k], pref[i])`` for
  k = 1, 2, 4, ... Its combine tree differs from ``lax``'s odd/even
  recursion, so results agree with the JAX package to rounding, not bit for
  bit. O(n log n) combines in log2(n) passes.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from pipe_tpu_torch.tree import tree_flatten, tree_map, tree_unflatten


def _clamped(start: int, n: int, width: int) -> int:
    start = int(start)
    if start < 0:
        start += n
    return min(max(start, 0), n - width)


def dynamic_slice(x: torch.Tensor, start: int, width: int) -> torch.Tensor:
    """``x[:, s : s + width]`` with ``s`` = ``start`` under ``lax``'s index
    rule (see the module docstring): ``lax.dynamic_slice`` on axis 1, as a
    contiguous copy."""
    s = _clamped(start, x.shape[1], width)
    return x[:, s: s + width].contiguous()


def dynamic_update_slice_(x: torch.Tensor, update: torch.Tensor,
                          start: int) -> torch.Tensor:
    """Writes ``update`` into ``x`` at columns ``s : s + w``, ``s`` =
    ``start`` under ``lax``'s index rule (``lax.dynamic_update_slice`` on
    axis 1), in place, and returns ``x`` (for a buffer the caller already
    copied)."""
    w = update.shape[1]
    s = _clamped(start, x.shape[1], w)
    x[:, s: s + w] = update
    return x


def prefix_scan(combine: Callable[[Any, Any], Any], elems: Any) -> Any:
    """Inclusive prefix of ``combine`` over axis 1 of every leaf of the tree
    ``elems`` (all leaves share that axis). ``combine(left, right)`` gets
    two trees of the same structure, ``left`` the earlier elements, and
    returns one; it must be associative."""
    leaves, treedef = tree_flatten(elems)
    n = leaves[0].shape[1]
    k = 1
    while k < n:
        left = tree_map(lambda x, k=k: x[:, :-k], elems)
        right = tree_map(lambda x, k=k: x[:, k:], elems)
        comb, _ = tree_flatten(combine(left, right))
        heads, _ = tree_flatten(elems)
        elems = tree_unflatten(treedef, [
            torch.cat([h[:, :k], c], dim=1) for h, c in zip(heads, comb)
        ])
        k *= 2
    return elems

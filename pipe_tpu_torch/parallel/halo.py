"""Halo exchange primitives, on the mesh bound by ``mesh_scope``.

The counterpart of :mod:`pipe_tpu.parallel.halo`. When a chunk is sharded
over the time axis, each rank's stateful ops need the trailing ``halo``
samples of the previous time-block, which live on the left neighbour: every
rank sends its tail one step right inside its time row, and the first rank
takes the carry of the previous chunk instead. All of a row's ranks call
each function together, with tensors of the same shape; none of them sits in
a branch that depends on the rank.
"""

from __future__ import annotations

import torch

from pipe_tpu_torch.parallel.meshctx import require_mesh
from pipe_tpu_torch.tree import tree_flatten, tree_unflatten


def halo_from_left(x_local, halo: int, axis_name: str, carried):
    """The ``halo`` samples preceding this rank's time-block.

    ``x_local``: ``(C, N_local)``; ``carried``: ``(C, halo)`` stream state
    of the previous chunk, used by the first rank of the row. The receive is
    ordered before the caller's next use (see ``Mesh.shift_right``)."""
    if halo <= 0:
        return x_local[:, :0]
    mesh = require_mesh()
    if mesh.axis_size(axis_name) == 1:
        return carried
    left = mesh.shift_right(x_local[:, -halo:], axis_name, 1)
    return carried if mesh.axis_index(axis_name) == 0 else left


def last_shard(value, axis_name: str):
    """The LAST rank's ``value`` on every rank of the axis: how a chunk's
    final stream state becomes the next chunk's carry. One broadcast from
    the row's last rank."""
    mesh = require_mesh()
    n = mesh.axis_size(axis_name)
    if n == 1:
        # a carry of its own, not a view that keeps the whole chunk alive
        return value.clone()
    return mesh.broadcast(value, axis_name, n - 1)


# one broadcast serves both of the JAX package's variants (an all_gather
# for small values, a masked psum for large ones)
broadcast_last = last_shard


def psum(value, axis_name: str):
    """The sum of ``value`` over the axis (``lax.psum``), by ``all_reduce``:
    the order of the sum is the backend's, so results across mesh shapes
    agree to rounding, not to the bit."""
    return require_mesh().all_reduce(value, axis_name)


def _pack(tree):
    leaves, treedef = tree_flatten(tree)
    flat = torch.cat([l.reshape(-1) for l in leaves])
    return flat, treedef, [l.shape for l in leaves]


def _unpack(flat, treedef, shapes):
    leaves, pos = [], 0
    for shape in shapes:
        n = 1
        for d in shape:
            n *= d
        leaves.append(flat[pos:pos + n].reshape(shape))
        pos += n
    return tree_unflatten(treedef, leaves)


def _shift_tree(mesh, tree, axis_name, hops):
    """``shift_right`` of a whole tree as one packed message."""
    flat, treedef, shapes = _pack(tree)
    return _unpack(mesh.shift_right(flat, axis_name, hops), treedef, shapes)


def exclusive_prefix_ladder(axis_name: str, combine, unit, value):
    """Exclusive prefix-combine by a Hillis-Steele ladder of shifts:
    ``ceil(log2(T))`` rounds that move one value-tree each, instead of the
    all_gather's T copies: for LARGE per-rank values.

    ``combine(left, right)`` must be associative with identity ``unit``."""
    mesh = require_mesh()
    n = mesh.axis_size(axis_name)
    idx = mesh.axis_index(axis_name)
    if n == 1:
        return unit
    # seed: acc_d = v_{d-1} (unit at d=0); the inclusive ladder over the
    # seed yields the exclusive prefix
    shifted = _shift_tree(mesh, value, axis_name, 1)
    acc = unit if idx == 0 else shifted
    k = 1
    while k < n:
        recv = _shift_tree(mesh, acc, axis_name, k)
        if idx >= k:
            acc = combine(recv, acc)
        k *= 2
    return acc


def exclusive_prefix(axis_name: str, combine, unit, value):
    """Exclusive prefix-combine of per-rank values over a mesh axis: rank d
    gets ``combine(v_0, ..., v_{d-1})`` (``unit`` for d=0), folded from the
    left in rank order like the JAX package's loop.

    For the small totals of the sharded recurrences (2x2 matrices per
    channel): the whole tree travels as one packed ``all_gather`` and each
    rank folds locally."""
    mesh = require_mesh()
    idx = mesh.axis_index(axis_name)
    if mesh.axis_size(axis_name) == 1:
        return unit
    flat, treedef, shapes = _pack(value)
    gathered = mesh.all_gather(flat, axis_name)  # (D, total)
    acc = unit
    for d in range(idx):
        acc = combine(acc, _unpack(gathered[d], treedef, shapes))
    return acc


__all__ = [
    "halo_from_left", "last_shard", "broadcast_last", "psum",
    "exclusive_prefix", "exclusive_prefix_ladder",
]

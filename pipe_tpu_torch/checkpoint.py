"""Checkpoint / resume — snapshot and restore live stream state.

The PyTorch counterpart of :mod:`pipe_tpu.checkpoint`, with the same file
format, so a checkpoint written by either package restores into the other
(a pipe built from the same lines):

    ckpt = pipe_tpu_torch.checkpoint.snapshot(p)   # p not running
    ckpt.save("stream.ckpt.npz")
    ...
    ckpt = pipe_tpu_torch.checkpoint.load("stream.ckpt.npz")
    pipe_tpu_torch.checkpoint.restore(p2, ckpt)    # structurally identical
    p2.start()                                      # resumes mid-stream

Leaves are stored as a flat npz keyed ``r{route}/c{component}/{kind}/{i}``
with ``i`` the leaf index in :func:`pipe_tpu_torch.tree.tree_flatten` order
(the order of ``jax.tree.flatten``: dict entries by sorted key). A host-int
leaf (a stream counter such as the resampler's phase offset) is stored as a
0-d int32 array, the JAX package's dtype, and restored as an int.
``restore`` unflattens against the target pipe's own trees and is
all-or-nothing.

A mesh pipe's snapshot holds GLOBAL arrays, as the JAX package's does: on a
mesh larger than 1x1 a component that declares ``state_spec`` /
``param_spec`` is gathered (a collective: every rank calls ``snapshot`` at
the same point, after ``wait``) and ``restore`` keeps each rank's block. So
a snapshot taken on a 2x4 mesh restores on 1x1 and in the JAX package, where
the global shapes agree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from pipe_tpu_torch.convert import (
    component_tree_from_numpy,
    component_tree_to_numpy,
)
from pipe_tpu_torch.tree import tree_flatten, tree_unflatten


@dataclasses.dataclass
class Checkpoint:
    """Flat leaf store: ``leaves[key] = np.ndarray``. Keys encode route,
    component, and kind (state/params) plus the leaf index in tree order."""

    leaves: Dict[str, np.ndarray]
    block_size: int

    def save(self, path: str) -> None:
        np.savez_compressed(
            path, __block_size__=np.asarray(self.block_size), **self.leaves
        )


def load(path: str) -> Checkpoint:
    with np.load(path) as z:
        leaves = {k: z[k] for k in z.files if k != "__block_size__"}
        block_size = int(z["__block_size__"])
    return Checkpoint(leaves=leaves, block_size=block_size)


def _iter_components(pipe):
    for r, route in enumerate(pipe.routes):
        for c, comp in enumerate(route.components()):
            yield r, c, route, comp


def snapshot(pipe) -> Checkpoint:
    """Capture every component's state and params as host numpy (global
    arrays on a mesh). Call while the pipe is not running (before ``start``
    or after ``wait``): mid-flight state is owned by the executor threads,
    and on a mesh the gather must not cross a sweep's collectives."""
    if getattr(pipe, "_running", False):
        raise RuntimeError("snapshot requires a stopped pipe")
    leaves: Dict[str, np.ndarray] = {}
    for r, c, route, comp in _iter_components(pipe):
        for kind in ("state", "params"):
            flat, _ = tree_flatten(
                component_tree_to_numpy(pipe, route, comp, kind))
            for i, leaf in enumerate(flat):
                leaves[f"r{r}/c{c}/{kind}/{i}"] = np.asarray(leaf)
    return Checkpoint(leaves=leaves, block_size=pipe.block_size)


def restore(pipe, ckpt: Checkpoint) -> None:
    """Write a checkpoint's leaves back into a structurally identical pipe.
    Raises ``ValueError`` on any structural mismatch (missing or extra
    leaves, shape or block-size disagreement) rather than partially
    restoring."""
    if getattr(pipe, "_running", False):
        raise RuntimeError("restore requires a stopped pipe")
    if pipe.block_size != ckpt.block_size:
        raise ValueError(
            f"checkpoint block_size {ckpt.block_size} != pipe {pipe.block_size}"
        )

    # validate everything first: restore is all-or-nothing
    plan: List = []
    seen = set()
    for r, c, route, comp in _iter_components(pipe):
        for kind in ("state", "params"):
            flat, treedef = tree_flatten(getattr(comp, kind))
            stored = []
            for i in range(len(flat)):
                key = f"r{r}/c{c}/{kind}/{i}"
                if key not in ckpt.leaves:
                    raise ValueError(f"checkpoint missing leaf {key}")
                seen.add(key)
                stored.append(ckpt.leaves[key])
            plan.append((comp, kind, component_tree_from_numpy(
                pipe, route, comp, kind, tree_unflatten(treedef, stored),
                f"leaf r{r}/c{c}/{kind}")))
    extra = set(ckpt.leaves) - seen
    if extra:
        raise ValueError(f"checkpoint has extra leaves: {sorted(extra)[:5]}")

    for comp, kind, tree in plan:
        setattr(comp, kind, tree)


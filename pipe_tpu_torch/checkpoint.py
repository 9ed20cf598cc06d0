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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

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
            yield r, c, comp


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def snapshot(pipe) -> Checkpoint:
    """Capture every component's state and params as host numpy. Call
    while the pipe is not running (before ``start`` or after ``wait``):
    mid-flight state is owned by the executor threads."""
    if getattr(pipe, "_running", False):
        raise RuntimeError("snapshot requires a stopped pipe")
    leaves: Dict[str, np.ndarray] = {}
    for r, c, comp in _iter_components(pipe):
        for kind, tree in (("state", comp.state), ("params", comp.params)):
            flat, _ = tree_flatten(tree)
            for i, leaf in enumerate(flat):
                leaves[f"r{r}/c{c}/{kind}/{i}"] = _to_host(leaf)
    return Checkpoint(leaves=leaves, block_size=pipe.block_size)


def _restored(leaf, stored: np.ndarray):
    """``stored`` in the form of the pipe's ``leaf``: a tensor of its dtype
    on its device, or a host int."""
    if isinstance(leaf, torch.Tensor):
        return torch.tensor(stored, dtype=leaf.dtype, device=leaf.device)
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        return int(stored)
    return type(leaf)(stored) if np.ndim(stored) == 0 else stored


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
    for r, c, comp in _iter_components(pipe):
        for kind, tree in (("state", comp.state), ("params", comp.params)):
            flat, treedef = tree_flatten(tree)
            new_flat = []
            for i, leaf in enumerate(flat):
                key = f"r{r}/c{c}/{kind}/{i}"
                if key not in ckpt.leaves:
                    raise ValueError(f"checkpoint missing leaf {key}")
                seen.add(key)
                stored = ckpt.leaves[key]
                want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
                    else np.shape(leaf)
                if tuple(stored.shape) != tuple(want):
                    raise ValueError(
                        f"leaf {key}: checkpoint shape {stored.shape} != "
                        f"pipe shape {want}"
                    )
                new_flat.append(_restored(leaf, stored))
            plan.append((comp, kind, treedef, new_flat))
    extra = set(ckpt.leaves) - seen
    if extra:
        raise ValueError(f"checkpoint has extra leaves: {sorted(extra)[:5]}")

    for comp, kind, treedef, new_flat in plan:
        tree = tree_unflatten(treedef, new_flat)
        if kind == "state":
            comp.state = tree
        else:
            comp.params = tree

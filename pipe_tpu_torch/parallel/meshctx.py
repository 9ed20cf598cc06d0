"""Mesh scope: the mesh that the halo primitives and mesh-aware allocators
run on, bound per thread.

The counterpart of :mod:`pipe_tpu.parallel.meshctx`. ``ShardedChain.step``
binds its mesh here around the stages, so a stage's ``apply`` calls
``halo_from_left(x, halo, TIME_AXIS, carried)`` as the JAX package's does
inside ``shard_map``, with the axis name resolved against the bound mesh.
"""

from __future__ import annotations

import contextlib
import threading

_tls = threading.local()


@contextlib.contextmanager
def mesh_scope(mesh):
    """Bind ``mesh`` as the current mesh on this thread."""
    prev = getattr(_tls, "mesh", None)
    _tls.mesh = mesh
    try:
        yield mesh
    finally:
        _tls.mesh = prev


def current_mesh():
    """The mesh bound by the enclosing :func:`mesh_scope`, or None."""
    return getattr(_tls, "mesh", None)


def require_mesh():
    mesh = current_mesh()
    if mesh is None:
        raise RuntimeError(
            "this call requires a mesh: run it inside "
            "parallel.mesh_scope(parallel.make_mesh(...)), as "
            "ShardedChain.step does for its stages"
        )
    return mesh

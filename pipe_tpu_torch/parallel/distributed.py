"""The process group: one process per shard over ``torch.distributed``.

The counterpart of :mod:`pipe_tpu.parallel.distributed`. Every rank runs the
same program, as in the JAX package's multi-host mode; here that holds on
one host too, since a mesh of more than one shard is always one process per
shard. Nothing tells a program of its cluster: give :func:`initialize` the
coordinator's address, the world size and this process's rank.

Usage (same program in every process)::

    from pipe_tpu_torch import parallel
    parallel.initialize("localhost:29500", num_processes=4, process_id=rank,
                        transport="nccl")        # a no-op for one process
    mesh = parallel.make_global_mesh(channel_shards=1, time_shards=4)
    chain = parallel.ShardedChain(mesh, stages, channels=64, chunk_frames=...)
    y_local = chain.step(x)        # the global chunk in, this rank's block out
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

from pipe_tpu_torch.parallel import mesh as _mesh
from pipe_tpu_torch.parallel.mesh import CH_AXIS, TIME_AXIS, Mesh, make_mesh

_initialized = False


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    transport: Optional[str] = None,
) -> None:
    """Form the process group (idempotent; a no-op for one process: a 1x1
    mesh needs no group).

    ``transport`` names how tensors cross between ranks and with it the
    backend: ``"nccl"`` (tensors on the card, a card per rank), ``"gloo"``
    (tensors on the CPU) or ``"gloo+host"`` (tensors on a card that ranks
    share, staged through pinned host buffers over gloo). It must be given
    for more than one process: the library never picks it from where
    tensors happen to lie. Every group gets a short timeout, so a rank whose
    peers died raises instead of waiting forever.
    """
    global _initialized
    if _initialized:
        return
    if (num_processes is None and coordinator_address is None) or num_processes == 1:
        _initialized = True
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize needs coordinator_address, num_processes and "
            "process_id for more than one process")
    if transport not in _mesh.TRANSPORTS:
        raise ValueError(
            f"initialize needs transport= one of {_mesh.TRANSPORTS} for more "
            f"than one process, got {transport!r}")
    address = coordinator_address
    if "://" not in address:
        address = "tcp://" + address
    dist.init_process_group(
        backend="nccl" if transport == "nccl" else "gloo",
        init_method=address,
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=_mesh.GROUP_TIMEOUT_S),
    )
    _mesh._set_transport(transport)
    _initialized = True


def shutdown() -> None:
    """Leave the process group, so that :func:`initialize` can form another."""
    global _initialized
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _mesh._set_transport(None)
    _initialized = False


def make_global_mesh(channel_shards: int = 1, time_shards: int = 1) -> Mesh:
    """A ``(ch, time)`` mesh over the ranks of the whole process group."""
    n = channel_shards * time_shards
    total = _mesh.world_size()
    if total < n:
        raise ValueError(
            f"global mesh {channel_shards}x{time_shards} needs {n} devices, "
            f"cluster has {total}"
        )
    return make_mesh(channel_shards, time_shards)


class ShardedChunk:
    """This rank's block of a global ``(channels, chunk)`` array: what
    :func:`shard_host_chunk` returns and ``ShardedChain.step`` accepts in
    place of the global chunk."""

    def __init__(self, mesh: Mesh, local):
        self.mesh = mesh
        self.local = local
        c, n = local.shape
        self.shape = (c * mesh.shape[CH_AXIS], n * mesh.shape[TIME_AXIS])


def shard_host_chunk(mesh: Mesh, x_local) -> ShardedChunk:
    """Declare ``x_local`` (a host array or a tensor) as this rank's block of
    the channel x time grid of a global chunk. No data moves: where the JAX
    package assembles one global array, each rank of the port keeps its
    block."""
    if getattr(x_local, "ndim", 0) != 2:
        raise ValueError("shard_host_chunk takes a (channels, frames) block")
    if not isinstance(x_local, torch.Tensor):
        x_local = torch.as_tensor(x_local)
    return ShardedChunk(mesh, x_local)

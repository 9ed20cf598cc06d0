"""The ``(ch, time)`` mesh of ranks and the collectives on its axes.

The counterpart of :mod:`pipe_tpu.parallel.mesh`, for one process per shard
(see the package docstring). A :class:`Mesh` of shape ``(channel_shards,
time_shards)`` maps rank ``r`` to the position ``(r // time_shards, r %
time_shards)``: time last, so neighbouring ranks are neighbours in time and
exchange halos. A 1x1 mesh needs no process group. A larger one takes the
first ``channel_shards * time_shards`` ranks of the group that
:func:`pipe_tpu_torch.parallel.initialize` formed, and owns the two
sub-groups a rank needs: its time row and its channel column. Every rank of
the world calls :func:`make_mesh` with the same shape (``new_group`` is
itself a collective); a rank beyond the mesh gets a mesh whose ``member`` is
False and takes part in nothing further.

The collectives (:meth:`Mesh.all_gather`, :meth:`Mesh.all_reduce`,
:meth:`Mesh.broadcast`, :meth:`Mesh.shift_right`, :meth:`Mesh.all_to_all`)
run on one axis, inside the caller's row or column. How a tensor crosses is the mesh's *transport*,
named at ``initialize`` and never chosen by where a tensor happens to lie:

- ``"nccl"``: tensors on the card, NCCL (one card per rank);
- ``"gloo"``: tensors on the CPU, gloo;
- ``"gloo+host"``: tensors on the card, copied to pinned host buffers,
  moved by gloo and copied back, for ranks that share one card (NCCL
  refuses two ranks on one card). The compute stays on the card.

A tensor on the wrong side of the transport raises. Every call and its
payload bytes are counted on the host in :attr:`Mesh.stats`, and the host
time spent inside the calls (staging, the backend's call and the wait for
the slowest peer) in :attr:`Mesh.seconds`.
"""

from __future__ import annotations

import datetime
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

CH_AXIS = "ch"
TIME_AXIS = "time"

TRANSPORTS = ("nccl", "gloo", "gloo+host")
GROUP_TIMEOUT_S = 60.0  # a rank that waits longer than this raises

_transport: Optional[str] = None  # set by parallel.initialize
_meshes: Dict[tuple, "Mesh"] = {}  # (c, t) -> mesh: groups are made once


class P:
    """How an array is laid over the mesh, one entry per dimension: an axis
    name shards that dimension over the axis, ``None`` replicates it (the
    port's ``PartitionSpec``; trailing dimensions may be left out)."""

    def __init__(self, *axes):
        self.axes = axes

    def __repr__(self):
        return f"P{self.axes!r}"


def _set_transport(name: Optional[str]) -> None:
    global _transport
    if name is not None and name not in TRANSPORTS:
        raise ValueError(f"unknown transport {name!r}; expected one of {TRANSPORTS}")
    _transport = name
    _meshes.clear()


class Mesh:
    """A ``(ch, time)`` mesh as one rank sees it. Built by :func:`make_mesh`."""

    def __init__(self, channel_shards: int, time_shards: int, rank: int,
                 transport: Optional[str], groups: dict):
        self.shape = {CH_AXIS: channel_shards, TIME_AXIS: time_shards}
        self.size = channel_shards * time_shards
        self.rank = rank
        self.member = rank < self.size
        self.transport = transport  # None for a 1x1 mesh: nothing crosses
        self._index = {CH_AXIS: rank // time_shards, TIME_AXIS: rank % time_shards}
        self._groups = groups  # axis -> (process group, [global ranks])
        self.stats: Dict[str, List[int]] = {}  # collective -> [calls, bytes]
        self.seconds: Dict[str, float] = {}  # collective -> host time inside

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's position on ``axis``."""
        return self._index[axis]

    def local_block(self, arr, spec: P):
        """This rank's block of the global ``arr`` laid out by ``spec``."""
        for dim, axis in enumerate(spec.axes):
            if axis is None:
                continue
            n = self.shape[axis]
            if arr.shape[dim] % n:
                raise ValueError(
                    f"dimension {dim} of size {arr.shape[dim]} does not divide "
                    f"over the {axis!r} axis of size {n}")
            w = arr.shape[dim] // n
            i = self._index[axis]
            arr = arr[(slice(None),) * dim + (slice(i * w, (i + 1) * w),)]
        return arr

    # -- the collectives ---------------------------------------------------

    def _count(self, name: str, nbytes: int, started: float) -> None:
        s = self.stats.setdefault(name, [0, 0])
        s[0] += 1
        s[1] += nbytes
        self.seconds[name] = (self.seconds.get(name, 0.0)
                              + time.perf_counter() - started)

    def reset_stats(self) -> None:
        self.stats.clear()
        self.seconds.clear()

    def _check_side(self, x: torch.Tensor) -> None:
        """Raise unless ``x`` lies where the transport takes its tensors."""
        if self.transport == "gloo":
            if x.is_cuda:
                raise RuntimeError(
                    "the gloo transport moves CPU tensors, got a CUDA tensor: "
                    "initialize with transport='nccl' (a card per rank) or "
                    "'gloo+host' (ranks sharing a card)")
        elif not x.is_cuda:
            raise RuntimeError(
                f"the {self.transport} transport moves CUDA tensors, got a CPU tensor")

    def _stage_out(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as the contiguous tensor the backend moves: itself, or for
        ``gloo+host`` a pinned host copy that has arrived."""
        self._check_side(x)
        if self.transport != "gloo+host":
            return x.contiguous()
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x, non_blocking=True)
        torch.cuda.current_stream(x.device).synchronize()
        return h

    def _empty_like_staged(self, shape, like: torch.Tensor) -> torch.Tensor:
        """A receive buffer for a tensor like ``like`` (the caller's)."""
        if self.transport == "gloo+host":
            return torch.empty(shape, dtype=like.dtype, pin_memory=True)
        return torch.empty(shape, dtype=like.dtype, device=like.device)

    def _stage_in(self, h: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """A moved tensor back where ``like`` lies. The pinned buffer of a
        ``non_blocking`` copy is kept from reuse by torch's host allocator
        until the copy has run."""
        if self.transport == "gloo+host":
            return h.to(like.device, non_blocking=True)
        return h

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Every rank's ``x`` along ``axis``, stacked on a new dimension 0 in
        axis order."""
        n = self.shape[axis]
        if n == 1:
            return x[None]
        group, _ = self._groups[axis]
        started = time.perf_counter()
        src = self._stage_out(x)
        out = self._empty_like_staged((n,) + tuple(x.shape), x)
        # flat views: gloo takes the concatenated layout only
        dist.all_gather_into_tensor(out.view(-1), src.view(-1), group=group)
        self._count("all_gather", out.numel() * out.element_size(), started)
        return self._stage_in(out, x)

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of every rank's ``x`` along ``axis`` (the order of the
        sum is the backend's)."""
        if self.shape[axis] == 1:
            return x
        group, _ = self._groups[axis]
        started = time.perf_counter()
        buf = self._stage_out(x)
        if self.transport != "gloo+host":
            buf = buf.clone()  # the caller's tensor is not written
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        self._count("all_reduce", buf.numel() * buf.element_size(), started)
        return self._stage_in(buf, x)

    def broadcast(self, x: torch.Tensor, axis: str, src_index: int) -> torch.Tensor:
        """The ``x`` of the rank at position ``src_index`` of ``axis``, on
        every rank of the axis. All ranks pass an ``x`` of the same shape."""
        if self.shape[axis] == 1:
            return x
        group, ranks = self._groups[axis]
        started = time.perf_counter()
        if self._index[axis] != src_index:
            # overwritten by the source's value: nothing of x is moved
            self._check_side(x)
            buf = self._empty_like_staged(tuple(x.shape), x)
        else:
            buf = self._stage_out(x)
            if self.transport != "gloo+host":
                buf = buf.clone()  # the result is not the caller's tensor
        dist.broadcast(buf, src=ranks[src_index], group=group)
        self._count("broadcast", buf.numel() * buf.element_size(), started)
        return self._stage_in(buf, x)

    def shift_right(self, x: torch.Tensor, axis: str, hops: int = 1,
                    cyclic: bool = False) -> torch.Tensor:
        """Position ``i`` of ``axis`` receives the ``x`` of position
        ``i - hops``; the first ``hops`` positions receive zeros and the last
        ``hops`` send to nobody (``lax.ppermute`` with the pairs ``(i, i +
        hops)``). With ``cyclic`` the positions wrap: ``i`` receives from
        ``(i - hops) mod n`` and every rank sends and receives (the pairs
        ``(i, (i + hops) % n)``); a shift by a multiple of ``n`` is ``x``
        itself and no call. Returns after the receive has been ordered before
        the caller's next work on the tensor and the send is complete."""
        n = self.shape[axis]
        i = self._index[axis]
        if cyclic:
            hops %= n
            if hops == 0:
                return x
            dst, src = (i + hops) % n, (i - hops) % n
        else:
            if hops >= n:
                return torch.zeros_like(x)
            dst = i + hops if i + hops < n else None
            src = i - hops if i - hops >= 0 else None
        group, ranks = self._groups[axis]
        started = time.perf_counter()
        out = self._stage_out(x)  # also checks the tensor's side
        got = self._empty_like_staged(tuple(x.shape), x)
        ops = []
        # with two ranks the peer of the send is the peer of the receive:
        # a send only ever meets a receive, so the pair cannot cross-match
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, out, ranks[dst], group=group))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, got, ranks[src], group=group))
        for req in dist.batch_isend_irecv(ops) if ops else ():
            req.wait()
        self._count("send_recv", x.numel() * x.element_size() * len(ops), started)
        if src is None:
            return torch.zeros_like(x)
        return self._stage_in(got, x)

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The transpose over ``axis``: ``x`` has the axis size on dimension
        0, and position ``i`` gets slice ``i`` of every rank's ``x``, stacked
        on dimension 0 in axis order (``lax.all_to_all`` with ``tiled=False``
        once the caller has moved the split dimension to the front). Counted
        with the bytes a rank receives, its own slice included."""
        n = self.shape[axis]
        if x.shape[0] != n:
            raise ValueError(
                f"all_to_all over the {axis!r} axis of size {n} needs that "
                f"size on dimension 0, got {tuple(x.shape)}")
        if n == 1:
            return x
        group, _ = self._groups[axis]
        started = time.perf_counter()
        src = self._stage_out(x)
        out = self._empty_like_staged(tuple(x.shape), x)
        # NCCL and gloo both carry it; equal splits of dimension 0
        dist.all_to_all_single(out.view(n, -1), src.view(n, -1), group=group)
        self._count("all_to_all", out.numel() * out.element_size(), started)
        return self._stage_in(out, x)


def world_size() -> int:
    """Ranks of the process group, 1 where none was formed."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(channel_shards: int = 1, time_shards: int = 1, devices=None) -> Mesh:
    """Build a ``(ch, time)`` mesh over the first ``channel_shards *
    time_shards`` ranks. Where the JAX package counts devices of one
    process, this counts the ranks of the process group; ``devices`` is the
    JAX package's argument and must be left ``None``. Called by every rank
    of the world with the same shape."""
    if devices is not None:
        raise ValueError(
            "devices= has no counterpart: a mesh takes the first ranks of the "
            "process group, one process per shard")
    n = channel_shards * time_shards
    have = world_size()
    if have < n:
        raise ValueError(
            f"mesh {channel_shards}x{time_shards} needs {n} devices, "
            f"have {have}"
        )
    if n == 1:
        rank = dist.get_rank() if have > 1 else 0
        return Mesh(1, 1, rank, None, {})
    key = (channel_shards, time_shards)
    if key not in _meshes:
        if _transport is None:
            raise RuntimeError(
                "the process group was not formed by "
                "pipe_tpu_torch.parallel.initialize, which names the transport")
        rank = dist.get_rank()
        timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
        groups = {}
        # every rank creates every group, rows first, in one order
        for axis, lines in (
            (TIME_AXIS, [[c * time_shards + t for t in range(time_shards)]
                         for c in range(channel_shards)]),
            (CH_AXIS, [[c * time_shards + t for c in range(channel_shards)]
                       for t in range(time_shards)]),
        ):
            for ranks in lines:
                if len(ranks) == 1:
                    continue
                g = dist.new_group(ranks, timeout=timeout)
                if rank in ranks:
                    groups[axis] = (g, ranks)
        _meshes[key] = Mesh(channel_shards, time_shards, rank, _transport, groups)
    return _meshes[key]

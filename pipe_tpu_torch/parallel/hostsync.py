"""Cross-rank failure detection for mesh pipes: aligned health rounds.

The counterpart of :mod:`pipe_tpu.parallel.hostsync`. The port runs one
process per shard, so every mesh larger than 1x1 is what the JAX package
calls multi-process mode: a rank that simply stops taking part leaves its
peers waiting inside their next collective (until the group timeout,
``pipe_tpu_torch.parallel.mesh.GROUP_TIMEOUT_S``). The protocol keeps the
reference's first-error-wins semantics (``merger.go:33-41``,
``pipe.go:230-239``) across ranks with an aligned health exchange:

- the round coordinate is the executor's dispatch count
  (``blocks_dispatched``): a round is due whenever the frontier crosses a
  multiple of ``every``. Counting dispatches means a failure before or
  after a dispatch can never miscount the padding;
- every rank's executor thread calls :meth:`HostSync.check` at the same
  round frontiers;
- a rank that leaves the stream for any reason (component failure,
  ``stop()``, or EOF) first pads its collectives with no-op sweeps up to
  the next round frontier (the peers' blocks in flight complete instead of
  waiting), then joins that round one last time: flag=1 when aborting,
  flag=0 at EOF;
- rounds are collective barriers, so a rank still streaming cannot pass
  the flagger's round without seeing the flag: it raises
  :class:`PeerAbortError` there and issues no further round.

The exchange is an ``all_gather`` of two int32 on the host over a gloo
group of the mesh's ranks that carries nothing else
(:meth:`pipe_tpu_torch.parallel.mesh.Mesh.health_allgather`), whatever the
data transport: an NCCL round would queue on the stream, and reading it
back would synchronize the stream and stall the ``lookahead`` pipeline.

A failure inside a collective on the device (as against a host-side feed,
hook or sink error) cannot be padded over; the peers then raise at the
group timeout, as in the JAX package.
"""

from __future__ import annotations

import numpy as np


class PeerAbortError(RuntimeError):
    """Another rank of the mesh failed or stopped the pipe."""


class HostSync:
    """Aligned health rounds over ``mesh`` (see the module docstring).

    ``mesh`` is the :class:`~pipe_tpu_torch.parallel.mesh.Mesh` (or any
    object with its ``health_allgather``) whose ranks take part; ``every``
    is the dispatch period between rounds, the same on every rank."""

    def __init__(self, mesh, every: int = 16):
        self.mesh = mesh
        self.every = max(1, int(every))
        self._next_round = self.every

    @property
    def next_round(self) -> int:
        """The next round's dispatch frontier. The executor caps its
        dispatch batches here, so every rank's frontier lands exactly on
        the round coordinate and an exiting rank's padding matches its
        peers' dispatch counts block for block."""
        return self._next_round

    def due(self, frontier: int) -> bool:
        """True when the dispatch frontier has crossed the next round."""
        return frontier >= self._next_round

    def pad_target(self, frontier: int) -> int:
        """The frontier of the next aligned round: the dispatch index an
        exiting rank pads to with no-op sweeps."""
        if frontier >= self._next_round:
            return frontier  # exactly on (or past) a round boundary
        return self._next_round

    def check(self, flag: int = 0, pending: int = 0) -> int:
        """Join the mesh's health round contributing ``flag`` (0 = healthy
        or EOF, 1 = aborting). Raises :class:`PeerAbortError` when any
        other rank flagged. Called by every rank of the mesh at the same
        round frontier.

        ``pending`` carries the untargeted-push agreement: each rank
        contributes how many untargeted push batches it holds; the return
        value is the mesh's minimum, the number of batches every rank can
        now target at the same block."""
        self._next_round += self.every
        rows = self.mesh.health_allgather(
            np.asarray([flag, pending], np.int32))
        rows = np.asarray(rows).reshape(-1, 2)
        total = int(np.sum(rows[:, 0]))
        if total - int(flag) > 0:
            raise PeerAbortError(
                "a peer rank aborted the pipe (first-error-wins across the "
                "mesh)"
            )
        return int(np.min(rows[:, 1]))

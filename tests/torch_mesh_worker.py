"""A pool of ranks for the sharded tests of ``pipe_tpu_torch``: N identical
processes joined in one ``torch.distributed`` group over gloo, each serving
jobs from the test process until it is told to stop.

As a program it is one rank of the pool::

    python torch_mesh_worker.py <rank> <world> <group port> <pipe fd>

As a module it is the test side: :class:`Pool` starts the ranks once, sends
every rank the same job (a function of this file by name, with keyword
arguments), and collects one result per rank. Every job has a time limit;
when it passes, the pool is killed and :class:`PoolTimeout` is raised, so a
rank that hangs in a collective fails its test and never the whole suite.
The pool restarts at the next job.
"""

import os
import socket
import subprocess
import sys
import time
import traceback
from multiprocessing import Pipe
from multiprocessing.connection import Connection

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# jobs: run in every rank with the same arguments; return picklable values
# ---------------------------------------------------------------------------


def _build_stages(specs):
    from pipe_tpu_torch import parallel

    return [getattr(parallel, name)(*args, **kwargs)
            for name, args, kwargs in specs]


def chain_job(rank, mesh, stages, channels, chunk_frames, x, carries=None,
              retune=None, local_input=False):
    """Build a ``ShardedChain`` and stream ``x`` through it. ``retune``:
    ``(chunk index, stage index, key, value)`` replaces a parameter before
    that chunk. ``local_input`` feeds each rank its own block through
    ``shard_host_chunk``. Returns the gathered output, the global carries
    after the last chunk, the last step's collectives per stage and this
    rank's block of the carries."""
    import numpy as np

    from pipe_tpu_torch import parallel
    from pipe_tpu_torch.convert import (
        chain_carries_from_numpy,
        chain_carries_to_numpy,
        tree_to_numpy,
    )

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    chain = parallel.ShardedChain(m, _build_stages(stages), channels,
                                  chunk_frames)
    if carries is not None:
        chain_carries_from_numpy(chain, carries)
    outs = []
    for i in range(x.shape[1] // chunk_frames):
        if retune is not None and retune[0] == i:
            chain.stages[retune[1]].params[retune[2]] = retune[3]
        xc = x[:, i * chunk_frames:(i + 1) * chunk_frames]
        if local_input:
            ci, ti = m.axis_index(parallel.CH_AXIS), m.axis_index(parallel.TIME_AXIS)
            cl, nl = channels // m.shape[parallel.CH_AXIS], chunk_frames // m.shape[parallel.TIME_AXIS]
            xc = parallel.shard_host_chunk(
                m, xc[ci * cl:(ci + 1) * cl, ti * nl:(ti + 1) * nl])
        y_local = chain.step(xc)
        outs.append(chain.gather(y_local).numpy())
    return {
        "out": np.concatenate(outs, axis=1),
        "local_shape": tuple(y_local.shape),
        "carries": chain_carries_to_numpy(chain),
        "local_carries": tree_to_numpy(chain.carries),
        "comm": chain.last_comm,
        "out_channels": chain.out_channels,
        "out_frames": chain.out_frames,
        "position": (m.axis_index(parallel.CH_AXIS),
                     m.axis_index(parallel.TIME_AXIS)),
    }


def build_error_job(rank, mesh, stages, channels, chunk_frames):
    """Build a chain that must fail: returns ``(type name, message)``."""
    from pipe_tpu_torch import parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    try:
        parallel.ShardedChain(m, _build_stages(stages), channels, chunk_frames)
    except Exception as e:  # noqa: BLE001 - reported to the test
        return (type(e).__name__, [c.__name__ for c in type(e).__mro__], str(e))
    return ("no error", [], "")


def mesh_error_job(rank, mesh):
    from pipe_tpu_torch import parallel

    try:
        parallel.make_mesh(*mesh)
    except ValueError as e:
        return str(e)
    return "no error"


def prefix_job(rank, t, vals):
    """The two exclusive prefixes of 2x2 matrix products on a 1xt mesh:
    returns this rank's ``(gather, ladder)`` results."""
    import torch

    from pipe_tpu_torch import parallel
    from pipe_tpu_torch.parallel.halo import (
        exclusive_prefix,
        exclusive_prefix_ladder,
    )

    m = parallel.make_mesh(1, t)
    if not m.member:
        return None
    v = torch.tensor(vals[m.axis_index(parallel.TIME_AXIS)])

    def combine(a, b):
        return b @ a  # right-applied: order matters

    unit = torch.eye(2)
    with parallel.mesh_scope(m):
        g = exclusive_prefix(parallel.TIME_AXIS, combine, unit, v)
        l = exclusive_prefix_ladder(parallel.TIME_AXIS, combine, unit, v)
    return g.numpy(), l.numpy()


def halo_job(rank, t, x, carried, halo):
    """``halo_from_left``, ``last_shard`` and the channel ``psum`` on a
    (2, t) mesh: returns what this rank got."""
    import torch

    from pipe_tpu_torch import parallel
    from pipe_tpu_torch.parallel.halo import halo_from_left, last_shard, psum

    m = parallel.make_mesh(2, t)
    if not m.member:
        return None
    ci, ti = m.axis_index(parallel.CH_AXIS), m.axis_index(parallel.TIME_AXIS)
    n = x.shape[1] // t
    xl = torch.tensor(x[ci:ci + 1, ti * n:(ti + 1) * n])
    m.reset_stats()  # meshes are made once per shape and count on
    with parallel.mesh_scope(m):
        left = halo_from_left(xl, halo, parallel.TIME_AXIS,
                              torch.tensor(carried[ci:ci + 1]))
        last = last_shard(xl[:, -halo:], parallel.TIME_AXIS)
        total = psum(xl, parallel.CH_AXIS)
    return {"position": (ci, ti), "left": left.numpy(), "last": last.numpy(),
            "psum": total.numpy(), "stats": {k: list(v) for k, v in m.stats.items()}}


def hang_job(rank, seconds):
    """Rank 0 returns at once; the others sleep."""
    if rank:
        time.sleep(seconds)
    return rank


def die_job(rank):
    """Rank 1 dies while the others wait for it in a collective."""
    import torch

    from pipe_tpu_torch import parallel

    m = parallel.make_mesh(1, 2)
    if rank == 1:
        os._exit(7)
    if not m.member:
        return None
    return m.all_gather(torch.ones(1), parallel.TIME_AXIS).numpy()


JOBS = {f.__name__: f for f in (
    chain_job, build_error_job, mesh_error_job, prefix_job, halo_job,
    hang_job, die_job)}


# ---------------------------------------------------------------------------
# the rank process
# ---------------------------------------------------------------------------


def main(argv):
    rank, world, group_port, fd = (int(a) for a in argv[1:5])
    conn = Connection(fd)
    sys.path.insert(0, REPO)

    import torch

    torch.set_num_threads(1)

    import pipe_tpu_torch
    from pipe_tpu_torch import parallel

    pipe_tpu_torch.set_default_device("cpu")
    parallel.initialize(f"localhost:{group_port}", num_processes=world,
                        process_id=rank, transport="gloo")
    conn.send("ready")
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        if msg is None:
            break
        name, kwargs = msg
        try:
            result = ("ok", JOBS[name](rank, **kwargs))
        except BaseException as e:  # noqa: BLE001 - reported to the test
            result = ("error", (type(e).__name__, str(e), traceback.format_exc()))
        conn.send(result)
    os._exit(0)  # no group teardown: the peers may be gone already


# ---------------------------------------------------------------------------
# the test side
# ---------------------------------------------------------------------------


class PoolTimeout(AssertionError):
    """A job passed its time limit; the pool was killed."""


class JobError(AssertionError):
    """A rank raised; carries ``errors``: rank -> (type name, message)."""

    def __init__(self, errors):
        self.errors = errors
        rank, (name, msg, tb) = sorted(errors.items())[0]
        super().__init__(f"rank {rank} raised {name}: {msg}\n{tb}")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Pool:
    """``world`` ranks over gloo, started at the first job."""

    def __init__(self, world: int = 8, start_timeout: float = 120.0):
        self.world = world
        self.start_timeout = start_timeout
        self._procs = []
        self._conns = {}
        self.starts = 0

    def _start(self):
        group_port = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        for rank in range(self.world):
            mine, theirs = Pipe(duplex=True)
            self._procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(rank),
                 str(self.world), str(group_port), str(theirs.fileno())],
                env=env, cwd=REPO, pass_fds=[theirs.fileno()]))
            theirs.close()
            self._conns[rank] = mine
        self.starts += 1
        deadline = time.monotonic() + self.start_timeout
        try:
            for rank, conn in self._conns.items():
                if not conn.poll(max(0.0, deadline - time.monotonic())):
                    raise PoolTimeout(f"rank {rank} did not join the group")
                assert conn.recv() == "ready"
        except BaseException:
            self.kill()
            raise

    def kill(self):
        for p in self._procs:
            if p.poll() is None:
                p.kill()
        for p in self._procs:
            p.wait()
        for c in self._conns.values():
            c.close()
        self._procs, self._conns = [], {}

    def close(self):
        for c in self._conns.values():
            try:
                c.send(None)
            except OSError:
                pass
        deadline = time.monotonic() + 10
        for p in self._procs:
            try:
                p.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
        self.kill()

    def run(self, job: str, timeout: float = 60.0, **kwargs):
        """Run ``job(rank, **kwargs)`` in every rank; a list of results by
        rank. Raises :class:`JobError` if a rank raised and
        :class:`PoolTimeout` (after killing the pool) if a rank did not
        answer within ``timeout`` seconds or died."""
        if not self._procs:
            self._start()
        for conn in self._conns.values():
            conn.send((job, kwargs))
        deadline = time.monotonic() + timeout
        results, errors = [None] * self.world, {}
        for rank in range(self.world):
            conn = self._conns[rank]
            try:
                if not conn.poll(max(0.0, deadline - time.monotonic())):
                    raise EOFError
                status, value = conn.recv()
            except (EOFError, OSError):
                self.kill()
                raise PoolTimeout(
                    f"job {job!r}: rank {rank} gave no answer within "
                    f"{timeout} s; the pool was killed") from None
            if status == "ok":
                results[rank] = value
            else:
                errors[rank] = value
        if errors:
            raise JobError(errors)
        return results


if __name__ == "__main__":
    main(sys.argv)

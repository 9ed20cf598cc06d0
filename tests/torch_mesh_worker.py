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
    (2, t) mesh, then ``all_to_all``, the cyclic shifts and
    ``broadcast_last`` on its time axis: returns what this rank got, with
    the mesh's counts after each group."""
    import torch

    from pipe_tpu_torch import parallel
    from pipe_tpu_torch.parallel.halo import (
        broadcast_last,
        halo_from_left,
        last_shard,
        psum,
    )

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
    out = {"position": (ci, ti), "left": left.numpy(), "last": last.numpy(),
           "psum": total.numpy(),
           "stats": {k: list(v) for k, v in m.stats.items()}}
    m.reset_stats()
    with parallel.mesh_scope(m):
        # this rank's block cut into t slices: slice j goes to position j
        out["all_to_all"] = m.all_to_all(
            xl.reshape(1, t, n // t).transpose(0, 1), parallel.TIME_AXIS).numpy()
        out["cyclic"] = {
            hops: m.shift_right(xl, parallel.TIME_AXIS, hops, cyclic=True).numpy()
            for hops in (1, t - 1, t, t + 1, 0)}
        out["broadcast_last"] = broadcast_last(xl, parallel.TIME_AXIS).numpy()
    out["stats2"] = {k: list(v) for k, v in m.stats.items()}
    return out


# ---------------------------------------------------------------------------
# mesh Pipe jobs. A line is described by plain values, so the same
# description builds it from either package (``pkg`` is ``pipe_tpu`` in the
# test process and ``pipe_tpu_torch`` in the ranks):
#   {"source": (kind, *args), "ops": [(name, args, kwargs), ...],
#    "discard": bool}
# source kinds: ("feed", data, sample_rate), ("chunky", data, seed),
# ("packets", data, size), ("empty", data), ("mock", kwargs),
# ("failing", data, block index, failing rank or None)
# ---------------------------------------------------------------------------


def make_feed(kind, args, rank=0):
    """The host feed function of a source description."""
    import numpy as np

    data = args[0]
    N = data.shape[1]
    pos, call = [0], [0]
    if kind == "feed":
        def feed(n):
            if pos[0] >= N:
                return None
            c = data[:, pos[0]: pos[0] + n]
            pos[0] += n
            return c
    elif kind == "chunky":  # random-length short reads
        r = np.random.default_rng(args[1])

        def feed(n):
            if pos[0] >= N:
                return None
            take = min(int(r.integers(1, n + 1)), N - pos[0])
            c = data[:, pos[0]: pos[0] + take]
            pos[0] += take
            return c
    elif kind == "packets":  # fixed packets, whatever was asked for
        def feed(n):
            if pos[0] >= N:
                return None
            c = data[:, pos[0]: pos[0] + args[1]]
            pos[0] += c.shape[1]
            return c
    elif kind == "empty":  # every third read has nothing ready
        def feed(n):
            call[0] += 1
            if call[0] % 3 == 0:
                return np.zeros((data.shape[0], 0), np.float32)
            if pos[0] >= N:
                return None
            c = data[:, pos[0]: pos[0] + min(n, 300)]
            pos[0] += c.shape[1]
            return c
    elif kind == "failing":  # raises at a block on one rank (or on all)
        def feed(n):
            if pos[0] >= N:
                return None
            if pos[0] >= args[1] * n and args[2] in (None, rank):
                raise IOError(f"feed failed on rank {rank}")
            c = data[:, pos[0]: pos[0] + n]
            pos[0] += n
            return c
    else:
        raise ValueError(kind)
    return feed


def build_lines(pkg, lines, gate=None, context=None, rank=0):
    """Lines of ``pkg`` from their descriptions: ``(lines, ops, sinks,
    sources)`` with the op objects per line (for pushes) and the mock sinks
    and sources. ``gate``: an Event every source waits for before each
    dispatch (its ``host_pre``), so that targeted pushes are delivered
    before the stream reaches them."""
    from pkgutil import resolve_name

    mock = resolve_name(pkg.__name__ + ".mock")
    sharded = resolve_name(pkg.__name__ + ".parallel").sharded
    streaming = resolve_name(pkg.__name__ + ".ops")
    out_lines, all_ops, sinks, sources = [], [], [], []
    for d in lines:
        kind, *args = d["source"]
        if kind == "mock":
            msrc = mock.Source(**args[0])
            inner = msrc.source()
            sources.append(msrc)
        else:
            feed = make_feed(kind, args, rank)
            sr = args[1] if kind == "feed" and len(args) > 1 else 44100.0
            channels = args[0].shape[0]

            def inner(ctx, block, feed=feed, sr=sr, channels=channels):
                return pkg.Source(
                    output=pkg.SignalProperties(sr, channels), feed=feed)
            sources.append(None)

        def src_alloc(ctx, block, inner=inner):
            comp = inner(ctx, block)
            if gate is not None:
                pre = comp.host_pre

                def host_pre():
                    gate.wait(60)
                    if pre is not None:
                        pre()
                comp.host_pre = host_pre
            return comp

        ops = []
        for name, a, k in d.get("ops", []):
            if name == "FIRCascade":  # args: the member taps
                ops.append(sharded.FIRCascade([sharded.FIR(t) for t in a[0]]))
            elif name == "BiquadCascade":  # args: the rows; kwargs per row
                ops.append(sharded.BiquadCascade(
                    [sharded.Biquad(r, **k) for r in a[0]]))
            else:
                mod = streaming if name.startswith("ops.") else sharded
                ops.append(getattr(mod, name.split(".")[-1])(*a, **k))
        sink = mock.Sink(discard=d.get("discard", False))
        kw = {} if context is None else {"context": context}
        out_lines.append(pkg.Line(source=src_alloc,
                                  processors=[o.processor() for o in ops],
                                  sink=sink.sink(), **kw))
        all_ops.append(ops)
        sinks.append(sink)
    return out_lines, all_ops, sinks, sources


def drive_pipe(pkg, make_mesh, mesh, block, lines, pushes=(), knobs=None,
               entry="pipe", shared_context=False, restore=None,
               trees_in=None, snapshot=False, trees_out=False, rank=0,
               late_rank=None, wait_s=60.0, stats=False, fuse=False,
               noop=0):
    """Build the lines on ``make_mesh(*mesh)``, stream them to the end and
    report. ``pushes``: ``(line, op index, method, args, kwargs, at_block)``,
    pushed after ``start`` and delivered before the sources produce
    anything (the gate), except on ``late_rank``, which pushes once the
    stream is past the target."""
    import threading
    import time
    from pkgutil import resolve_name

    import numpy as np

    m = make_mesh(*mesh)
    if hasattr(m, "member") and not m.member:
        return None
    knobs = dict(knobs or {})
    gate = threading.Event() if pushes else None
    context = pkg.mutable.mutable() if shared_context else None
    built, ops, sinks, sources = build_lines(pkg, lines, gate, context, rank)
    if fuse:
        optimize = resolve_name(pkg.__name__ + ".optimize")
        built = [optimize.fuse(line) for line in built]
    res = {"error": None}
    if stats:
        knobs["stats"] = resolve_name(pkg.__name__ + ".profiling").StatsRecorder()
    if entry == "run":
        pkg.run(block, *built, mesh=m, **knobs)
        res["out"] = [s.values for s in sinks]
        return res
    p = pkg.Pipe(block, *built, mesh=m, **knobs)
    res["agg"] = p._agg
    res["n_procs"] = [len(r.processors) for r in p.routes]
    res["out_capacity"] = [[q.out_capacity for q in r.processors]
                           for r in p.routes]
    res["out_props"] = [[(q.output.sample_rate, q.output.channels)
                         for q in r.processors] for r in p.routes]
    checkpoint = resolve_name(pkg.__name__ + ".checkpoint")
    if restore is not None:
        checkpoint.restore(p, checkpoint.Checkpoint(
            leaves=restore, block_size=block))
    if trees_in is not None:
        resolve_name(pkg.__name__ + ".convert").pipe_trees_from_numpy(p, trees_in)
    if hasattr(m, "reset_stats"):
        m.reset_stats()
    p.start()
    try:
        if rank == late_rank:
            gate.set()
            target = max(pu[5] for pu in pushes)
            deadline = time.monotonic() + 30
            while (p.block_index() <= target
                   and time.monotonic() < deadline):
                time.sleep(0.002)
        for li, oi, method, a, k, at in pushes:
            op = ops[li][oi]
            if method.startswith("set_part_"):  # the part by its index
                a = (op._parts[a[0]],) + tuple(a[1:])
            p.push(getattr(op, method)(*a, **k), at_block=at)
        if pushes and rank != late_rank:
            dest = p._executors[0].dest
            deadline = time.monotonic() + 30
            while len(dest.pending_targets()) < len(pushes):
                assert time.monotonic() < deadline, "pushes never delivered"
                time.sleep(0.002)
            gate.set()
        p.wait(wait_s)
    except Exception as e:  # noqa: BLE001 - reported to the test
        if gate is not None:
            gate.set()
        cause = e.__cause__
        res["error"] = (type(e).__name__, str(e),
                        type(cause).__name__ if cause is not None else None)
        try:
            p.wait(wait_s)
        except Exception:  # noqa: BLE001
            pass
    res["out"] = [s.values for s in sinks]
    res["messages"] = [s.messages for s in sinks]
    res["src"] = [None if s is None else (s.messages, s.samples)
                  for s in sources]
    res["blocks"] = p.block_index()
    if stats:
        ls = knobs["stats"].lines["line0"]
        res["stats"] = (ls.blocks, ls.frames, ls.wall_s)
    if noop and res["error"] is None:
        convert = resolve_name(pkg.__name__ + ".convert")
        le = p._exec_of_route[0]
        before = convert.tree_to_numpy([c.state for c in p.routes[0].components()])
        n0 = le.blocks_dispatched
        p._executors[0].dispatch_noop_to(n0 + noop)
        after = convert.tree_to_numpy([c.state for c in p.routes[0].components()])
        res["noop"] = (le.blocks_dispatched - n0, before, after,
                       sinks[0].values.shape)
    if hasattr(m, "stats"):
        res["comm"] = {k: list(v) for k, v in m.stats.items()}
    if snapshot and res["error"] is None:
        res["ckpt"] = checkpoint.snapshot(p).leaves
    if trees_out and res["error"] is None:
        res["trees"] = resolve_name(
            pkg.__name__ + ".convert").pipe_trees_to_numpy(p)
    return res


def pipe_job(rank, **kwargs):
    """:func:`drive_pipe` with the port on this rank."""
    import pipe_tpu_torch
    from pipe_tpu_torch import parallel

    return drive_pipe(pipe_tpu_torch, parallel.make_mesh, rank=rank, **kwargs)


def pipe_refusals_job(rank, mesh):
    """What a mesh Pipe refuses on purpose: ``{what: (type, message)}``;
    every surgery and push here is made on every rank alike."""
    import numpy as np

    import pipe_tpu_torch as pt
    from pipe_tpu_torch import mock, parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    sh = parallel.sharded
    out = {}

    def line(**kw):
        return pt.Line(source=mock.Source(channels=2, value=1.0,
                                          limit=8 * 1024).source(),
                       processors=[g.processor()], sink=mock.Sink().sink(), **kw)

    def attempt(what, fn):
        try:
            fn()
            out[what] = ("no error", "")
        except Exception as e:  # noqa: BLE001 - reported to the test
            out[what] = (type(e).__name__, str(e))

    g = sh.Gain(2.0)
    attempt("two executors", lambda: pt.Pipe(1024, line(), line(), mesh=m))
    ctx = pt.mutable.mutable()
    attempt("one group", lambda: pt.Pipe(
        1024, line(context=ctx), line(context=ctx), mesh=m))
    gate = __import__("threading").Event()
    inner = mock.Source(channels=2, value=1.0, limit=4 * 1024).source()

    def gated(ctx, b):
        comp = inner(ctx, b)
        comp.host_pre = lambda: gate.wait(60)
        return comp

    p = pt.Pipe(1024, pt.Line(source=gated, processors=[g.processor()],
                              sink=mock.Sink().sink()), mesh=m)
    p.start()
    attempt("insert_processor", lambda: p.insert_processor(
        0, 0, sh.Gain(1.0).processor()))
    attempt("add_line", lambda: p.add_line(line()))
    attempt("mixed batch", lambda: p.push(g.set_gain(3.0),
                                          p.mctx.mutate(lambda: None)))
    h = p.add_line(line(), at_block=2)  # a line of its own: no group to join
    h.wait(30)
    out["add_line outside the group"] = (type(h.error).__name__, str(h.error))
    gate.set()
    p.wait(60)
    return out


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
    pipe_job, pipe_refusals_job, hang_job, die_job)}


def _job(name):
    """A job of this file by name, or of another module of the repo as
    ``"package.module:function"``."""
    if ":" not in name:
        return JOBS[name]
    import importlib

    module, func = name.split(":")
    return getattr(importlib.import_module(module), func)


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
            result = ("ok", _job(name)(rank, **kwargs))
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

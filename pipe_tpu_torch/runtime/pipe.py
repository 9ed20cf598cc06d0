"""The Pipe — async lifecycle, mutation push, live graph surgery.

The PyTorch counterpart of :mod:`pipe_tpu.runtime.pipe`, mapping the
reference's goroutine topology (``pipe.go:105-365``) onto host threads
around eager block sweeps:

- every *async* line gets one executor thread, named
  ``pipe-exec-line{i}`` after its route index (the kernel launch counts
  per thread, :func:`pipe_tpu_torch.kernels.launch_counts`, read per line);
- *sync* lines sharing a mutable context are round-robined by one
  :class:`MultiLineExecutor` thread (``pipe.go:152-170``);
- a control thread owns the runtime registry and routes pushed mutations,
  applying pipe-context mutations itself (``pipe.go:216-241``);
- an error merger keeps the first error and cancels everything else
  (``merger.go:8-58``), with flush guaranteed for every started component.

Live surgery keeps the reference's guarantee — applied at a block boundary,
no sample lost — via a two-phase handoff: allocate in the control thread,
then deliver an adoption mutation to the owning executor thread, which
splices the component in between blocks (``pipe.go:259-365``,
``run.go:134-169``).

``optimize=True`` fuses every line at build
(:func:`pipe_tpu_torch.optimize.fuse`).

``mesh=`` (:func:`pipe_tpu_torch.parallel.make_mesh`) shards every line
over a mesh of ranks, one process per shard: every rank builds the same
``Pipe`` from lines of :mod:`pipe_tpu_torch.parallel.sharded` ops, is fed
the same stream and calls the same methods; ``block_size`` is the GLOBAL
block, and each rank's sink receives the whole output. A block size that
the mesh or a stage's shape rule does not fit is aggregated
(``_agg`` user blocks per dispatch; ``at_block`` stays in user blocks and
must lie on that grid). On a 1x1 mesh everything works as without one. A
larger mesh is the JAX package's multi-process mode: the ranks stay aligned
only because they take the same decisions from the same stream, and every
``host_sync_every`` dispatches they meet in a health round
(:mod:`pipe_tpu_torch.parallel.hostsync`), so:

- all lines run in ONE executor (a shared mutable context);
- a targeted push is strict: a late or never-reached target raises
  ``LateTargetError`` on the rank that saw it. An untargeted component
  push waits for a health round at which every rank holds it, and lands
  at the round after that, on the same block everywhere;
- ``insert_processor`` and ``add_line`` need ``at_block`` (the same on
  every rank), and an added line must join the existing sync group;
- a rank that fails, is stopped or pushes late pads its collectives with
  no-op sweeps to the next round and flags it there: its peers raise
  ``RunError`` from ``PeerAbortError`` at that round. At the end of the
  stream every rank pads to the next round and joins it once more, so a
  peer that failed inside the last window is still heard. A failure inside
  a collective on the device cannot be padded; the peers then raise at the
  group timeout (``pipe_tpu_torch.parallel.mesh.GROUP_TIMEOUT_S``, 60 s).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

import torch

from pipe_tpu_torch import mutable
from pipe_tpu_torch.errors import (
    FlushError,
    RunError,
    ShapeConstraintError,
    StartError,
)
from pipe_tpu_torch.graph import (
    Line,
    Route,
    allocate_processor,
    allocate_sink,
    component_context,
    make_route,
    make_routes_aggregated,
)
from pipe_tpu_torch.parallel.meshctx import mesh_scope
from pipe_tpu_torch.runtime.executor import (
    EOF,
    LineExecutor,
    MultiLineExecutor,
)


class _Merger:
    """First-error-wins fan-in (``merger.go:8-58``): extra errors are
    dropped, the first one cancels the run."""

    def __init__(self, cancel: threading.Event):
        self._lock = threading.Lock()
        self._cancel = cancel
        self.first_error: Optional[BaseException] = None
        self.threads: List[threading.Thread] = []

    def report(self, err: BaseException) -> None:
        with self._lock:
            if self.first_error is None:
                self.first_error = err
        self._cancel.set()

    def add(self, target, name: str) -> None:
        t = threading.Thread(target=target, name=name, daemon=True)
        with self._lock:
            self.threads.append(t)
        t.start()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Join all executor threads; returns True when everything exited.
        Threads may be appended while joining (live AddLine), so loop. With
        a ``timeout`` the join is bounded by a deadline across all threads
        (False = something is still running)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                pending = [t for t in self.threads if t.is_alive()]
            if not pending:
                return True
            for t in pending:
                if deadline is None:
                    t.join()
                else:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return False
                    t.join(left)


class _Handle:
    """Completion handle for live surgery (the analog of the reference's
    done-channel, ``pipe.go:264,279``). ``error`` is set instead of the
    event if the operation failed (the reference silently swallows surgery
    errors, ``mutable/mutable.go:56-58``)."""

    def __init__(self):
        self._event = threading.Event()
        self.error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def _set(self):
        self._event.set()

    def _fail(self, err: BaseException):
        self.error = err
        self._event.set()


class Pipe:
    """A graph of bound lines (``pipe.go:14-30,105-126``).

    ``device`` is where the lines' streams live (default: the device each
    source declares, else ``pipe_tpu_torch.config.default_device()``: the
    card, unless the CPU was asked for with ``set_default_device("cpu")``);
    ``lookahead`` and ``batch_blocks`` are the executor's dispatch knobs
    (:class:`~pipe_tpu_torch.runtime.executor.LineExecutor`); ``stats`` an
    optional :class:`~pipe_tpu_torch.profiling.StatsRecorder`.
    ``mesh`` shards the lines over a mesh of ranks (module docstring);
    ``host_sync_every`` is the period, in dispatches, of the health rounds
    of a mesh larger than 1x1 (the same on every rank)."""

    def __init__(self, block_size: int, *lines: Line, stats=None,
                 lookahead: int = 1, batch_blocks: int = 1, mesh=None,
                 host_sync_every: int = 16, optimize: bool = False,
                 device=None):
        if not lines:
            raise ValueError("pipe without lines")
        if optimize:
            # run the fusion fixpoint on every line at build
            from pipe_tpu_torch import optimize as _optimize

            lines = tuple(_optimize.fuse(line) for line in lines)
        self.block_size = block_size
        self.device = device
        self.mesh = mesh
        self.host_sync_every = host_sync_every
        self.stats = stats
        self.lookahead = lookahead
        self.batch_blocks = batch_blocks
        self.mctx = mutable.mutable()  # the pipe's own control context
        self.pusher = mutable.Pusher()
        self.routes: List[Route] = []
        # sync groups keyed by shared line context; async executors by route
        self._groups: Dict[mutable.Context, MultiLineExecutor] = {}
        self._executors: List = []  # all top-level executors, launch order
        self._exec_of_route: Dict[int, LineExecutor] = {}
        # Block aggregation: a mesh pipe whose block size (or stage shape
        # rules) does not fit the mesh dispatches the smallest working
        # multiple of the user block per step. Coordinates stay in USER
        # blocks at the API (push at_block, block_index); internally
        # everything counts a-block dispatches.
        self._agg = 1
        with mesh_scope(mesh):
            if mesh is None:
                routes = [make_route(line, block_size, device)
                          for line in lines]
            else:
                routes, self._agg = make_routes_aggregated(
                    lines, block_size, mesh, device=device)
        for route in routes:
            self._register_route(route)
        if self._multi and len(self._executors) > 1:
            raise ValueError(
                "a multi-host pipe needs all its lines in ONE executor so "
                "every process issues cross-host collectives in the same "
                "order: build the lines with a shared mutable context "
                "(pipe_tpu_torch.mutable.mutable()) so they form a single "
                "sync group — the reference's sync-mode idiom "
                "(pipe.go:89-103)"
            )
        self._merger: Optional[_Merger] = None
        # untargeted pushes on a mesh larger than 1x1 awaiting agreement
        self._untargeted_q: list = []
        self._untargeted_lock = threading.Lock()
        self._untargeted_stale = 0
        self._cancel = threading.Event()
        self._mutations_q: "queue.Queue" = queue.Queue()
        self._control: Optional[threading.Thread] = None
        self._running = False

    @property
    def _multi(self) -> bool:
        """True on a mesh larger than 1x1: the JAX package's multi-process
        mode (every rank runs this pipe; collectives cross processes)."""
        return self.mesh is not None and self.mesh.size > 1

    @property
    def _block_internal(self) -> int:
        """Frames per dispatch: the user block times the aggregation
        factor (1 unless the mesh shape rules demanded aggregation)."""
        return self.block_size * self._agg

    def _to_internal_block(self, at_block: Optional[int], what: str):
        """Convert a USER block target to the internal dispatch grid."""
        if at_block is None or self._agg == 1:
            return at_block
        if at_block % self._agg:
            raise ValueError(
                f"{what} at_block={at_block} is not on this pipe's "
                f"dispatch grid: the mesh shape rules aggregate "
                f"{self._agg} user blocks per step, so block targets "
                f"must be multiples of {self._agg}"
            )
        return at_block // self._agg

    def _require_at_block(self, at_block: Optional[int]) -> None:
        if self._multi and at_block is None:
            raise ValueError(
                "surgery on a mesh larger than 1x1 needs at_block= (the same "
                "on every rank) so every rank adopts at the same block "
                "(collective alignment)")

    # -- registry (reference pipe.go:128-194) ------------------------------

    def _new_executor(self, route: Route) -> LineExecutor:
        idx = len(self.routes)
        self.routes.append(route)
        le = LineExecutor(route, self._block_internal,
                          stats=self._line_stats(idx, route),
                          lookahead=self.lookahead,
                          batch_blocks=self.batch_blocks, mesh=self.mesh)
        le.name = f"line{idx}"
        self._exec_of_route[idx] = le
        return le

    def _register_route(self, route: Route) -> LineExecutor:
        le = self._new_executor(route)
        if route.context.is_mutable():
            # sync: group lines sharing a context under one executor thread
            group = self._groups.get(route.context)
            if group is None:
                dest = mutable.new_destination()
                group = MultiLineExecutor(context=route.context, dest=dest)
                group.name = f"group{len(self._groups)}"
                self._groups[route.context] = group
                self._executors.append(group)
                self.pusher.add_destination(route.context, dest)
            le.group_dest = group.dest
            group.executors.append(le)
        else:
            # async: one executor (thread) for the whole line; every
            # component context routes to the line's destination
            # (pipe.go:172-184)
            dest = mutable.new_destination()
            le.dest = dest
            self._executors.append(le)
            for comp in route.components():
                self.pusher.add_destination(comp.context, dest)
        return le

    def _line_stats(self, idx: int, route: Route):
        if self.stats is None:
            return None
        return self.stats.line(f"line{idx}", self._block_internal,
                               route.source.output.channels)

    # -- lifecycle ----------------------------------------------------------

    def start(self, *initializers: mutable.Mutation) -> "Pipe":
        """Start all executors (``pipe.go:196-214``). Initializer mutations
        are delivered before the first block."""
        if self._running:
            raise RuntimeError("pipe already running")
        if self._merger is not None and not self._merger.join(0):
            # a timed-out wait() cancelled the run but its executor threads
            # are still winding down: a restart now would re-enter
            # start_hook on routes the old threads still step
            raise RuntimeError(
                "pipe still winding down after a timed-out wait(): executor "
                "threads from the previous run are alive — call wait() "
                "again (it re-joins them) before restarting"
            )
        if self._control is not None and self._control.is_alive():
            # retire the previous run's control thread: two must never
            # consume one mutation queue
            self._mutations_q.put(None)
            self._control.join()
        # drain stale sentinels (push() refuses while not running, so only
        # sentinels can be queued here)
        while True:
            try:
                self._mutations_q.get_nowait()
            except queue.Empty:
                break
        self._cancel = threading.Event()
        self._merger = _Merger(self._cancel)
        self._running = True

        # a restart is a new stream (the frontier rewinds to block 0 in
        # start_hook): targets the previous stream never reached must not
        # fire into this one
        self.pusher.clear_targeted()
        with self._untargeted_lock:
            self._untargeted_q.clear()
        self._untargeted_stale = 0
        if initializers:
            self.pusher.put(*initializers)
        self.pusher.push()

        for e in self._executors:
            self._launch(e)

        self._control = threading.Thread(
            target=self._control_loop, name="pipe-control", daemon=True
        )
        self._control.start()
        return self

    def _launch(self, executor) -> None:
        self._merger.add(lambda: self._run_executor(executor),
                         name=f"pipe-exec-{executor.name}")

    #: rounds an untargeted push may wait for its peers before the run
    #: fails loudly: a batch that some rank never matches means the ranks
    #: are not pushing the same batch sequence
    UNTARGETED_STALE_ROUNDS = 64

    def _health_round(self, sync) -> None:
        """One aligned round: health flags and the untargeted-push
        agreement. The mesh's minimum of pending batches is targeted at the
        round after this one, the same block on every rank."""
        with self._untargeted_lock:
            pending = len(self._untargeted_q)
        target = sync.next_round + sync.every  # read before check advances it
        k = sync.check(flag=0, pending=pending)  # raises PeerAbortError
        if k > 0:
            with self._untargeted_lock:
                batches, self._untargeted_q = (
                    self._untargeted_q[:k], self._untargeted_q[k:])
                pending = len(self._untargeted_q)
            for batch in batches:
                for m in batch:
                    self.pusher.put(m, at_block=target)
            self.pusher.push()
            self._untargeted_stale = 0
        if pending > 0:
            self._untargeted_stale += 1
            if self._untargeted_stale >= self.UNTARGETED_STALE_ROUNDS:
                raise RuntimeError(
                    f"{pending} untargeted push batch(es) waited "
                    f"{self._untargeted_stale} health rounds without a "
                    "matching push on every peer rank: the ranks are not "
                    "pushing the same batch sequence")
        else:
            self._untargeted_stale = 0

    def _run_executor(self, executor) -> None:
        """Per-executor thread body (``run.go:171-196``): start (no flush on
        start failure for async executors — the reference defers flush only
        after a successful start), execute until EOF/cancel/error, always
        flush, report the first error. On a mesh larger than 1x1 delivery
        is strict (a late target raises), the end of the stream audits the
        pushes it never delivered, and the loop runs the aligned health
        rounds (first-error-wins across the mesh,
        :mod:`pipe_tpu_torch.parallel.hostsync`)."""
        from pipe_tpu_torch.parallel.hostsync import HostSync, PeerAbortError

        sync = HostSync(self.mesh, self.host_sync_every) if self._multi else None
        lines = getattr(executor, "executors", [executor])
        for le in lines:
            le.cancel = self._cancel
        devices = {le.device for le in lines}
        if len(devices) == 1 and lines[0].device.type == "cuda":
            # the current card is a property of the thread: pinned buffers
            # and events made here belong to the lines' card
            torch.cuda.set_device(lines[0].device)

        def flag_peers():
            # Tell the peers to abort: pad this rank's collectives with
            # no-op sweeps up to the next round (a peer's block in flight
            # needs this rank's share of its collectives), then join that
            # round with flag=1. The target comes from blocks_dispatched,
            # the sweeps actually made. Best-effort: a lost peer must not
            # mask the original error.
            if sync is None:
                return
            try:
                executor.dispatch_noop_to(
                    sync.pad_target(executor.blocks_dispatched))
                sync.check(flag=1)
            except Exception:  # noqa: BLE001
                pass

        try:
            executor.start_hook()
        except Exception as e:  # noqa: BLE001
            if isinstance(e, StartError):
                self._merger.report(e)
            else:
                err = StartError(f"error starting: {e}")
                err.__cause__ = e
                self._merger.report(err)
            flag_peers()
            return

        err_exec: Optional[BaseException] = None
        eof_exit = False
        try:
            while not self._cancel.is_set():
                dest = executor.dest
                stop_before = None
                if dest is not None:
                    frontier = executor.blocks_dispatched
                    # strict on a mesh of several ranks: a late target is
                    # an error, not a rank-local late landing
                    ms = dest.take_due(frontier, strict=sync is not None)
                    if ms:
                        executor.apply_mutations(ms)
                    # cap the next dispatch at the nearest block-indexed
                    # mutation so it lands exactly there
                    stop_before = dest.next_target(frontier)
                if sync is not None:
                    # and at the next round, so that every rank's frontier
                    # lands exactly on the round coordinate
                    nr = sync.next_round
                    stop_before = nr if stop_before is None else min(stop_before, nr)
                if executor.execute(stop_before) is EOF:
                    eof_exit = True
                    if sync is not None and dest is not None:
                        self._audit_end_of_stream(executor, dest)
                    break
                if sync is not None and sync.due(executor.blocks_dispatched):
                    self._health_round(sync)  # raises PeerAbortError
        except PeerAbortError as e:
            # a clean stop() racing a peer's stop is not an error
            if not self._cancel.is_set():
                err_exec = RunError(f"error running: {e}")
                err_exec.__cause__ = e
            sync = None  # the flagger made its last round: no re-sync
        except Exception as e:  # noqa: BLE001
            err_exec = RunError(f"error running: {e}")
            err_exec.__cause__ = e

        if err_exec is not None:
            self._merger.report(err_exec)
            flag_peers()
        elif eof_exit:
            # one last aligned round, so that a peer that failed inside the
            # last window (after this stream ended) still has its padded
            # collectives completed and its flag heard
            if sync is not None:
                try:
                    executor.dispatch_noop_to(
                        sync.pad_target(executor.blocks_dispatched))
                    sync.check(flag=0)
                except PeerAbortError as e:
                    err = RunError(f"error running: {e}")
                    err.__cause__ = e
                    self._merger.report(err)
                except Exception:  # noqa: BLE001
                    pass
        else:
            flag_peers()  # cancelled (stop()): release the peers
        try:
            executor.flush_hook()
        except Exception as e:  # noqa: BLE001
            if isinstance(e, FlushError):
                self._merger.report(e)
            else:
                err = FlushError(f"error flushing: {e}")
                err.__cause__ = e
                self._merger.report(err)

    def _audit_end_of_stream(self, executor, dest) -> None:
        """At the end of a stream on a mesh larger than 1x1, a push the
        stream never delivered would vanish, on one rank only if its
        delivery raced the end: deterministic or fail, so it raises."""
        leftover = dest.pending_targets()
        if leftover:
            raise mutable.LateTargetError(
                f"targeted mutation(s) at block(s) {sorted(leftover)} "
                f"undelivered at end of stream (frontier "
                f"{executor.blocks_dispatched})")
        with self._untargeted_lock:
            pending = len(self._untargeted_q)
        if pending:
            raise RuntimeError(
                f"{pending} untargeted push batch(es) pending at end of "
                "stream: the batch may not have reached an agreement "
                "round (a health round at which every rank held it; one "
                "comes every host_sync_every dispatches) before the stream "
                "ended; push it earlier, or target it with at_block=")

    def _control_loop(self) -> None:
        """Apply pipe-context mutations, forward the rest
        (``pipe.go:216-241``)."""
        while True:
            try:
                item = self._mutations_q.get(timeout=0.05)
            except queue.Empty:
                if self._all_executors_done():
                    return
                continue
            if item is None:
                return
            ms, at_block = item
            for m in ms:
                if m.context == self.mctx:
                    try:
                        m.apply()
                    except Exception as e:  # noqa: BLE001
                        # the reference drops pipe-context mutation errors
                        # (mutable/mutable.go:56-58); here they join the
                        # error fan-in: first error wins, run cancelled
                        err = RunError(f"error applying pipe mutation: {e}")
                        err.__cause__ = e
                        self._merger.report(err)
                else:
                    try:
                        self.pusher.put(m, at_block=at_block)
                    except mutable.UnknownContextError as e:
                        self._merger.report(e)
                        continue
            self.pusher.push()

    def _all_executors_done(self) -> bool:
        m = self._merger
        if m is None:
            return True
        with m._lock:
            return all(not t.is_alive() for t in m.threads)

    def push(self, *mutations: mutable.Mutation,
             at_block: Optional[int] = None) -> None:
        """Queue mutations for delivery (``pipe.go:243-247``). They land at
        the owning executor's next dispatched block, in push order — the
        reference's next-buffer guarantee. ``at_block`` targets an exact
        stream block index instead: the executor applies them right before
        dispatching that block, splitting a ``batch_blocks`` dispatch at the
        boundary if needed (deterministic landing under any knobs). Every
        feed result is one dispatched block, so under short reads
        ``at_block=k`` is the k-th source-buffer boundary; on a mesh the
        executor re-chunks short reads into full blocks, so ``at_block=k``
        is always sample ``k * block_size``. A target already passed
        applies at the next block.

        A mesh larger than 1x1 is strict (deterministic or fail): every
        rank pushes the same targets; a target that arrives after its block
        was dispatched, or that the stream never reaches, raises
        ``mutable.LateTargetError`` and aborts the run on every rank. Push
        with headroom: target comfortably past ``block_index()`` plus
        ``lookahead * batch_blocks``. An untargeted component push there
        queues on the rank; at each health round the ranks exchange how
        many batches they hold, and the mesh's minimum is targeted at the
        round after, the same block on every rank (every rank must push the
        same batch sequence: a batch that some rank does not match within
        ``UNTARGETED_STALE_ROUNDS`` rounds, or that is still waiting when
        the stream ends, fails the run). A batch may not mix a pipe
        structure mutation with untargeted component mutations there."""
        if not self._running:
            raise RuntimeError("pipe isn't running")
        if (self._multi and at_block is None
                and any(m.context != self.mctx for m in mutations)):
            # structure mutations run in the control thread and carry
            # their own at_block rule (surgery); untargeted component
            # batches wait for the agreement of a health round
            if any(m.context == self.mctx for m in mutations):
                raise ValueError(
                    "a push on a mesh larger than 1x1 mixes a pipe structure "
                    "mutation with untargeted component mutations in one "
                    "batch: the structure mutation runs in the control "
                    "thread while the component batch waits for the ranks' "
                    "agreement, so their order would be undefined; push "
                    "them separately (or target the components with "
                    "at_block=)")
            with self._untargeted_lock:
                self._untargeted_q.append(list(mutations))
            return
        at_block = self._to_internal_block(at_block, "push")
        self._mutations_q.put((list(mutations), at_block))

    def block_index(self, line: int = 0) -> int:
        """The dispatch frontier of the line's owning executor — the
        coordinate system for ``push(..., at_block=N)``. For a line in a
        sync group this is the group frontier; for an async line its own
        counter. Blocks before this index are already on the device
        (possibly still in flight under ``lookahead``)."""
        route = self.routes[line]
        group = self._groups.get(route.context)
        internal = (group.blocks_dispatched if group is not None
                    else self._exec_of_route[line].blocks_dispatched)
        return internal * self._agg  # user-block coordinates

    def __enter__(self) -> "Pipe":
        """Context-manager sugar: ``with Pipe(...).start() as p:``; exiting
        stops a still-running pipe at a block boundary."""
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            # abort path: cancel and best-effort drain without masking exc
            try:
                self._cancel.set()
                self.wait(30.0)
            except Exception:  # noqa: BLE001
                pass
            return
        self.stop()

    def stop(self, timeout: Optional[float] = None) -> None:
        """Cooperatively cancel a running pipe (``pipe.go:198-199,
        230-239``): every executor exits at its next block boundary, flush
        hooks run for all started components, and the call returns without
        error (raising instead if a component failed first). No-op when not
        running."""
        if not self._running:
            return
        self._cancel.set()
        self.wait(timeout)

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until all executors finish; raise the first error
        (``pipe.go:249-257``). ``timeout`` bounds the whole wait; on expiry
        the run is cancelled (executors wind down at their next block
        boundary) and a ``RunError`` is raised, or the first component
        error if one was already reported. ``start()`` refuses until the
        wound-down threads have exited (call ``wait()`` again to re-join
        them)."""
        if not self._running:
            if self._merger is not None and not self._merger.join(timeout):
                raise RunError(
                    f"timeout after {timeout}s re-joining cancelled "
                    "executors (still winding down)"
                )
            return
        if not self._merger.join(timeout):
            self._cancel.set()
            self._running = False
            if self._merger.first_error is not None:
                raise self._merger.first_error
            raise RunError(
                f"timeout after {timeout}s waiting for executors "
                "(run cancelled; executors exit at their next block "
                "boundary)"
            )
        self._mutations_q.put(None)
        self._control.join(timeout)
        self._running = False
        if self._merger.first_error is not None:
            raise self._merger.first_error

    # -- live surgery (reference pipe.go:259-365) ---------------------------

    def add_line(self, line: Line, at_block: Optional[int] = None) -> _Handle:
        """Grow the graph while running (``pipe.go:259-295``). Returns a
        handle completed once the line is live. ``at_block`` pins the
        adoption to an exact block index of the owning sync group (only
        meaningful for a line joining a running group). On a mesh larger
        than 1x1 it is required, and the line must join the existing sync
        group (share its mutable context): every rank adds the same line at
        the same target, so its collectives start at the same block
        everywhere."""
        if not self._running:
            raise RuntimeError("pipe isn't running")
        self._require_at_block(at_block)
        handle = _Handle()
        at_block = self._to_internal_block(at_block, "add_line")
        join_rule = ValueError(
            "an add_line on a mesh larger than 1x1 must join the existing "
            "sync group (share its mutable context): a second executor "
            "would interleave the ranks' collectives nondeterministically")

        def mutation():
            try:
                with mesh_scope(self.mesh):
                    route = make_route(line, self._block_internal, self.device)
            except Exception as e:  # noqa: BLE001
                handle._fail(e)
                return

            if not route.context.is_mutable():
                if self._multi:
                    handle._fail(join_rule)
                    return
                le = self._register_route(route)
                self._launch(le)
                handle._set()
                return

            existing = self._groups.get(route.context)
            if existing is not None and not existing.executors:
                # every line of the group already ended and its thread is
                # exiting: nothing would adopt the line, so the line starts
                # a fresh group (with a fresh destination) instead
                del self._groups[route.context]
                self._executors.remove(existing)
                existing = None
            if existing is not None:
                # adopt into the running group at its next block boundary
                # (or exactly at ``at_block`` when targeted)
                le = self._new_executor(route)
                le.group_dest = existing.dest

                def adopt():
                    existing.adopt_line(le)
                    handle._set()

                self.pusher.put(route.context.mutate(adopt), at_block=at_block)
                return

            if self._multi:
                handle._fail(join_rule)
                return
            self._register_route(route)
            self._launch(self._groups[route.context])
            handle._set()

        self.push(self.mctx.mutate(mutation))
        return handle

    def insert_processor(self, line: int, pos: int, proc_alloc,
                         at_block: Optional[int] = None) -> _Handle:
        """Splice a processor into a running line at ``pos``
        (``pipe.go:297-365``). Allocation happens in the control thread; the
        owning executor adopts it at its next block boundary, so no sample
        is lost or duplicated. ``at_block`` pins the adoption to an exact
        stream block index: the new processor's first processed sample is
        exactly ``at_block * block_size`` under any lookahead/batch_blocks.
        It is required on a mesh larger than 1x1, where every rank must
        splice at the same block.

        Width-changing processors (any ``out_capacity`` different from the
        slot's input width) are accepted, as in the reference
        (``pipe.go:297-312``): the downstream allocators are re-run at the
        new width at adoption, carrying each component's live state and
        params forward where shapes match (filter tails and IIR states
        continue exactly; a leaf whose shape depends on the block width
        re-initializes — a one-block transient). On a mesh the rebuild keeps
        the dispatch grid: a new width that breaks a downstream stage's
        shape rule refuses through the handle (``ValueError``), and the
        stream runs on unchanged."""
        if not self._running:
            raise RuntimeError("pipe isn't running")
        self._require_at_block(at_block)
        handle = _Handle()
        at_block = self._to_internal_block(at_block, "insert_processor")

        def mutation():
            route = self.routes[line]
            le = self._exec_of_route[line]
            try:
                prev_props = route.prev_props(pos)
                width = route.prev_capacity(pos, self._block_internal)
                ctx = component_context(route.context)
                with mesh_scope(self.mesh):
                    proc = allocate_processor(proc_alloc, ctx, width,
                                              prev_props, route.device)
            except Exception as e:  # noqa: BLE001
                handle._fail(e)
                return

            def build_rebuilt():
                """Downstream rebuild for a width-changing insert, run at
                the adoption boundary (executor thread) against the live
                route: a second surgery queued behind an un-adopted first
                one would otherwise rebuild from a stale processor list. On
                a mesh it keeps the dispatch grid: re-aggregating under the
                stream would move the at_block grid."""
                w, pr = proc.out_capacity, proc.output
                try:
                    with mesh_scope(self.mesh):
                        new_after = []
                        for i in range(pos, len(route.processors)):
                            old = route.processors[i]
                            rp = allocate_processor(route.proc_allocs[i],
                                                    old.context, w, pr,
                                                    route.device)
                            pr = rp.output
                            if rp.out_capacity is not None:
                                w = rp.out_capacity
                            new_after.append(rp)
                        new_sink = allocate_sink(route.sink_alloc,
                                                 route.sink.context, w, pr,
                                                 route.device)
                except ShapeConstraintError as e:
                    raise ValueError(
                        "cannot live-insert this width-changing processor: "
                        f"the new {proc.out_capacity}-frame block width "
                        "violates a downstream stage's shape rule on this "
                        f"mesh ({e}); build a new pipe") from e
                return new_after, new_sink

            def adopt():
                # the processor was allocated against the slot's width and
                # properties at push time (pipe.go:314-333); if an earlier
                # surgery changed the slot since, splicing the stale
                # component would corrupt the stream — refuse cleanly
                if (route.prev_capacity(pos, self._block_internal) != width
                        or route.prev_props(pos) != prev_props):
                    handle._fail(ValueError(
                        "insert_processor raced an earlier surgery that "
                        "changed this slot's input width/properties "
                        "between allocation and adoption; wait for the "
                        "first handle, then re-issue the insert"
                    ))
                    return
                rebuilt = None
                if proc.out_capacity is not None and proc.out_capacity != width:
                    try:
                        rebuilt = build_rebuilt()
                    except Exception as e:  # noqa: BLE001
                        # refusal, not failure: the stream runs on unchanged
                        handle._fail(e)
                        return
                try:
                    if proc.start is not None:
                        proc.start()
                except Exception as e:  # noqa: BLE001
                    handle._fail(e)
                    raise
                try:
                    le.insert_processor(pos, proc, proc_alloc, rebuilt)
                except ValueError as e:
                    # the mesh route check refused the splice: the route is
                    # as it was and the stream runs on
                    handle._fail(e)
                    return
                handle._set()

            if route.context.is_mutable():
                # sync group: deliver to the group's destination
                self.pusher.put(route.context.mutate(adopt), at_block=at_block)
            else:
                # async line: register the new context, deliver to the line
                self.pusher.add_destination(ctx, le.dest)
                anchor = (route.processors[pos].context
                          if pos < len(route.processors)
                          else route.sink.context)
                self.pusher.put(anchor.mutate(adopt), at_block=at_block)

        self.push(self.mctx.mutate(mutation))
        return handle


def wait(pipe: Pipe, timeout: Optional[float] = None) -> None:
    """Module-level convenience mirroring ``pipe.Wait`` (``pipe.go:249-257``)."""
    pipe.wait(timeout)

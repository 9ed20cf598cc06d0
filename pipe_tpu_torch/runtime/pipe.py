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
must lie on that grid). On a 1x1 mesh everything works as without one. On a
larger mesh the ranks stay aligned only because they take the same
decisions from the same stream, so:

- all lines run in ONE executor (a shared mutable context);
- a component push needs ``at_block``; a late or never-reached target
  raises ``LateTargetError`` on the rank that saw it. An untargeted push
  raises ``NotImplementedError``: landing it on the same block on every
  rank takes the agreement round of ``hostsync``, which is not ported;
- ``insert_processor`` and ``add_line`` raise ``NotImplementedError`` on
  any pipe with a mesh (they need ``hostsync`` too); ``host_sync_every``
  is stored and has no effect;
- a rank that fails or is stopped alone leaves its peers waiting in their
  next collective until the group timeout
  (``pipe_tpu_torch.parallel.mesh.GROUP_TIMEOUT_S``, 60 s): they raise,
  they do not hang. ``hostsync`` will turn that into an aligned abort.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional

import torch

from pipe_tpu_torch import mutable
from pipe_tpu_torch.errors import FlushError, RunError, StartError
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
    ``mesh`` shards the lines over a mesh of ranks (module docstring).
    ``host_sync_every`` is the JAX package's period, in dispatches, of a
    mesh pipe's cross-host health round: it is stored and has no effect."""

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

    def _refuse_mesh_surgery(self, what: str) -> None:
        if self.mesh is not None:
            raise NotImplementedError(
                f"{what} on a pipe with a mesh needs "
                "pipe_tpu_torch.parallel.hostsync (every rank must adopt at "
                "the same block), which is not ported yet")

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

    def _run_executor(self, executor) -> None:
        """Per-executor thread body (``run.go:171-196``): start (no flush on
        start failure for async executors — the reference defers flush only
        after a successful start), execute until EOF/cancel/error, always
        flush, report the first error. On a mesh larger than 1x1 delivery
        is strict (a late target raises) and the end of the stream audits
        the targets it never reached."""
        strict = self._multi
        lines = getattr(executor, "executors", [executor])
        for le in lines:
            le.cancel = self._cancel
        devices = {le.device for le in lines}
        if len(devices) == 1 and lines[0].device.type == "cuda":
            # the current card is a property of the thread: pinned buffers
            # and events made here belong to the lines' card
            torch.cuda.set_device(lines[0].device)
        try:
            executor.start_hook()
        except Exception as e:  # noqa: BLE001
            if isinstance(e, StartError):
                self._merger.report(e)
            else:
                err = StartError(f"error starting: {e}")
                err.__cause__ = e
                self._merger.report(err)
            return

        try:
            while not self._cancel.is_set():
                dest = executor.dest
                stop_before = None
                if dest is not None:
                    frontier = executor.blocks_dispatched
                    # strict on a mesh of several ranks: a late target is
                    # an error, not a rank-local late landing
                    ms = dest.take_due(frontier, strict=strict)
                    if ms:
                        executor.apply_mutations(ms)
                    # cap the next dispatch at the nearest block-indexed
                    # mutation so it lands exactly there
                    stop_before = dest.next_target(frontier)
                if executor.execute(stop_before) is EOF:
                    if strict and dest is not None:
                        # end-of-stream audit: a targeted mutation that the
                        # stream never reached would otherwise vanish, on
                        # one rank only if its delivery raced the EOF
                        leftover = dest.pending_targets()
                        if leftover:
                            raise mutable.LateTargetError(
                                f"targeted mutation(s) at block(s) "
                                f"{sorted(leftover)} undelivered at end of "
                                f"stream (frontier "
                                f"{executor.blocks_dispatched})"
                            )
                    break
        except Exception as e:  # noqa: BLE001
            err = RunError(f"error running: {e}")
            err.__cause__ = e
            self._merger.report(err)
        try:
            executor.flush_hook()
        except Exception as e:  # noqa: BLE001
            if isinstance(e, FlushError):
                self._merger.report(e)
            else:
                err = FlushError(f"error flushing: {e}")
                err.__cause__ = e
                self._merger.report(err)

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
        ``mutable.LateTargetError`` and aborts the run. Push with headroom:
        target comfortably past ``block_index()`` plus ``lookahead *
        batch_blocks``. An untargeted component push there raises
        ``NotImplementedError`` (module docstring)."""
        if not self._running:
            raise RuntimeError("pipe isn't running")
        if (self._multi and at_block is None
                and any(m.context != self.mctx for m in mutations)):
            raise NotImplementedError(
                "an untargeted push on a mesh larger than 1x1 would land on "
                "different blocks on different ranks; the agreement round "
                "that aligns it is pipe_tpu_torch.parallel.hostsync, which "
                "is not ported yet: pass at_block= (the same on every rank)")
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
        meaningful for a line joining a running group)."""
        if not self._running:
            raise RuntimeError("pipe isn't running")
        self._refuse_mesh_surgery("add_line")
        handle = _Handle()

        def mutation():
            try:
                route = make_route(line, self.block_size, self.device)
            except Exception as e:  # noqa: BLE001
                handle._fail(e)
                return

            if not route.context.is_mutable():
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

        Width-changing processors (any ``out_capacity`` different from the
        slot's input width) are accepted, as in the reference
        (``pipe.go:297-312``): the downstream allocators are re-run at the
        new width at adoption, carrying each component's live state and
        params forward where shapes match (filter tails and IIR states
        continue exactly; a leaf whose shape depends on the block width
        re-initializes — a one-block transient)."""
        if not self._running:
            raise RuntimeError("pipe isn't running")
        self._refuse_mesh_surgery("insert_processor")
        handle = _Handle()

        def mutation():
            route = self.routes[line]
            le = self._exec_of_route[line]
            try:
                prev_props = route.prev_props(pos)
                width = route.prev_capacity(pos, self.block_size)
                ctx = component_context(route.context)
                proc = allocate_processor(proc_alloc, ctx, width, prev_props,
                                          route.device)
            except Exception as e:  # noqa: BLE001
                handle._fail(e)
                return

            def build_rebuilt():
                """Downstream rebuild for a width-changing insert, run at
                the adoption boundary (executor thread) against the live
                route: a second surgery queued behind an un-adopted first
                one would otherwise rebuild from a stale processor list."""
                w, pr = proc.out_capacity, proc.output
                new_after = []
                for i in range(pos, len(route.processors)):
                    old = route.processors[i]
                    rp = allocate_processor(route.proc_allocs[i], old.context,
                                            w, pr, route.device)
                    pr = rp.output
                    if rp.out_capacity is not None:
                        w = rp.out_capacity
                    new_after.append(rp)
                new_sink = allocate_sink(route.sink_alloc, route.sink.context,
                                         w, pr, route.device)
                return new_after, new_sink

            def adopt():
                # the processor was allocated against the slot's width and
                # properties at push time (pipe.go:314-333); if an earlier
                # surgery changed the slot since, splicing the stale
                # component would corrupt the stream — refuse cleanly
                if (route.prev_capacity(pos, self.block_size) != width
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
                le.insert_processor(pos, proc, proc_alloc, rebuilt)
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

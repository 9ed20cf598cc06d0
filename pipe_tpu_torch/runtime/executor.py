"""Executors — the per-block hot path.

The PyTorch counterpart of :mod:`pipe_tpu.runtime.executor`. Where the JAX
executor traces the whole ``Source -> Processors -> Sink`` sweep into one
jitted computation, this one calls the component steps eagerly, in order,
once per block (:meth:`LineExecutor._sweep`); the ops enqueue their work on
the device's current stream. Every line works on its device's default
stream, so lines in different threads serialize on the device and need no
cross-stream events.

Stream control stays on the host. ``Signal.frames`` is a host int, the
resampler's phase offset is a host int in its state, and EOF is a host bool
wherever the source knows it on the host (a host feed returning ``None``, a
device source returning a Python bool): such a block runs no processor and
commits no state. A device source may instead return ``eof`` as a 0-d bool
tensor on the card; then the block runs, its new states are gated with
``torch.where`` (the JAX ``_gate``) and the flag is resolved with the
block's output, so there is still no sync per block. A device source that
returns ``frames`` as a tensor costs one sync per block (``.item()``): the
ops slice by host ints.

Dispatch pipelining (``lookahead``): each dispatched block's sink output
stays on the device; a ``non_blocking`` copy into a pinned host buffer is
started and a CUDA event recorded. Up to ``lookahead`` dispatches are kept
in flight; :meth:`LineExecutor._resolve_batch` waits on the oldest events
and hands ``receive`` a host copy of each block. Host-fed blocks go to the
device from pinned staging buffers with ``non_blocking`` copies. A pinned
buffer is handed out again only once the event of its last copy completed
(:class:`_HostBuffers`). Host syncs per block on a host-fed line: none
beyond waiting for the oldest in-flight block's event (and that wait is the
point of the window).

Dispatch batching (``batch_blocks``): torch has no ``lax.scan``, so a batch
of k blocks is k sweeps enqueued back to back and resolved as one in-flight
entry. The JAX semantics hold: a pending block target (``stop_before``)
splits a batch, collected feed blocks past a target that arrived during a
blocking feed call are held for the next dispatch, and the in-flight window
stays bounded by ``lookahead``.

No op writes a state or param tensor in place: a mutation replaces the
param tensor (``_Component.set_param``) while blocks already enqueued keep
reading the old one.

:class:`MultiLineExecutor` round-robins several line executors in one
driver thread, flushing and splicing out lines as they hit EOF (reference
``run.go:113-132``).

Not ported yet: ``mesh`` (sharded lines, mesh re-chunking of short reads,
multi-host ``dispatch_noop_to`` padding).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from pipe_tpu_torch import mutable
from pipe_tpu_torch.errors import FlushError, StartError, ret_exec_errors
from pipe_tpu_torch.graph import Route
from pipe_tpu_torch.signal import Signal
from pipe_tpu_torch.tree import tree_flatten, tree_unflatten


class _EOF:
    """Sentinel returned by ``execute`` when the stream is done."""

    def __repr__(self):
        return "EOF"


EOF = _EOF()


def refuse_unported(mesh=None) -> None:
    """Raise ``NotImplementedError`` for the runtime knob the port does not
    have yet: a device mesh."""
    if mesh is not None:
        raise NotImplementedError(
            f"mesh={mesh!r} is not ported yet (only None)")


def _gate(eof: torch.Tensor, new_tree, old_tree):
    """``old_tree`` where the 0-d bool tensor ``eof`` is set, else
    ``new_tree``, leafwise — the structural guard that nothing advances
    past EOF. Tensor leaves select with ``torch.where`` (no sync); a host
    leaf that differs between the trees needs the flag on the host, which
    costs one sync."""
    new_leaves, new_def = tree_flatten(new_tree)
    old_leaves, old_def = tree_flatten(old_tree)
    if new_def != old_def:
        raise ValueError("a step changed the structure of its state tree")
    flag: list = []
    out = []
    for n, o in zip(new_leaves, old_leaves):
        if isinstance(n, torch.Tensor):
            out.append(torch.where(eof, o, n))
        elif n == o:
            out.append(n)
        else:
            if not flag:
                flag.append(bool(eof.item()))
            out.append(o if flag[0] else n)
    return tree_unflatten(new_def, out)


def _leaf_sig(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype)
    return ("host", type(x))


def _trees_compatible(a, b) -> bool:
    la, da = tree_flatten(a)
    lb, db = tree_flatten(b)
    return (da == db and len(la) == len(lb)
            and all(_leaf_sig(x) == _leaf_sig(y) for x, y in zip(la, lb)))


def _carry_forward(old, new) -> None:
    """Carry the live state/params from a component onto its re-allocated
    replacement (a width-changing live insert rebuilds everything
    downstream): state carries whole when the tree structure and every
    leaf shape/dtype match (filter tails, IIR states — exact, no
    transient); params carry per key so live retunes survive the rebuild.
    A leaf whose shape changed with the width keeps its fresh allocation —
    a one-block transient, documented in the surgery contract."""
    if _trees_compatible(old.state, new.state):
        new.state = old.state
    if isinstance(old.params, dict) and isinstance(new.params, dict):
        for k, v in new.params.items():
            if k in old.params and _trees_compatible(old.params[k], v):
                new.params[k] = old.params[k]


class _HostBuffers:
    """Pinned host buffers for ``non_blocking`` copies. A buffer comes back
    with the CUDA event of its last copy and is handed out again only after
    that event completed, so a copy never overwrites a buffer that another
    copy still reads or writes."""

    KEEP = 64  # free buffers kept; the in-flight window needs far fewer

    def __init__(self):
        self._free: list = []  # [(buffer, event or None)], oldest first

    def take(self, shape) -> torch.Tensor:
        shape = tuple(shape)
        for i, (buf, ev) in enumerate(self._free):
            if tuple(buf.shape) == shape and (ev is None or ev.query()):
                del self._free[i]
                return buf
        return torch.empty(shape, dtype=torch.float32, pin_memory=True)

    def give(self, buf: torch.Tensor, event=None) -> None:
        self._free.append((buf, event))
        if len(self._free) > self.KEEP:
            del self._free[0]


class _Block:
    """One dispatched block awaiting resolution: its output (a pinned host
    buffer being filled, or a CPU tensor), valid frames, EOF flag (None, or
    a pinned bool filled by the device) and the event after its work."""

    __slots__ = ("out", "frames", "eof", "event")

    def __init__(self, frames: int):
        self.out = None
        self.frames = frames
        self.eof = None
        self.event = None


class LineExecutor:
    """Executes one bound line, one dispatch (one block, or
    ``batch_blocks`` blocks) per :meth:`execute` call, on the route's
    device. Keeps the live component states and params; live
    ``insert_processor`` splices at a block boundary, so no sample is lost
    or duplicated."""

    def __init__(self, route: Route, block_size: int, stats=None,
                 lookahead: int = 1, batch_blocks: int = 1, mesh=None):
        refuse_unported(mesh=mesh)
        self.route = route
        self.block_size = block_size
        self.device = route.device
        self._cuda = self.device.type == "cuda"
        self.name = "line"  # the Pipe names it after its route index
        self.started = 0  # how many components started, for rollback flush
        # dispatch frontier: stream index of the next block to dispatch —
        # the coordinate system of block-indexed mutations
        self.blocks_dispatched = 0
        # mutation destination of an async line; a sync group's is mirrored
        # as ``group_dest`` so feed collection can re-check for targets
        self.dest: Optional[mutable.Destination] = None
        self.group_dest: Optional[mutable.Destination] = None
        self.stats = stats  # pipe_tpu_torch.profiling.LineStats or None
        # up to `lookahead` dispatches in flight before the oldest is
        # resolved; 1 = the reference's exact next-buffer semantics
        self.lookahead = max(1, lookahead)
        self.batch_blocks = max(1, batch_blocks)
        self._pending: list = []  # in-flight entries (lists of _Block)
        self._held_feds: list = []  # fed blocks parked behind a target
        self._fed_eof = False  # feed returned None (held blocks may remain)
        self._host_bufs = _HostBuffers()

    # -- one block ----------------------------------------------------------

    def _prep_fed_host(self, data):
        """Copy one host feed result into a (C, block) float32 host tensor
        the executor owns (pinned on a CUDA line, zero past the valid
        frames); returns ``(tensor, valid frames)``. The copy is taken at
        collection time, so a feed may reuse its buffer for the next call
        even while this block is batched or held."""
        a = np.asarray(data, np.float32)
        if a.ndim == 1:
            a = a[None, :]
        C = self.route.source.output.channels
        n = a.shape[1]
        if a.shape[0] != C or n > self.block_size:
            raise ValueError(
                f"feed returned shape {a.shape}; expected ({C}, n) with "
                f"n <= {self.block_size}"
            )
        shape = (C, self.block_size)
        buf = (self._host_bufs.take(shape) if self._cuda
               else torch.empty(shape, dtype=torch.float32))
        h = buf.numpy()
        h[:, :n] = a
        if n < self.block_size:
            h[:, n:] = 0.0
        return buf, n

    def _fed_to_device(self, host: torch.Tensor) -> torch.Tensor:
        if not self._cuda:
            return host.to(self.device)  # the tensor itself on the CPU
        x = torch.empty(host.shape, dtype=host.dtype, device=self.device)
        x.copy_(host, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._host_bufs.give(host, ev)
        return x

    def _sweep(self, fed):
        """Run one block through the line and commit its states. ``fed`` is
        ``(host tensor, frames)`` for a host-fed line, else None. Returns
        the block's :class:`_Block`, or None when the source reported EOF
        on the host (nothing ran)."""
        route = self.route
        src, procs, sink = route.source, route.processors, route.sink
        eof = None
        if fed is not None:
            sig = Signal(self._fed_to_device(fed[0]), fed[1])
            src_state = src.state
        else:
            src_state, sig, eof = src.step(src.state, src.params)
            if isinstance(eof, torch.Tensor) and not eof.is_cuda:
                eof = bool(eof)
            if not isinstance(eof, torch.Tensor):
                if eof:
                    return None
                eof = None
            frames = sig.frames
            if isinstance(frames, torch.Tensor):
                frames = frames.item()  # host sync: the ops slice by ints
            sig = Signal(sig.data, int(frames))

        proc_states = []
        for proc in procs:
            new_state, sig = proc.step(proc.state, proc.params, sig)
            proc_states.append(new_state)
        sink_state = sink.state
        if sink.step is not None:
            sink_state = sink.step(sink.state, sink.params, sig)

        if eof is not None:  # a device flag: gate instead of branching
            src_state = _gate(eof, src_state, src.state)
            proc_states = [_gate(eof, s, p.state)
                           for s, p in zip(proc_states, procs)]
            sink_state = _gate(eof, sink_state, sink.state)
        src.state = src_state
        for proc, st in zip(procs, proc_states):
            proc.state = st
        sink.state = sink_state
        self.blocks_dispatched += 1
        return self._stage(sig, eof)

    def _stage(self, sig: Signal, eof) -> _Block:
        """Start the block's output (and device EOF flag) on its way to the
        host and record the event that says it arrived."""
        blk = _Block(sig.frames)
        if self.route.sink.receive is not None and sig.frames > 0:
            if sig.data.is_cuda:
                blk.out = self._host_bufs.take(sig.data.shape)
                blk.out.copy_(sig.data, non_blocking=True)
            else:
                blk.out = sig.data
        if eof is not None:
            blk.eof = torch.empty((), dtype=torch.bool, pin_memory=True)
            blk.eof.copy_(eof, non_blocking=True)
        if self._cuda:
            blk.event = torch.cuda.Event()
            blk.event.record(torch.cuda.current_stream(self.device))
        return blk

    # -- hot path -----------------------------------------------------------

    def execute(self, stop_before=None):
        """Advance the line by one dispatch (one block, or ``batch_blocks``
        blocks). Returns :data:`EOF` when the stream is done, else None.
        Raises on component failure. ``stop_before`` caps the dispatch at
        that absolute block index so mutations land exactly there."""
        if self.stats is None:
            return self._execute(stop_before)
        from pipe_tpu_torch.profiling import _Timer

        with _Timer(self.stats):
            return self._execute(stop_before)

    def _execute(self, stop_before=None):
        # host-side pre hooks in stage order (fault injection, pacing)
        for comp in self.route.components():
            if comp.host_pre is not None:
                comp.host_pre()

        k = self.batch_blocks
        budget = k
        if stop_before is not None:
            budget = max(1, min(k, stop_before - self.blocks_dispatched))

        if self.route.source.feed is not None:
            res = self._dispatch_fed(budget)
        else:
            res = self._dispatch_device(budget)
        if res is EOF:
            return EOF
        if len(self._pending) >= self.lookahead:
            # resolve half the window at once; a split dispatch can enqueue
            # several single entries per execute, so also resolve whatever
            # exceeds the window (the in-flight depth stays bounded)
            n = max(1, self.lookahead // 2,
                    len(self._pending) - self.lookahead + 1)
            return self._resolve_batch(n)
        return None

    def _enqueue(self, blocks: List[_Block]) -> None:
        """A full batch is one in-flight entry; anything else is one entry
        per block (the JAX executor's scanned vs single dispatches)."""
        if len(blocks) == self.batch_blocks and self.batch_blocks > 1:
            self._pending.append(blocks)
        else:
            self._pending.extend([b] for b in blocks)
        if self.stats is not None and blocks:
            self.stats.blocks += len(blocks) - 1

    def _next_target(self, frontier: int):
        """The nearest pending block target past ``frontier``, from the
        owning destination (async: own; sync group: mirrored)."""
        d = self.dest or self.group_dest
        return d.next_target(frontier) if d is not None else None

    def _dispatch_fed(self, budget: int):
        """Collect up to ``budget`` host-fed blocks and dispatch them. The
        budget is re-capped against the nearest pending block target before
        every feed call: a feed may block for arbitrarily long, and a target
        pushed meanwhile must still split the batch. The feed's EOF (None)
        drains everything in flight so trailing blocks reach the sink."""
        src = self.route.source
        feds = []
        while len(feds) < budget:
            nt = self._next_target(self.blocks_dispatched)
            if nt is not None and self.blocks_dispatched + len(feds) >= nt:
                break  # stop at the target; the outer loop applies it
            if self._held_feds:
                feds.append(self._held_feds.pop(0))
                continue
            if self._fed_eof:
                break  # feed already returned None; only held blocks left
            data = src.feed(self.block_size)
            if data is None:
                self._fed_eof = True
                break
            feds.append(self._prep_fed_host(data))
            if feds[-1][1] < self.block_size:
                break  # a partial block is dispatched alone
        # a target may have arrived during the last blocking feed call,
        # inside the collected range: dispatch up to it, hold the rest
        nt = self._next_target(self.blocks_dispatched)
        if nt is not None and self.blocks_dispatched + len(feds) > nt:
            keep = nt - self.blocks_dispatched
            self._held_feds = feds[keep:] + self._held_feds
            feds = feds[:keep]
        if feds:
            self._enqueue([self._sweep(fed) for fed in feds])
        if self._fed_eof and not self._held_feds:
            self.drain()
            return EOF
        return None

    def _dispatch_device(self, budget: int):
        blocks, eof = [], False
        for _ in range(budget):
            blk = self._sweep(None)
            if blk is None:
                eof = True
                break
            blocks.append(blk)
        self._enqueue(blocks)
        if eof:
            self.drain()
            return EOF
        return None

    def _resolve_batch(self, k: int):
        """Resolve the ``k`` oldest in-flight entries: wait for each block's
        event, then deliver outputs / EOF in stream order."""
        sink = self.route.sink
        batch, self._pending = self._pending[:k], self._pending[k:]
        for entry in batch:
            for blk in entry:
                if blk.event is not None:
                    blk.event.synchronize()
                if blk.eof is not None and bool(blk.eof):
                    # blocks dispatched after EOF are gated no-ops
                    self._pending.clear()
                    return EOF
                if blk.out is not None:
                    host = blk.out[:, : blk.frames].numpy().copy()
                    if blk.out.is_pinned():
                        self._host_bufs.give(blk.out)
                    sink.receive(host)
        return None

    def drain(self):
        """Resolve every in-flight block (normal end-of-stream and flush
        path) so no sample is lost. Returns EOF if one was found."""
        res = None
        while self._pending:
            if self._resolve_batch(len(self._pending)) is EOF:
                res = EOF
        return res

    # -- lifecycle (reference run.go:54-74) --------------------------------

    def start_hook(self):
        """Start components in order; stop at the first failure, remembering
        how many started so only those get flushed (``run.go:64-74``). A
        restart is a new stream: the dispatch frontier — the coordinate
        system of ``push(..., at_block=N)`` — rewinds to block 0."""
        self.blocks_dispatched = 0
        self._held_feds = []
        self._fed_eof = False
        for comp in self.route.components():
            if comp.start is not None:
                comp.start()  # raises -> caller handles rollback
            self.started += 1

    def flush_hook(self):
        """Flush the started components in order, collecting every error
        (``run.go:54-62``). In-flight blocks are resolved first, so a clean
        stop never drops delivered samples."""
        errors = []
        try:
            self.drain()
        except Exception as e:  # noqa: BLE001 - fan-in semantics
            errors.append(e)
        for comp in self.route.components()[: self.started]:
            if comp.flush is not None:
                try:
                    comp.flush()
                except Exception as e:  # noqa: BLE001 - fan-in semantics
                    errors.append(e)
        self.started = 0  # restartable; double flush is a no-op
        err = ret_exec_errors(errors)
        if err is not None:
            raise FlushError(str(err)) from err

    # -- live surgery -------------------------------------------------------

    def insert_processor(self, pos: int, proc, alloc=None,
                         rebuilt=None) -> None:
        """Splice a started processor into the route at ``pos``, at a block
        boundary (the reference's two-phase handoff, ``pipe.go:297-365``).

        ``rebuilt`` = ``(new_downstream_procs, new_sink)`` re-allocated for
        a new block width (a width-changing insert): the swap happens here,
        in the executor thread, carrying each old component's live
        state/params onto its replacement where shapes match."""
        if rebuilt is not None:
            new_after, new_sink = rebuilt
            for old, new in zip(self.route.processors[pos:], new_after):
                _carry_forward(old, new)
            _carry_forward(self.route.sink, new_sink)
            self.route.processors[pos:] = new_after
            self.route.sink = new_sink
        self.route.processors.insert(pos, proc)
        if alloc is not None:
            self.route.proc_allocs.insert(pos, alloc)
        self.started += 1

    def apply_mutations(self, ms: mutable.Mutations) -> None:
        """Apply a delivered batch to this line's components in stage order,
        at the block boundary (reference ``pipe.go:384-392,433,465``)."""
        seen = set()
        for comp in self.route.components():
            if comp.context in seen:
                continue
            seen.add(comp.context)
            ms.apply_to(comp.context)


class MultiLineExecutor:
    """Round-robins multiple line executors in one driver thread
    (``run.go:28-34,113-132``). All lines share one mutable context and one
    mutation destination."""

    def __init__(
        self,
        context: mutable.Context = mutable.IMMUTABLE,
        dest: Optional[mutable.Destination] = None,
        executors: Optional[List[LineExecutor]] = None,
    ):
        self.context = context
        self.dest = dest
        self.executors: List[LineExecutor] = executors or []
        self.name = "group"

    def start_hook(self):
        """Start every line; on failure flush everything already started and
        raise (``run.go:78-99``)."""
        start_err = None
        for le in self.executors:
            try:
                le.start_hook()
            except Exception as e:  # noqa: BLE001
                start_err = e
                break
        if start_err is None:
            return
        err = StartError(f"error starting lines: {start_err}")
        err.__cause__ = start_err
        try:
            self.flush_hook()
        except Exception as flush_err:  # noqa: BLE001
            err = StartError(
                f"error flushing lines: {flush_err} during start error: {start_err}"
            )
            err.__cause__ = flush_err
        raise err

    def flush_hook(self):
        errors = []
        for le in self.executors:
            try:
                le.flush_hook()
            except Exception as e:  # noqa: BLE001
                errors.append(e)
        err = ret_exec_errors(errors)
        if err is not None:
            raise err

    @property
    def blocks_dispatched(self) -> int:
        """The group's dispatch frontier: lines in a sync group advance in
        lockstep, so the max over live lines is the sweep coordinate used by
        block-indexed mutations (live-added lines start behind)."""
        return max((le.blocks_dispatched for le in self.executors), default=0)

    def execute(self, stop_before=None):
        """One sweep over all live lines; EOF'd lines are flushed and spliced
        out; returns EOF once no lines remain (``run.go:113-132``)."""
        i = 0
        while i < len(self.executors):
            res = self.executors[i].execute(stop_before)  # raises on error
            if res is EOF:
                self.executors[i].flush_hook()  # raises -> becomes the error
                del self.executors[i]
                if self.executors:
                    continue
                return EOF
            i += 1
        return None

    def apply_mutations(self, ms: mutable.Mutations) -> None:
        for le in self.executors:
            le.apply_mutations(ms)

    def adopt_line(self, le: LineExecutor) -> None:
        """Start and append a new line at a block boundary (the analog of
        ``multiLineExecutor.addRoute``, ``run.go:134-144``)."""
        le.start_hook()  # raises -> delivered as executor error
        self.executors.append(le)

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

On a mesh (``mesh=``, :mod:`pipe_tpu_torch.parallel`) every rank of the
mesh runs the same executor over the same stream, one process per shard,
and each sweep runs under ``mesh_scope(mesh)``, bound on the executor's own
thread. The components hold this rank's block of their state and params
(:mod:`pipe_tpu_torch.parallel.components`). What the executor adds:

- a host-fed block is cut to this rank's ``(c_local, n_local)`` block on
  the host, into the pinned staging buffer, and only that is uploaded;
  channel rows pad with zeros up to the channel-axis multiple and the
  frames past the valid count are zero (the EOF / partial-final-chunk
  mask). A device source generates its local block; the executor zeroes
  its pad rows and the frames past ``frames``;
- short reads are re-chunked on the host (:meth:`_feed_full_block`): the
  sharded stages advance their carries by whole local chunks, so a partial
  block must be the stream's last. A zero-length read backs off briefly
  and is asked again; a cancelled run stops asking;
- on a mesh larger than 1x1 a sink with ``receive`` gets the WHOLE output
  on every rank: an ``all_gather`` over the time axis, then over the
  channel axis unless a processor reduced the channels. The gather is
  made inside the sweep, in stream order, never at resolution: every
  rank enqueues the same collectives in the same order. Over gloo (the
  ``gloo`` and ``gloo+host`` transports) a collective waits for the block's
  work, so ``lookahead`` overlaps nothing there; over NCCL it is enqueued
  on the stream like any other kernel;
- :meth:`dispatch_noop_to` sweeps zero blocks with the same collectives,
  commits no state and delivers nothing (the exit-path padding of the JAX
  package's multi-host protocol).

How many sweeps a rank makes is decided by the stream and the targeted
pushes alone, never by a clock or an event query, so the ranks agree.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from pipe_tpu_torch import config, mutable
from pipe_tpu_torch.errors import FlushError, StartError, ret_exec_errors
from pipe_tpu_torch.graph import Route
from pipe_tpu_torch.parallel.mesh import CH_AXIS, TIME_AXIS
from pipe_tpu_torch.parallel.meshctx import mesh_scope
from pipe_tpu_torch.signal import Signal, zero_past
from pipe_tpu_torch.tree import tree_flatten, tree_unflatten


class _EOF:
    """Sentinel returned by ``execute`` when the stream is done."""

    def __repr__(self):
        return "EOF"


EOF = _EOF()


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
    a one-block transient, documented in the surgery contract. On a mesh the
    shapes compared are this rank's local blocks: the rebuild runs on the
    same mesh with the same dispatch grid, so a leaf's layout over the mesh
    is unchanged and equal local shapes mean equal global ones."""
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
    or duplicated. With a ``mesh`` the line is this rank's shard of a
    sharded line (see the module docstring) and ``block_size`` the GLOBAL
    frames per dispatch."""

    #: pause between two asks after a zero-length read of a mesh feed
    EMPTY_READ_BACKOFF_S = 0.001

    def __init__(self, route: Route, block_size: int, stats=None,
                 lookahead: int = 1, batch_blocks: int = 1, mesh=None):
        self.route = route
        self.block_size = block_size
        self.mesh = mesh
        if mesh is not None and not mesh.member:
            raise ValueError(
                f"rank {mesh.rank} lies outside the mesh and runs no line")
        # this rank's block of the fed signal: rows [r0, r0 + c_local) of
        # the channel-padded block, frames [f0, f0 + n_local)
        c_user = route.source.output.channels
        ch = 1 if mesh is None else mesh.shape[CH_AXIS]
        t = 1 if mesh is None else mesh.shape[TIME_AXIS]
        self._multi = ch * t > 1
        self._c_local = -(-c_user // ch)
        self._n_local = block_size // t
        self._r0 = 0 if mesh is None else mesh.axis_index(CH_AXIS) * self._c_local
        self._f0 = 0 if mesh is None else mesh.axis_index(TIME_AXIS) * self._n_local
        # set by the runtime: an Event that says the run was cancelled
        self.cancel = None
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
        # mesh re-chunking: (C, n) pieces of feed data not yet a full block
        self._fed_residue: list = []
        self._host_bufs = _HostBuffers()
        # the precision name this line's products use, bound at start_hook
        # (None: the process-wide name, read at every call)
        self.precision: Optional[str] = None

    # -- mesh ---------------------------------------------------------------

    def _validate_mesh_route(self, route: Optional[Route] = None):
        route = self.route if route is None else route
        t_shards = self.mesh.shape[TIME_AXIS]
        if self.block_size % t_shards:
            raise ValueError(
                f"block_size {self.block_size} not divisible by the mesh "
                f"time axis ({t_shards})"
            )
        if t_shards > 1:
            for c in route.components():
                if tree_flatten(c.state)[0] and not hasattr(c, "state_spec"):
                    raise ValueError(
                        f"stateful component {c!r} has no state_spec: on a "
                        "time-sharded mesh, stream state must declare its "
                        "sharding (use the pipe_tpu_torch.parallel.components "
                        "kit or set state_spec/param_spec explicitly)"
                    )

    def _mask_device_block(self, data: torch.Tensor, frames: int):
        """A device source's local block with the frames past the global
        valid count and, on a channel-padded line, the pad rows zeroed
        (both by this rank's global positions)."""
        valid = min(max(frames - self._f0, 0), self._n_local)
        if valid < data.shape[1]:
            data = zero_past(data, valid)
        keep = min(max(self.route.source.output.channels - self._r0, 0),
                   self._c_local)
        if keep < data.shape[0]:
            data = torch.cat([data[:keep], data.new_zeros(
                (data.shape[0] - keep, data.shape[1]))], dim=0)
        return data

    def _gather_out(self, d: torch.Tensor) -> torch.Tensor:
        """The whole output block from every rank's block, on every rank:
        gathered over the time axis, then over the channel axis unless a
        processor reduced the channels. The last gather is asked for the
        host (see ``Mesh.all_gather``), where the sink needs it."""
        axes = [(TIME_AXIS, 1)]
        if not any(getattr(p, "reduces_channels", False)
                   for p in self.route.processors):
            axes.append((CH_AXIS, 0))
        for i, (axis, dim) in enumerate(axes):
            parts = self.mesh.all_gather(d, axis, to_host=i == len(axes) - 1)
            d = torch.cat(list(parts), dim=dim)
        return d

    # -- one block ----------------------------------------------------------

    def _prep_fed_host(self, data):
        """Copy this rank's block of one host feed result into a float32
        host tensor the executor owns (pinned on a CUDA line): ``(C,
        block)`` without a mesh, ``(c_local, n_local)`` on one, zero past
        the valid frames and in the channel pad rows. Returns ``(tensor,
        valid frames of the whole block)``. Only this block is uploaded.
        The copy is taken at collection time, so a feed may reuse its
        buffer for the next call even while this block is batched or
        held."""
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
        shape = (self._c_local, self._n_local)
        buf = (self._host_bufs.take(shape) if self._cuda
               else torch.empty(shape, dtype=torch.float32))
        h = buf.numpy()
        mine = a[self._r0:self._r0 + self._c_local,
                 self._f0:self._f0 + self._n_local]
        rows, cols = mine.shape
        h[:rows, :cols] = mine
        if cols < self._n_local:
            h[:, cols:] = 0.0
        if rows < self._c_local:
            h[rows:, :cols] = 0.0
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

    def _sweep(self, fed, commit: bool = True):
        """Run one block through the line and commit its states, under the
        line's mesh scope. ``fed`` is ``(host tensor, frames)`` for a
        host-fed line, else None. Returns the block's :class:`_Block`, or
        None when the source reported EOF on the host (nothing ran).
        ``commit=False`` (:meth:`dispatch_noop_to`) runs the block with
        every collective of a regular one and keeps nothing of it."""
        with mesh_scope(self.mesh), config.precision_bound(self.precision):
            return self._sweep_scoped(fed, commit)

    def _sweep_scoped(self, fed, commit: bool):
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
            data, frames = sig.data, int(frames)
            if self.mesh is not None:
                data = self._mask_device_block(data, frames)
            sig = Signal(data, frames)

        proc_states = []
        for proc in procs:
            new_state, sig = proc.step(proc.state, proc.params, sig)
            proc_states.append(new_state)
        sink_state = sink.state
        if sink.step is not None:
            sink_state = sink.step(sink.state, sink.params, sig)

        if not commit:
            if self._multi and sink.receive is not None:
                self._gather_out(sig.data)
            self.blocks_dispatched += 1
            return None
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
        if self.route.sink.receive is not None:
            # on a mesh larger than 1x1 the gather is a collective: it is
            # made for every block, whatever the block holds
            data = self._gather_out(sig.data) if self._multi else sig.data
            if sig.frames > 0 and data.is_cuda:
                blk.out = self._host_bufs.take(data.shape)
                blk.out.copy_(data, non_blocking=True)
            elif sig.frames > 0:
                blk.out = data
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
            if self._fed_eof and not self._fed_residue:
                break  # feed already returned None; only held blocks left
            if self.mesh is not None:
                # a partial block must be the stream's last on a mesh:
                # short reads are re-chunked into full blocks
                got = self._feed_full_block(src)
                if got is None:
                    break  # EOF with no residue, or the run was cancelled
                feds.append(got)
                if got[1] < self.block_size:
                    break  # the final partial block, at EOF
                continue
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
        if self._fed_eof and not self._held_feds and not self._fed_residue:
            self.drain()
            return EOF
        return None

    def _feed_full_block(self, src):
        """Assemble one FULL block (or the final partial one at EOF) from
        the feed, parking over- and under-runs in ``_fed_residue``: the
        mesh twin of the reference's accept-any-length short-read slicing
        (``pipe.go:404-406``). Returns None at EOF with nothing left (and
        when the run was cancelled while the feed had nothing ready), else
        ``(this rank's block, valid frames)``. The repacking is a function
        of the stream alone, so ranks fed the same stream stay aligned."""
        have = sum(a.shape[1] for a in self._fed_residue)
        while have < self.block_size and not self._fed_eof:
            data = src.feed(self.block_size - have)
            if data is None:
                self._fed_eof = True
                break
            data = np.asarray(data, np.float32)
            if data.ndim == 1:
                data = data[None, :]
            if data.shape[1] == 0:
                # nothing ready: ask again after a pause, unless the run
                # was cancelled meanwhile
                if self.cancel is not None and self.cancel.is_set():
                    return None
                time.sleep(self.EMPTY_READ_BACKOFF_S)
                continue
            self._fed_residue.append(data)
            have += data.shape[1]
        if have == 0:
            return None
        n = min(have, self.block_size)
        chunks, taken = [], 0
        while taken < n:
            a = self._fed_residue[0]
            take = min(a.shape[1], n - taken)
            chunks.append(a[:, :take])
            if take < a.shape[1]:
                self._fed_residue[0] = a[:, take:]
            else:
                self._fed_residue.pop(0)
            taken += take
        data = chunks[0] if len(chunks) == 1 else np.concatenate(chunks, axis=1)
        return self._prep_fed_host(data)

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
                    rows = blk.out.shape[0]
                    if self.mesh is not None:  # slice off channel pad rows
                        rows = self.route.prev_props(
                            len(self.route.processors)).channels
                    host = blk.out[:rows, : blk.frames].numpy().copy()
                    if blk.out.is_pinned():
                        self._host_bufs.give(blk.out)
                    sink.receive(host)
        return None

    def dispatch_noop_to(self, target: int) -> None:
        """Exit-path padding of the multi-host protocol: sweep zero blocks
        (frames 0) until the dispatch frontier reaches ``target``, making
        every collective of a regular dispatch, the output gather included,
        so that the peers' blocks in flight complete. Nothing is donated
        here, so no copy of the states is needed: the sweeps commit
        nothing and deliver nothing, and a later snapshot sees the stream
        state as it was."""
        shape = (self._c_local, self._n_local)
        while self.blocks_dispatched < target:
            buf = (self._host_bufs.take(shape) if self._cuda
                   else torch.empty(shape, dtype=torch.float32))
            buf.zero_()
            self._sweep((buf, 0), commit=False)

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
        self._fed_residue = []
        # the JAX package reads the precision when it traces the line's
        # step; here the name is read once per run and bound to every sweep
        self.precision = config.matmul_precision()
        if self.mesh is not None:
            self._validate_mesh_route()
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
        state/params onto its replacement where shapes match. On a mesh
        the spliced route is validated as at start (a stateful component on
        a time-sharded mesh must declare its sharding); a route that fails
        is restored and the ``ValueError`` raised."""
        if self.mesh is not None:
            trial = dataclasses.replace(
                self.route,
                processors=(self.route.processors[:pos] + [proc]
                            + (rebuilt[0] if rebuilt is not None
                               else self.route.processors[pos:])),
                sink=rebuilt[1] if rebuilt is not None else self.route.sink)
            self._validate_mesh_route(trial)
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
        # every line of the group, the ended ones too, fixed at the first
        # start (and grown by adopt_line): a restart runs all of them again
        self._members: Optional[List[LineExecutor]] = None
        # once every line ended: the lines of the last sweep, which keep the
        # group's frontier and pad it (a peer that failed before the end
        # pads those same lines)
        self._tail: List[LineExecutor] = []
        self.name = "group"

    def start_hook(self):
        """Start every line; on failure flush everything already started and
        raise (``run.go:78-99``). A restart is a new stream for every line
        of the group, those that ended in the previous run included (lines
        that reach EOF leave ``executors`` as they end)."""
        if self._members is None:
            self._members = list(self.executors)
        else:
            self.executors = list(self._members)
        self._tail = []
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
        block-indexed mutations (a line added live starts its count at the
        frontier it joined at)."""
        return max((le.blocks_dispatched for le in self.executors or self._tail),
                   default=0)

    def execute(self, stop_before=None):
        """One sweep over all live lines; EOF'd lines are flushed and spliced
        out; returns EOF once no lines remain (``run.go:113-132``)."""
        live = list(self.executors)
        i = 0
        while i < len(self.executors):
            res = self.executors[i].execute(stop_before)  # raises on error
            if res is EOF:
                self.executors[i].flush_hook()  # raises -> becomes the error
                del self.executors[i]
                if self.executors:
                    continue
                self._tail = live
                return EOF
            i += 1
        return None

    def apply_mutations(self, ms: mutable.Mutations) -> None:
        for le in self.executors:
            le.apply_mutations(ms)

    def dispatch_noop_to(self, target: int) -> None:
        """Pad the group to the sweep frontier ``target`` in the order of a
        regular round-robin pass, so that the per-line collectives come in
        the order that the still-streaming peers make them. After a failure
        in the middle of a sweep the lines behind finish that sweep first;
        then whole sweeps follow. Once every line ended, the lines of the
        last sweep pad: a peer that failed before the end pads those lines
        too. (A line that ends between a peer's failure and the end of the
        stream cannot be matched: the failed peer pads it past its end, and
        the ranks meet at the group timeout instead, as in the JAX
        package.)"""
        lines = self.executors or self._tail
        while lines and min(le.blocks_dispatched for le in lines) < target:
            lo = min(le.blocks_dispatched for le in lines)
            for le in lines:
                if le.blocks_dispatched == lo:
                    le.dispatch_noop_to(le.blocks_dispatched + 1)

    def adopt_line(self, le: LineExecutor) -> None:
        """Start and append a new line at a block boundary (the analog of
        ``multiLineExecutor.addRoute``, ``run.go:134-144``). On a mesh the
        line's route is validated as at start. The line counts its sweeps
        from the group's frontier, the coordinate of the group's targets,
        rounds and padding."""
        le.start_hook()  # raises -> delivered as executor error
        le.blocks_dispatched = self.blocks_dispatched
        self.executors.append(le)
        if self._members is not None:
            self._members.append(le)

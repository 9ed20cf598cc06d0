"""Executors — the per-block hot path.

The PyTorch counterpart of :mod:`pipe_tpu.runtime.executor`, for one block
per dispatch. Where the JAX executor traces the whole ``Source ->
Processors -> Sink`` sweep into one jitted computation, this one calls the
component steps eagerly, in order, once per block; the ops enqueue their
work on the device's current stream.

Stream control stays on the host. ``Signal.frames`` is a host int, the
resampler's phase offset is a host int in its state, and EOF is a host
bool. A block that reports EOF runs no processor and commits no state, so
nothing advances past the end of the stream (what the JAX executor's
``_gate`` does inside the traced step). A block's new states are committed
only after every step of the sweep returned.

Host syncs per block:

- host-fed line: the copy of the fed block to the device (from pageable
  memory, so the host waits for it), and the copy of the sink's output back
  to the host for ``receive``. Nothing else: the biquad kernel reads its
  coefficients on the device, and the resampler's fast/gather branch reads
  host state.
- device-source line: reading the source's ``frames`` and ``eof`` back to
  the host when the source returns them as tensors (free when it returns
  host values), plus the output copy when the sink has ``receive``.

:class:`MultiLineExecutor` round-robins several line executors in one
driver thread, flushing and splicing out lines as they hit EOF (reference
``run.go:113-132``).

Not ported yet: ``lookahead > 1``, ``batch_blocks > 1``, ``mesh``,
per-block stats, live ``insert_processor`` and ``dispatch_noop_to``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from pipe_tpu_torch import mutable
from pipe_tpu_torch.errors import FlushError, StartError, ret_exec_errors
from pipe_tpu_torch.graph import Route
from pipe_tpu_torch.signal import Signal


class _EOF:
    """Sentinel returned by ``execute`` when the stream is done."""

    def __repr__(self):
        return "EOF"


EOF = _EOF()


def refuse_unported(stats=None, lookahead: int = 1, batch_blocks: int = 1,
                    mesh=None, optimize: bool = False) -> None:
    """Raise ``NotImplementedError`` for any runtime knob set away from its
    default: the port runs one block per dispatch on one device."""
    for name, value, default in (
        ("stats", stats, None), ("lookahead", lookahead, 1),
        ("batch_blocks", batch_blocks, 1), ("mesh", mesh, None),
        ("optimize", optimize, False),
    ):
        if value != default:
            raise NotImplementedError(
                f"{name}={value!r} is not ported yet (only {default!r})"
            )


def _host_bool(x) -> bool:
    return bool(x.item()) if isinstance(x, torch.Tensor) else bool(x)


class LineExecutor:
    """Executes one bound line, one block per :meth:`execute` call, on the
    route's device."""

    def __init__(self, route: Route, block_size: int, stats=None,
                 lookahead: int = 1, batch_blocks: int = 1, mesh=None):
        refuse_unported(stats=stats, lookahead=lookahead,
                        batch_blocks=batch_blocks, mesh=mesh)
        self.route = route
        self.block_size = block_size
        self.device = route.device
        self.started = 0  # how many components started, for rollback flush
        # dispatch frontier: stream index of the next block to dispatch
        self.blocks_dispatched = 0

    # -- hot path ----------------------------------------------------------

    def _prep_fed_host(self, data):
        """Normalize one host feed result to (padded (C, block) float32,
        valid frame count)."""
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[None, :]
        C = self.route.source.output.channels
        n = data.shape[1]
        if data.shape[0] != C or n > self.block_size:
            raise ValueError(
                f"feed returned shape {data.shape}; expected ({C}, n) with "
                f"n <= {self.block_size}"
            )
        if n < self.block_size:
            out = np.zeros((C, self.block_size), np.float32)
            out[:, :n] = data
            return out, n
        return np.ascontiguousarray(data), n

    def execute(self, stop_before=None):
        """Advance the line by one block. Returns :data:`EOF` when the
        stream is done, else None; raises on component failure.
        ``stop_before`` (a pending mutation target) needs no handling: one
        block per dispatch never crosses a block boundary."""
        route = self.route
        src, procs, sink = route.source, route.processors, route.sink
        for comp in route.components():
            if comp.host_pre is not None:
                comp.host_pre()

        src_state = src.state
        if src.feed is not None:
            data = src.feed(self.block_size)
            if data is None:
                return EOF
            host, n = self._prep_fed_host(data)
            # copy: the feed may reuse its buffer for the next block
            x = torch.from_numpy(host).to(self.device, copy=True)
            sig = Signal(x, n)
        else:
            src_state, sig, eof = src.step(src.state, src.params)
            if _host_bool(eof):
                return EOF
            frames = sig.frames
            if isinstance(frames, torch.Tensor):
                frames = frames.item()
            sig = Signal(sig.data, int(frames))

        proc_states = []
        for proc in procs:
            new_state, sig = proc.step(proc.state, proc.params, sig)
            proc_states.append(new_state)
        sink_state = sink.state
        if sink.step is not None:
            sink_state = sink.step(sink.state, sink.params, sig)

        src.state = src_state
        for proc, st in zip(procs, proc_states):
            proc.state = st
        sink.state = sink_state
        self.blocks_dispatched += 1

        if sink.receive is not None and sig.frames > 0:
            sink.receive(sig.data[:, : sig.frames].cpu().numpy())
        return None

    # -- lifecycle (reference run.go:54-74) --------------------------------

    def start_hook(self):
        """Start components in order; stop at the first failure, remembering
        how many started so only those get flushed (``run.go:64-74``). A
        restart is a new stream: the dispatch frontier rewinds to 0."""
        self.blocks_dispatched = 0
        for comp in self.route.components():
            if comp.start is not None:
                comp.start()  # raises -> caller handles rollback
            self.started += 1

    def flush_hook(self):
        """Flush the started components in order, collecting every error
        (``run.go:54-62``)."""
        errors = []
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
        """The group's dispatch frontier (lines advance in lockstep)."""
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

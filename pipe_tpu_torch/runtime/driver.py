"""Blocking drivers (reference ``run.go:198-224`` and ``pipe.Run``,
``pipe.go:89-103``)."""

from __future__ import annotations

from typing import Optional

from pipe_tpu_torch import mutable
from pipe_tpu_torch.errors import ErrorRun, RunError, StartError
from pipe_tpu_torch.graph import Line, make_route
from pipe_tpu_torch.runtime.executor import (
    EOF,
    LineExecutor,
    MultiLineExecutor,
    refuse_unported,
)


def run_executor(executor, cancel=None) -> None:
    """Run an executor to completion in the calling thread (``run.go:198-224``):
    start; loop execute until EOF/error, applying due mutations from the
    executor's ``dest`` at block boundaries; always flush; wrap exec+flush
    failures into :class:`ErrorRun`."""
    try:
        executor.start_hook()
    except Exception as e:  # noqa: BLE001
        if isinstance(e, StartError):
            raise
        err = StartError(f"error starting: {e}")
        err.__cause__ = e
        raise err from e

    err_exec: Optional[BaseException] = None
    try:
        while True:
            if cancel is not None and cancel.is_set():
                break
            stop_before = None
            if executor.dest is not None:
                frontier = executor.blocks_dispatched
                ms = executor.dest.take_due(frontier)
                if ms:
                    executor.apply_mutations(ms)
                stop_before = executor.dest.next_target(frontier)
            if executor.execute(stop_before) is EOF:
                break
    except Exception as e:  # noqa: BLE001
        err_exec = RunError(f"error running: {e}")
        err_exec.__cause__ = e

    err_flush: Optional[BaseException] = None
    try:
        executor.flush_hook()
    except Exception as e:  # noqa: BLE001
        err_flush = e

    if err_exec is not None or err_flush is not None:
        raise ErrorRun(err_exec, err_flush)


def run(block_size: int, *lines: Line, stats=None, lookahead: int = 1,
        cancel=None, batch_blocks: int = 1, mesh=None,
        optimize: bool = False, device=None) -> None:
    """One-shot synchronous execution (``pipe.Run``, ``pipe.go:89-103``):
    every line is forced into one shared mutable context and round-robined
    by a single :class:`MultiLineExecutor` in the calling thread.

    ``device`` is where the lines' streams live (default: the device each
    source declares, else ``pipe_tpu_torch.config.default_device()``: the
    card, unless the CPU was asked for with ``set_default_device("cpu")``).
    ``stats`` is an
    optional :class:`pipe_tpu_torch.StatsRecorder`. ``cancel`` is an
    optional ``threading.Event``: setting it stops the run at the next
    block boundary with flush hooks run. ``lookahead`` keeps that many
    dispatches in flight before resolving the oldest; ``batch_blocks=k``
    enqueues k blocks per dispatch (mutation granularity coarsens to k
    unless targeted with ``at_block``). ``optimize=True`` runs the fusion
    fixpoint (:func:`pipe_tpu_torch.optimize.fuse`) on every line before
    building; retunes through the original op objects keep landing.
    ``mesh`` keeps the JAX package's signature and raises
    ``NotImplementedError``.
    """
    refuse_unported(mesh=mesh)
    if optimize:
        from pipe_tpu_torch import optimize as _optimize

        lines = tuple(_optimize.fuse(line) for line in lines)
    mctx = mutable.mutable()
    mle = MultiLineExecutor(context=mctx)
    for i, line in enumerate(lines):
        bound = Line(source=line.source, processors=line.processors,
                     sink=line.sink, context=mctx)
        route = make_route(bound, block_size, device)
        ls = None
        if stats is not None:
            ls = stats.line(f"line{i}", block_size,
                            route.source.output.channels)
        mle.executors.append(
            LineExecutor(route, block_size, stats=ls, lookahead=lookahead,
                         batch_blocks=batch_blocks)
        )
    run_executor(mle, cancel=cancel)

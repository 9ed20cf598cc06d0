"""Error types (reference ``error.go:9-57``).

The reference's typed first-error-wins philosophy maps onto Python
exceptions: stage allocation, start, run, and flush failures are wrapped so
the phase is identifiable, and :class:`ErrorRun` pairs an execution error with
a flush error when both occur (``error.go:9-44``)."""

from __future__ import annotations

from typing import List, Optional


class PipeError(Exception):
    """Base class for all pipe_tpu_torch errors."""


class AllocationError(PipeError):
    """A component allocator failed (reference wraps with the stage name,
    ``line.go:63-81``)."""


class ShapeConstraintError(ValueError):
    """A sharded stage's shape rule failed for the OFFERED local chunk —
    a constraint a LARGER chunk satisfies (halo > n_local, resampler
    phase divisibility, spectral grid rules). The mesh runtime catches
    this during allocation and retries with an aggregated block (several
    user blocks dispatched as one chunk) until every stage's rule holds —
    the any-block-size contract of the reference (``pipe.go:90``).
    Non-shape errors (wrong channel counts, bad params) stay plain
    ``ValueError`` and fail the build immediately."""


class StartError(PipeError):
    """A start hook failed (``run.go:177-179,201-203``)."""


class FlushError(PipeError):
    """A flush hook failed (``run.go:181-185``)."""


class RunError(PipeError):
    """A component failed during execution (``run.go:192,222``)."""


class ErrorRun(RunError):
    """Execution and/or flush failed after a successful start
    (``error.go:9-44``). ``__cause__``-style chaining is preserved through the
    stored sub-errors. Subclasses :class:`RunError` so ``except RunError``
    catches any run-phase failure — the Python analog of the reference's
    ``errors.Is`` unwrapping (``error.go:30-38``)."""

    def __init__(self, err_exec: Optional[BaseException], err_flush: Optional[BaseException]):
        self.err_exec = err_exec
        self.err_flush = err_flush
        super().__init__(self._message())

    def _message(self) -> str:
        if self.err_exec is not None and self.err_flush is not None:
            return f"flush error: {self.err_flush} after execute error: {self.err_exec}"
        if self.err_exec is not None:
            return f"execute error: {self.err_exec}"
        if self.err_flush is not None:
            return f"flush error: {self.err_flush}"
        return ""

    def is_(self, exc_type) -> bool:
        """Match either sub-error against an exception type (the analog of
        ``ErrorRun.Is``, ``error.go:30-38``)."""

        def matches(e):
            while e is not None:
                if isinstance(e, exc_type):
                    return True
                e = e.__cause__
            return False

        return matches(self.err_exec) or matches(self.err_flush)


class ExecErrors(PipeError):
    """Multiple executor failures joined (``error.go:46-57``)."""

    def __init__(self, errors: List[BaseException]):
        self.errors = errors
        super().__init__(",".join(str(e) for e in errors))


def ret_exec_errors(errors: List[BaseException]) -> Optional[BaseException]:
    """None for empty, the single error unwrapped-style, else ExecErrors
    (mirrors ``execErrors.ret``, ``error.go:51-57``, but keeps the single
    error identity for cleaner matching)."""
    if not errors:
        return None
    if len(errors) == 1:
        return errors[0]
    return ExecErrors(errors)

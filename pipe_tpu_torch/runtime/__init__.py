"""Runtime — executors and the blocking driver (reference L4: ``run.go``,
runtime half of ``pipe.go``). The async ``Pipe`` is not ported yet."""

from pipe_tpu_torch.runtime.executor import LineExecutor, MultiLineExecutor, EOF
from pipe_tpu_torch.runtime.driver import run, run_executor

__all__ = [
    "LineExecutor",
    "MultiLineExecutor",
    "EOF",
    "run",
    "run_executor",
]

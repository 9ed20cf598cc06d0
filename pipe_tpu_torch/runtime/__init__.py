"""Runtime — executors, the async Pipe and the blocking driver (reference
L4: ``run.go``, ``pipe.go``)."""

from pipe_tpu_torch.runtime.executor import LineExecutor, MultiLineExecutor, EOF
from pipe_tpu_torch.runtime.pipe import Pipe, wait
from pipe_tpu_torch.runtime.driver import run, run_executor

__all__ = [
    "LineExecutor",
    "MultiLineExecutor",
    "EOF",
    "Pipe",
    "wait",
    "run",
    "run_executor",
]

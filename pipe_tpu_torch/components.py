"""Components — Source, Processor, Sink (reference ``pipe.go:32-87``).

The PyTorch counterpart of :mod:`pipe_tpu.components`, with the same
dataclasses and step contracts. A component is data: a *step function*
over trees (dicts, lists and tuples) of tensors plus its initial ``state``,
its ``params`` (the mutation surface), host lifecycle hooks, and a mutable
context.

Step contracts (eager PyTorch, called once per block):

- Source:    ``step(state, params) -> (state, Signal, eof)`` where ``eof``
  is a bool (or a 0-d bool tensor). ``eof=True`` means "no message this
  block" and the stream is done. A partial final block is a normal message
  with ``Signal.frames < block_size`` followed by an ``eof`` step.
- Processor: ``step(state, params, sig) -> (state, sig_out)``
- Sink:      ``step(state, params, sig) -> state``

The executor commits no state of a block that reported EOF, so nothing
advances past the end of the stream.

Host-boundary components:

- A Source may instead have ``feed(block_size) -> np.ndarray | None``: a
  host callable producing ``(channels, n)`` samples per block (n <=
  block_size; short = partial; None = EOF).
- A Sink may have ``receive(np.ndarray)``: a host callable given the valid
  ``(channels, frames)`` output each block.
- Any component may have ``host_pre() -> None``, called on the executor
  thread before each block.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pipe_tpu_torch import mutable
from pipe_tpu_torch.signal import Signal, SignalProperties

SourceStepFn = Callable[..., Tuple[Any, Signal, Any]]
ProcessStepFn = Callable[..., Tuple[Any, Signal]]
SinkStepFn = Callable[..., Any]
HookFn = Callable[[], None]

Params = Dict[str, Any]


def param_tensor(value, device=None) -> torch.Tensor:
    """A parameter tensor: a float32 copy of ``value`` (array-like or
    tensor) on ``device``, sharing no memory with the caller's object."""
    return torch.as_tensor(value, dtype=torch.float32, device=device).clone()


@dataclasses.dataclass
class _Component:
    """Shared component plumbing: identity, params, state, lifecycle."""

    state: Any = None
    params: Params = dataclasses.field(default_factory=dict)
    start: Optional[HookFn] = None
    flush: Optional[HookFn] = None
    host_pre: Optional[HookFn] = None
    # Set by the allocation machinery (reference line.go:128-153 assigns the
    # component context after the allocator returns).
    context: mutable.Context = mutable.IMMUTABLE

    def set_param(self, name: str, value) -> None:
        """Replace a parameter (same shape and dtype); the next block reads
        the new value."""
        self.params[name] = value

    def get_param(self, name: str):
        return self.params[name]

    def replace_param(self, name: str, value) -> None:
        """Replace a tensor parameter by a float32 copy of ``value`` on the
        current one's device (the body of a live retune)."""
        self.set_param(name, param_tensor(value, self.params[name].device))

    def update_state(self, fn: Callable[[Any], Any]) -> None:
        """Replace the live state tree via ``fn(old) -> new``. Must preserve
        the tree structure and leaf shapes/dtypes. Only call from a mutation
        (executor thread) or before the pipe starts."""
        self.state = fn(self.state)


@dataclasses.dataclass
class Source(_Component):
    """Origin of signal (``pipe.go:35-47``)."""

    output: SignalProperties = None  # type: ignore[assignment]
    step: Optional[SourceStepFn] = None
    feed: Optional[Callable[[int], Optional[np.ndarray]]] = None

    def __post_init__(self):
        if self.output is None:
            raise ValueError("Source requires output SignalProperties")
        if self.step is None and self.feed is None:
            raise ValueError("Source requires a step fn or a host feed fn")


@dataclasses.dataclass
class Processor(_Component):
    """Signal manipulator (``pipe.go:52-64``). ``output`` declares the
    processor's output stream properties. ``out_capacity`` (optional)
    declares its output block WIDTH when it differs from the input width (a
    resampler emits ``ceil(B*L/M)`` frames); the route builder threads it as
    the next allocator's ``block_size`` (``None`` = width-preserving)."""

    output: SignalProperties = None  # type: ignore[assignment]
    step: ProcessStepFn = None  # type: ignore[assignment]
    out_capacity: Optional[int] = None

    def __post_init__(self):
        if self.output is None:
            raise ValueError("Processor requires output SignalProperties")
        if self.step is None:
            raise ValueError("Processor requires a step fn")


@dataclasses.dataclass
class Sink(_Component):
    """Destination of signal (``pipe.go:69-81``)."""

    step: Optional[SinkStepFn] = None
    receive: Optional[Callable[[np.ndarray], None]] = None

    def __post_init__(self):
        if self.step is None and self.receive is None:
            raise ValueError("Sink requires a device step fn or a host receive fn")


# Allocator function types (reference line.go:24-35):
#   SourceAllocatorFunc(mctx, block_size) -> Source
#   ProcessorAllocatorFunc(mctx, block_size, input: SignalProperties) -> Processor
#   SinkAllocatorFunc(mctx, block_size, input: SignalProperties) -> Sink
SourceAllocatorFunc = Callable[[mutable.Context, int], Source]
ProcessorAllocatorFunc = Callable[[mutable.Context, int, SignalProperties], Processor]
SinkAllocatorFunc = Callable[[mutable.Context, int, SignalProperties], Sink]

"""Mock components — the test kit (reference ``mock/mock.go:15-192``).

The PyTorch counterpart of :mod:`pipe_tpu.mock`: deterministic generators,
pass-through processors and capture sinks with message/sample counters,
hook spies and the full fault-injection matrix (``error_on_make`` /
``error_on_call`` / ``error_on_start`` / ``error_on_flush``).

The Source knows its ``limit`` and the block size on the host, so it
computes each block's frame count and EOF as a host int and bool and keeps
its counters as host ints: a line fed by it needs no device sync per
block. Only the generated block is a tensor, on the line's device. The
Processor's counters are host ints too (frames are host ints in the port),
and the Sink is host state, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from pipe_tpu_torch import mutable
from pipe_tpu_torch.components import Processor as ProcessorComponent
from pipe_tpu_torch.components import Sink as SinkComponent
from pipe_tpu_torch.components import Source as SourceComponent
from pipe_tpu_torch.components import param_tensor
from pipe_tpu_torch.signal import Signal, SignalProperties


@dataclasses.dataclass
class Hooks:
    """Start/flush hook spies with error injection
    (``mock/mock.go:23-33,49-58``)."""

    started: bool = False
    flushed: bool = False
    error_on_start: Optional[Exception] = None
    error_on_flush: Optional[Exception] = None

    def start(self):
        self.started = True
        if self.error_on_start is not None:
            raise self.error_on_start

    def flush(self):
        self.flushed = True
        if self.error_on_flush is not None:
            raise self.error_on_flush


class _MockBase:
    """Shared mock plumbing: hook spies, mutation spy, fault injection."""

    def __init__(self, *, error_on_start=None, error_on_flush=None,
                 error_on_call=None, error_on_make=None):
        self.hooks = Hooks(error_on_start=error_on_start,
                           error_on_flush=error_on_flush)
        self.error_on_call = error_on_call
        self.error_on_make = error_on_make
        self.mutated = False
        self.context: mutable.Context = mutable.IMMUTABLE
        self._component = None

    @property
    def started(self) -> bool:
        return self.hooks.started

    @property
    def flushed(self) -> bool:
        return self.hooks.flushed

    def mock_mutation(self) -> mutable.Mutation:
        """A mutation that flips a host-side spy flag
        (``mock/mock.go:121-127``)."""

        def fn():
            self.mutated = True

        return self.context.mutate(fn)

    def _host_pre(self):
        if self.error_on_call is not None:
            raise self.error_on_call


class Source(_MockBase):
    """Constant-value generator with a frame limit
    (``mock/mock.go:61-109``).

    Produces ``value`` on every channel until ``limit`` frames have been
    generated; the final block is partial if ``limit % block_size != 0``;
    the next step reports EOF without a message — the reference's
    SourceFunc contract. ``interval`` sleeps on the host per block for
    timing tests (``mock/mock.go:66,93``).
    """

    def __init__(self, *, value: float = 0.0, channels: int = 1,
                 sample_rate: float = 44100.0, limit: Optional[int] = None,
                 interval: float = 0.0, error_on_call=None,
                 error_on_make=None, error_on_start=None,
                 error_on_flush=None):
        super().__init__(error_on_start=error_on_start,
                         error_on_flush=error_on_flush,
                         error_on_call=error_on_call,
                         error_on_make=error_on_make)
        self.value = value
        self.channels = channels
        self.sample_rate = sample_rate
        self.limit = limit
        self.interval = interval

    def source(self):
        """Returns a SourceAllocatorFunc (``mock/mock.go:76-109``)."""

        def alloc(mctx: mutable.Context, block_size: int) -> SourceComponent:
            if self.error_on_make is not None:
                raise self.error_on_make
            self.context = mctx
            limit, channels = self.limit, self.channels

            def step(state, params):
                produced = state["produced"]
                if limit is None:
                    read, eof = block_size, False
                else:
                    read = min(block_size, limit - produced)
                    eof = read <= 0
                    read = max(read, 0)
                value = params["value"]
                data = value.expand(channels, block_size).contiguous()
                new_state = {
                    "produced": produced + read,
                    "messages": state["messages"] + (1 if read > 0 else 0),
                }
                return new_state, Signal(data, read), eof

            host_pre = None
            if self.error_on_call is not None or self.interval > 0:

                def host_pre():
                    if self.interval > 0:
                        time.sleep(self.interval)
                    self._host_pre()

            comp = SourceComponent(
                output=SignalProperties(sample_rate=self.sample_rate,
                                        channels=channels),
                step=step,
                state={"produced": 0, "messages": 0},
                params={"value": param_tensor(self.value)},
                start=self.hooks.start,
                flush=self.hooks.flush,
                host_pre=host_pre,
            )
            self._component = comp
            return comp

        return alloc

    @property
    def messages(self) -> int:
        return int(self._component.state["messages"])

    @property
    def samples(self) -> int:
        return int(self._component.state["produced"])

    def reset(self) -> mutable.Mutation:
        """Mutation resetting the counters (``mock/mock.go:112-118``), used
        as a restart initializer."""

        def fn():
            self._component.update_state(lambda s: {k: 0 for k in s})

        return self.context.mutate(fn)

    def set_value(self, value: float) -> mutable.Mutation:
        """Mutation changing the generated value mid-stream."""

        def fn():
            cur = self._component.get_param("value")
            self._component.set_param("value", param_tensor(value, cur.device))

        return self.context.mutate(fn)


class Processor(_MockBase):
    """Pass-through processor counting frames (``mock/mock.go:130-157``)."""

    def __init__(self, *, error_on_call=None, error_on_make=None,
                 error_on_start=None, error_on_flush=None):
        super().__init__(error_on_start=error_on_start,
                         error_on_flush=error_on_flush,
                         error_on_call=error_on_call,
                         error_on_make=error_on_make)

    def processor(self):
        """Returns a ProcessorAllocatorFunc (``mock/mock.go:139-157``)."""

        def alloc(mctx: mutable.Context, block_size: int,
                  props: SignalProperties) -> ProcessorComponent:
            if self.error_on_make is not None:
                raise self.error_on_make
            self.context = mctx

            def step(state, params, sig: Signal):
                return {"messages": state["messages"] + 1,
                        "samples": state["samples"] + sig.frames}, sig

            comp = ProcessorComponent(
                output=props,
                step=step,
                state={"messages": 0, "samples": 0},
                params={},
                start=self.hooks.start,
                flush=self.hooks.flush,
                host_pre=self._host_pre if self.error_on_call is not None else None,
            )
            self._component = comp
            return comp

        return alloc

    @property
    def messages(self) -> int:
        return int(self._component.state["messages"])

    @property
    def samples(self) -> int:
        return int(self._component.state["samples"])


class Sink(_MockBase):
    """Capture-or-discard sink (``mock/mock.go:160-192``). Host-boundary:
    counters and captured values are host state."""

    def __init__(self, *, discard: bool = False, error_on_call=None,
                 error_on_make=None, error_on_start=None, error_on_flush=None):
        super().__init__(error_on_start=error_on_start,
                         error_on_flush=error_on_flush,
                         error_on_call=error_on_call,
                         error_on_make=error_on_make)
        self.discard = discard
        self.messages = 0
        self.samples = 0
        self._values: List[np.ndarray] = []

    def sink(self):
        """Returns a SinkAllocatorFunc (``mock/mock.go:170-192``)."""

        def alloc(mctx: mutable.Context, block_size: int,
                  props: SignalProperties) -> SinkComponent:
            if self.error_on_make is not None:
                raise self.error_on_make
            self.context = mctx

            def receive(block: np.ndarray):
                if self.error_on_call is not None:
                    raise self.error_on_call
                if not self.discard:
                    self._values.append(np.array(block))
                self.messages += 1
                self.samples += block.shape[1]

            comp = SinkComponent(receive=receive, start=self.hooks.start,
                                 flush=self.hooks.flush)
            self._component = comp
            return comp

        return alloc

    @property
    def values(self) -> np.ndarray:
        """Captured samples as ``(channels, total_frames)``."""
        if not self._values:
            return np.zeros((0, 0), dtype=np.float32)
        return np.concatenate(self._values, axis=1)

"""Graph construction — Lines and Routes (reference ``line.go``).

The PyTorch counterpart of :mod:`pipe_tpu.graph`. A :class:`Line` holds the
allocator functions of one source, zero or more processors and one sink.
:func:`make_route` runs the allocators in order, threading
:class:`SignalProperties` and the block width (``out_capacity``) from the
source to the sink, and wraps allocator failures with the stage name.

The port adds one thing to the threaded properties: the line's device. It
is resolved once per route (the ``device`` argument, else the device the
source declares, else ``torch.get_default_device()``) and stamped on every
``SignalProperties`` an allocator receives.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from pipe_tpu_torch import mutable
from pipe_tpu_torch.components import (
    Processor,
    ProcessorAllocatorFunc,
    Sink,
    SinkAllocatorFunc,
    Source,
    SourceAllocatorFunc,
)
from pipe_tpu_torch.errors import AllocationError
from pipe_tpu_torch.signal import SignalProperties


@dataclasses.dataclass
class Line:
    """Sequence of DSP component allocators (``line.go:14-19``)."""

    source: SourceAllocatorFunc
    sink: SinkAllocatorFunc
    processors: Sequence[ProcessorAllocatorFunc] = ()
    context: mutable.Context = mutable.IMMUTABLE


def Processors(*processors: ProcessorAllocatorFunc) -> List[ProcessorAllocatorFunc]:
    """Helper for line literals (``pipe.go:367-370``)."""
    return list(processors)


@dataclasses.dataclass
class Route:
    """A bound line: allocated components ready to execute
    (``line.go:44-49``), and the device its stream lives on."""

    context: mutable.Context
    source: Source
    processors: List[Processor]
    sink: Sink
    device: torch.device

    def components(self):
        return [self.source, *self.processors, self.sink]


def component_context(line_ctx: mutable.Context) -> mutable.Context:
    """Sync lines share the line context; async components each get a fresh
    one (``line.go:160-165``)."""
    if line_ctx.is_mutable():
        return line_ctx
    return mutable.mutable()


def _on(props: SignalProperties, device: torch.device) -> SignalProperties:
    if props.device == device:
        return props
    return dataclasses.replace(props, device=device)


def make_route(line: Line, block_size: int, device=None) -> Route:
    """Run the allocators in order, threading signal properties and block
    width (``line.go:62-90``). Raises :class:`AllocationError` naming the
    stage."""
    ctx = component_context(line.context)
    try:
        source = line.source(ctx, block_size)
    except Exception as e:
        raise AllocationError(f"source: {e}") from e
    source.context = ctx
    if device is not None:
        dev = torch.device(device)
    elif source.output.device is not None:
        dev = torch.device(source.output.device)
    else:
        dev = torch.get_default_device()
    props = _on(source.output, dev)

    processors: List[Processor] = []
    width = block_size
    for alloc in line.processors:
        ctx = component_context(line.context)
        try:
            proc = alloc(ctx, width, props)
        except Exception as e:
            raise AllocationError(f"processor: {e}") from e
        proc.context = ctx
        props = _on(proc.output, dev)
        if proc.out_capacity is not None:
            width = proc.out_capacity
        processors.append(proc)

    ctx = component_context(line.context)
    try:
        sink = line.sink(ctx, width, props)
    except Exception as e:
        raise AllocationError(f"sink: {e}") from e
    sink.context = ctx

    return Route(
        context=line.context,
        source=source,
        processors=processors,
        sink=sink,
        device=dev,
    )

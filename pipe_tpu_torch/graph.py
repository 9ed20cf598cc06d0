"""Graph construction — Lines and Routes (reference ``line.go``).

The PyTorch counterpart of :mod:`pipe_tpu.graph`. A :class:`Line` holds the
allocator functions of one source, zero or more processors and one sink.
:func:`make_route` runs the allocators in order, threading
:class:`SignalProperties` and the block width (``out_capacity``) from the
source to the sink, and wraps allocator failures with the stage name.

The port adds one thing to the threaded properties: the line's device. It
is resolved once per route (the ``device`` argument, else the device the
source declares, else ``pipe_tpu_torch.config.default_device()``: the
card, unless the CPU was asked for with ``set_default_device("cpu")``) and
stamped on every ``SignalProperties`` an allocator receives or returns,
including those of components re-allocated by live surgery.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from pipe_tpu_torch import mutable
from pipe_tpu_torch.config import default_device
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
from pipe_tpu_torch.tree import tree_map


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
    # The allocator funcs the components came from, kept so live surgery
    # can re-allocate downstream stages when a width-changing processor is
    # inserted (``pipe.go:297-312``; the reference's buffers are
    # per-message, the port's shapes are fixed per allocation).
    proc_allocs: List[ProcessorAllocatorFunc] = dataclasses.field(
        default_factory=list
    )
    sink_alloc: Optional[SinkAllocatorFunc] = None

    def components(self):
        return [self.source, *self.processors, self.sink]

    def prev_props(self, pos: int) -> SignalProperties:
        """Output properties of the component preceding processor slot
        ``pos`` (``line.go:120-126``) — used by live InsertProcessor."""
        if pos == 0:
            return self.source.output
        return self.processors[pos - 1].output

    def prev_capacity(self, pos: int, block_size: int) -> int:
        """Input block width at processor slot ``pos``: the pipe block
        threaded through any upstream width-changing ops."""
        width = block_size
        for proc in self.processors[:pos]:
            if proc.out_capacity is not None:
                width = proc.out_capacity
        return width


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


def allocate_source(alloc: SourceAllocatorFunc, ctx: mutable.Context,
                    block_size: int) -> Source:
    src = alloc(ctx, block_size)
    src.context = ctx
    return src


def allocate_processor(alloc: ProcessorAllocatorFunc, ctx: mutable.Context,
                       block_size: int, input_props: SignalProperties,
                       device: torch.device) -> Processor:
    """Allocate one processor on ``device`` (stamped on its input and
    output properties)."""
    proc = alloc(ctx, block_size, _on(input_props, device))
    proc.context = ctx
    proc.output = _on(proc.output, device)
    return proc


def allocate_sink(alloc: SinkAllocatorFunc, ctx: mutable.Context,
                  block_size: int, input_props: SignalProperties,
                  device: torch.device) -> Sink:
    sink = alloc(ctx, block_size, _on(input_props, device))
    sink.context = ctx
    return sink


def make_route(line: Line, block_size: int, device=None) -> Route:
    """Run the allocators in order, threading signal properties and block
    width (``line.go:62-90``). Raises :class:`AllocationError` naming the
    stage."""
    try:
        source = allocate_source(line.source, component_context(line.context),
                                 block_size)
    except Exception as e:
        raise AllocationError(f"source: {e}") from e
    if device is not None:
        dev = torch.device(device)
    elif source.output.device is not None:
        dev = torch.device(source.output.device)
    else:
        dev = default_device()
    source.output = _on(source.output, dev)
    # a source allocator is not told the device: move its tensors there
    to_dev = lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x  # noqa: E731
    source.state = tree_map(to_dev, source.state)
    source.params = tree_map(to_dev, source.params)
    props = source.output

    processors: List[Processor] = []
    width = block_size
    for alloc in line.processors:
        try:
            proc = allocate_processor(alloc, component_context(line.context),
                                      width, props, dev)
        except Exception as e:
            raise AllocationError(f"processor: {e}") from e
        props = proc.output
        if proc.out_capacity is not None:
            width = proc.out_capacity
        processors.append(proc)

    try:
        sink = allocate_sink(line.sink, component_context(line.context),
                             width, props, dev)
    except Exception as e:
        raise AllocationError(f"sink: {e}") from e

    return Route(
        context=line.context,
        source=source,
        processors=processors,
        sink=sink,
        device=dev,
        proc_allocs=list(line.processors),
        sink_alloc=line.sink,
    )

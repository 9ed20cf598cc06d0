"""pipe_tpu_torch — the streaming DSP pipeline framework of :mod:`pipe_tpu`,
ported to PyTorch and CUDA.

A pipeline is a graph of *lines*; each line is ``Source -> [0..n
Processors] -> Sink`` operating on fixed-size float32 time-blocks, with the
same components, lifecycle hooks and mutation control plane as the JAX
package. Components are step functions over trees of tensors
``(state, params, signal) -> (state, signal)``, called eagerly once per
block on the line's device. The biquad recurrence runs in a CUDA kernel
written for Hopper (``pipe_tpu_torch/csrc/``); the other ops are PyTorch
operations pinned to IEEE FP32.

This package imports no JAX. Ported so far: the whole op kit of
:mod:`pipe_tpu.ops` (FIR, polyphase resampler, biquad EQ in float32 and
double-f32, gain, mix, overlap-save convolution, delay/compressor/gate,
STFT gain and gate, channelizer, oscillator and demodulators, and the
fused stages), the fusion optimizer (``optimize.fuse``, ``optimize=True``),
the flagship chunk function, the runtime (the blocking ``run`` driver and
the async ``Pipe`` with live ``push``/``at_block``, ``insert_processor``
and ``add_line``, ``lookahead`` and ``batch_blocks``), the ``mock`` test
kit, ``StatsRecorder``/``trace``, ``process`` and ``checkpoint``, WAV file
I/O (``WavSource``/``WavSink`` over the native ring and codec), the
``'high'`` (3xTF32) and ``'mixed'`` precisions, and of ``parallel`` the mesh, the halo
primitives and the ``ShardedChain`` with the stages of the sharded main
path and the EQ, one process per shard over ``torch.distributed``.
"""

from pipe_tpu_torch.signal import (
    Signal,
    SignalProperties,
    silence,
    from_array,
)
from pipe_tpu_torch import mutable
from pipe_tpu_torch.errors import (
    PipeError,
    AllocationError,
    StartError,
    FlushError,
    RunError,
    ErrorRun,
)
from pipe_tpu_torch.components import (
    Source,
    Processor,
    Sink,
    SourceAllocatorFunc,
    ProcessorAllocatorFunc,
    SinkAllocatorFunc,
)
from pipe_tpu_torch.graph import Line, Processors
from pipe_tpu_torch.runtime import Pipe, run, wait
from pipe_tpu_torch.profiling import StatsRecorder, trace
from pipe_tpu_torch.offline import process
from pipe_tpu_torch.io import WavSource, WavSink
from pipe_tpu_torch import checkpoint, config, mock, optimize
from pipe_tpu_torch.config import default_device, set_default_device

__version__ = "0.1.0"

__all__ = [
    "config",
    "default_device",
    "set_default_device",
    "checkpoint",
    "mock",
    "optimize",
    "Signal",
    "SignalProperties",
    "silence",
    "from_array",
    "mutable",
    "PipeError",
    "AllocationError",
    "StartError",
    "FlushError",
    "RunError",
    "ErrorRun",
    "Source",
    "Processor",
    "Sink",
    "SourceAllocatorFunc",
    "ProcessorAllocatorFunc",
    "SinkAllocatorFunc",
    "Line",
    "Processors",
    "Pipe",
    "run",
    "wait",
    "StatsRecorder",
    "trace",
    "process",
    "WavSource",
    "WavSink",
]

"""Offline (array-in, array-out) processing convenience.

The PyTorch counterpart of :mod:`pipe_tpu.offline`: runs a processor chain
over a whole in-memory signal with the same components, states and block
protocol as the streaming runtime:

    y = pipe_tpu_torch.process(x, [fir.processor(), rs.processor()],
                               block_size=4096, device="cuda")
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pipe_tpu_torch.components import Sink, Source
from pipe_tpu_torch.config import resolve_device
from pipe_tpu_torch.graph import Line
from pipe_tpu_torch.runtime.driver import run
from pipe_tpu_torch.signal import Signal, SignalProperties


def process(x, processors: Sequence, block_size: int = 4096,
            sample_rate: float = 44100.0, lookahead: int = 8,
            device=None) -> np.ndarray:
    """Run ``(channels, N)`` samples through a processor chain on
    ``device`` (``None``: :func:`pipe_tpu_torch.config.default_device`, the
    card unless the CPU was asked for); returns the processed ``(channels, M)`` array (M differs
    when rates change). The source holds the whole array on the device and
    its read position as a host int, so no block syncs."""
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[None, :]
    C, total = x.shape
    dev = resolve_device(device)

    def src_alloc(mctx, block):
        padded = torch.zeros((C, total + block), dtype=torch.float32, device=dev)
        padded[:, :total] = torch.from_numpy(x).to(dev)

        def step(state, params):
            pos = state["pos"]
            read = max(0, min(block, total - pos))
            return ({"pos": pos + read}, Signal(padded[:, pos: pos + block], read),
                    read <= 0)

        return Source(
            output=SignalProperties(sample_rate=sample_rate, channels=C,
                                    device=dev),
            step=step,
            state={"pos": 0},
            params={},
        )

    captured: list = []

    def sink_alloc(mctx, block, props):
        return Sink(receive=captured.append)

    run(block_size,
        Line(source=src_alloc, processors=list(processors), sink=sink_alloc),
        lookahead=lookahead, device=dev)
    if not captured:
        return np.zeros((C, 0), np.float32)
    return np.concatenate(captured, axis=1)

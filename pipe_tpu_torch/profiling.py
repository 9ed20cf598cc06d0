"""Observability — per-block timing stats and profiler traces.

The PyTorch counterpart of :mod:`pipe_tpu.profiling`. The stats plane is
opt-in and adds no device sync:

- :class:`StatsRecorder` counts blocks and wall time per line executor on
  the host clock (no ``frames`` readback, which would sync per block).
- :func:`trace` wraps ``torch.profiler.profile`` (CPU and, where a card is
  present, CUDA activity) and writes a Chrome trace into ``logdir``.

Usage::

    stats = pipe_tpu_torch.StatsRecorder()
    pipe_tpu_torch.run(512, line, stats=stats)
    print(stats.report())
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, Iterator, Optional


@dataclasses.dataclass
class LineStats:
    """Counters for one line executor (host-observed)."""

    blocks: int = 0
    wall_s: float = 0.0
    block_size: int = 0
    channels: int = 0
    started_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def frames(self) -> int:
        """Upper bound: blocks x block_size (the final partial block counts
        full — exact frame counts live in sink counters)."""
        return self.blocks * self.block_size

    @property
    def samples_per_s(self) -> float:
        if self.wall_s <= 0:
            return 0.0
        return self.frames * max(self.channels, 1) / self.wall_s

    @property
    def mean_block_ms(self) -> float:
        if self.blocks == 0:
            return 0.0
        return 1e3 * self.wall_s / self.blocks


class StatsRecorder:
    """Thread-safe registry of per-line stats. Pass to ``run`` or
    ``Pipe(..., stats=...)``; zero overhead when absent."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lines: Dict[str, LineStats] = {}

    def line(self, name: str, block_size: int, channels: int) -> LineStats:
        with self._lock:
            ls = self._lines.get(name)
            if ls is None:
                ls = LineStats(block_size=block_size, channels=channels)
                self._lines[name] = ls
            return ls

    @property
    def lines(self) -> Dict[str, LineStats]:
        with self._lock:
            return dict(self._lines)

    @property
    def total_blocks(self) -> int:
        return sum(ls.blocks for ls in self.lines.values())

    def report(self) -> str:
        """Human-readable per-line summary."""
        rows = []
        for name, ls in sorted(self.lines.items()):
            rows.append(
                f"{name}: {ls.blocks} blocks x {ls.block_size} frames "
                f"x {ls.channels}ch, {ls.wall_s*1e3:.1f} ms total, "
                f"{ls.mean_block_ms:.3f} ms/block, "
                f"{ls.samples_per_s/1e6:.2f} Msamples/s"
            )
        return "\n".join(rows) if rows else "(no blocks recorded)"


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[object]:
    """Profile the enclosed stream section with ``torch.profiler`` (CPU
    activity, plus CUDA activity when a card is present) and write
    ``trace.json`` (Chrome trace format) into ``logdir``. Yields the
    profiler, whose ``key_averages()`` sums time by op and kernel."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(str(logdir), "trace.json"))


class _Timer:
    """Context helper used by the executor hot path."""

    __slots__ = ("stats", "_t0")

    def __init__(self, stats: Optional[LineStats]):
        self.stats = stats
        self._t0 = 0.0

    def __enter__(self):
        if self.stats is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        s = self.stats
        if s is not None:
            now = time.perf_counter()
            s.wall_s += now - self._t0
            s.blocks += 1
            if s.started_at is None:
                s.started_at = self._t0
            s.finished_at = now
        return False

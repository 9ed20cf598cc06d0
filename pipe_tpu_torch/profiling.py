"""Observability — spans and counters of the executor, the ops and the push
path, and profiler traces.

The PyTorch counterpart of :mod:`pipe_tpu.profiling`. The stats plane is
opt-in: a :class:`StatsRecorder` passed as ``stats=`` to ``run`` or ``Pipe``
turns it on, and without one every span site is a single ``is None`` test.

- :class:`StatsRecorder` records spans on the host clock
  (``time.perf_counter``) where the host does the work: a line's
  ``execute`` (one dispatch) and inside it the feed, the staging copies,
  each op's step, the wait on the oldest block's event and the receive; a
  push's ``push``, ``deliver`` and ``mutate``. It keeps counters at the same
  sites, and prints them with :meth:`StatsRecorder.report`. A span makes no
  CUDA call, no profiler range and no file: spans go into bounded rings in
  memory (:data:`SPAN_RING`), read after the run (:meth:`StatsRecorder.spans`,
  :meth:`StatsRecorder.timeline`).
- :func:`trace` wraps ``torch.profiler.profile`` (CPU and, where a card is
  present, CUDA activity) and writes a Chrome trace into ``logdir``.

Usage::

    stats = pipe_tpu_torch.StatsRecorder()
    pipe_tpu_torch.run(512, line, stats=stats)
    print(stats.report())
    stats.timeline().self_time()   # seconds by span name, self time
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

from pipe_tpu_torch import mutable

clock = time.perf_counter

#: Spans each ring keeps, oldest dropped first: one ring per line, one for
#: the push path. A four-op line records about 13 spans a block, so a ring
#: holds its last ~1,200 blocks, in about 3 MB.
SPAN_RING = 16384

#: The span names of the executor's staging copies.
STAGING = ("stage_in", "upload", "stage_out", "copy_out")


class Span(NamedTuple):
    """One span on the host clock. ``parent`` is the ``id`` of the span that
    caused it (``execute`` for the spans inside a dispatch; None for a
    root); ``block`` the stream index of the block it serves (``execute``:
    the dispatch's first; ``mutate``: the block it landed before);
    ``request`` the push id that a push's ``push``, ``deliver`` and
    ``mutate`` spans share; ``cover`` the time its child spans cover;
    ``line`` the line whose thread recorded it (the executor's name for
    ``mutate``, None for ``push`` and ``deliver``)."""

    name: str
    start: float
    end: float
    id: int
    parent: Optional[int]
    block: Optional[int]
    request: Optional[int]
    cover: float
    line: Optional[str]

    @property
    def self_s(self) -> float:
        """The span's duration less what its child spans cover."""
        return self.end - self.start - self.cover


class LineStats:
    """Counters and spans of one line executor. Written by the line's
    thread alone (one recorder serves one pipe)."""

    def __init__(self, name: str, block_size: int, channels: int, ids):
        self.name = name
        self.block_size = block_size
        self.channels = channels
        self.blocks = 0  # blocks dispatched; a call that finds EOF counts one
        self.wall_s = 0.0  # time inside execute
        self.pinned_allocs = 0  # pinned host buffers made (staging in and out)
        self.seconds: Dict[str, float] = {}  # self time by span name, whole run
        self._op_names: Dict[object, str] = {}
        self._ring = collections.deque(maxlen=SPAN_RING)
        self._ids = ids
        self._root: Optional[int] = None  # the open execute span's id
        self._cover = 0.0

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

    def open(self) -> float:
        """Open the ``execute`` span of one dispatch; returns its start."""
        self._root = next(self._ids)
        self._cover = 0.0
        return clock()

    def close(self, t0: float, first: int, last: int) -> None:
        """Close the ``execute`` span opened at ``t0``, which dispatched
        blocks ``[first, last)``."""
        t1 = clock()
        d = t1 - t0
        self._ring.append(("execute", t0, t1, self._root, None, first, None,
                           self._cover))
        self._add("execute", d - self._cover)
        self.wall_s += d
        self.blocks += max(1, last - first)
        self._root = None

    def span(self, name: str, t0: float, block: Optional[int] = None) -> None:
        """Record a span that started at ``t0`` and ends now, a child of the
        open ``execute`` span (a root outside one: the flush's drain)."""
        t1 = clock()
        self._ring.append((name, t0, t1, next(self._ids), self._root, block,
                           None, 0.0))
        self._cover += t1 - t0
        self._add(name, t1 - t0)

    def _add(self, name: str, s: float) -> None:
        self.seconds[name] = self.seconds.get(name, 0.0) + s

    def op_name(self, step) -> str:
        """``op.<Op>``, the span name of a processor's step: the first part
        of its qualified name, which for the op kit is the op's class
        (``FIR.processor.<locals>.alloc.<locals>.step`` gives ``op.FIR``)."""
        name = self._op_names.get(step)
        if name is None:
            qual = getattr(step, "__qualname__", type(step).__name__)
            name = self._op_names[step] = "op." + qual.split(".", 1)[0]
        return name

    def spans(self) -> List[Span]:
        return [Span(*t, self.name) for t in list(self._ring)]

    def report(self) -> str:
        per = 1e3 / self.blocks if self.blocks else 0.0
        parts = {"self": 0.0, "feed": 0.0, "staging": 0.0, "ops": 0.0,
                 "wait": 0.0, "receive": 0.0}
        for k, v in self.seconds.items():
            part = ("self" if k == "execute" else "staging" if k in STAGING
                    else "ops" if k.startswith("op.") else k)
            parts[part] = parts.get(part, 0.0) + v
        return (
            f"{self.name}: {self.blocks} blocks x {self.block_size} frames "
            f"x {self.channels}ch, {self.wall_s * 1e3:.1f} ms total, "
            f"{self.mean_block_ms:.3f} ms/block: "
            + ", ".join(f"{k} {v * per:.3f}" for k, v in parts.items())
            + f"; {self.samples_per_s / 1e6:.2f} Msamples/s, "
            f"{self.pinned_allocs} pinned buffers made"
        )


class _Landing:
    """The ``mutate`` span open on a thread: the block it lands before and
    the push ids that landed in it."""

    __slots__ = ("block", "requests")

    def __init__(self, block: int):
        self.block = block
        self.requests: List[int] = []


class StatsRecorder:
    """Spans and counters of a pipe's lines and of its push path. Pass to
    ``run`` or ``Pipe(..., stats=...)``; without one the hot path records
    nothing."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lines: Dict[str, LineStats] = {}
        self._ids = itertools.count()
        self._push_ring = collections.deque(maxlen=SPAN_RING)
        self._landing = threading.local()
        self.pushes = 0
        self.late_targets = 0  # pushes whose target had passed: next block
        self.push_seconds: Dict[str, float] = {}  # push, deliver, mutate

    def line(self, name: str, block_size: int, channels: int) -> LineStats:
        with self._lock:
            ls = self._lines.get(name)
            if ls is None:
                ls = LineStats(name, block_size, channels, self._ids)
                self._lines[name] = ls
            return ls

    @property
    def lines(self) -> Dict[str, LineStats]:
        with self._lock:
            return dict(self._lines)

    @property
    def total_blocks(self) -> int:
        return sum(ls.blocks for ls in self.lines.values())

    # -- the push path ------------------------------------------------------

    def new_push(self) -> int:
        with self._lock:
            self.pushes += 1
        return next(self._ids)

    def tagged(self, mutations, request: int, at_block: Optional[int]):
        """The mutations of push ``request``, each telling the ``mutate``
        span it runs in that this push landed (and whether its target
        ``at_block``, on the executor's dispatch grid, had passed)."""

        def tag(m):
            def fn():
                self._landed(request, at_block)
                m.apply()

            return mutable.Mutation(m.context, fn)

        return [tag(m) for m in mutations]

    def _landed(self, request: int, at_block: Optional[int]) -> None:
        cur = getattr(self._landing, "current", None)
        if cur is None or request in cur.requests:
            return  # a pipe-context mutation, applied by the control thread
        cur.requests.append(request)
        if at_block is not None and at_block < cur.block:
            with self._lock:
                self.late_targets += 1

    def push_span(self, name: str, t0: float, request: Optional[int],
                  line: Optional[str] = None, block: Optional[int] = None) -> None:
        """Record a ``push`` or ``deliver`` span that started at ``t0``."""
        t1 = clock()
        self._push_ring.append((name, t0, t1, next(self._ids), None, block,
                                request, 0.0, line))
        with self._lock:
            self.push_seconds[name] = self.push_seconds.get(name, 0.0) + t1 - t0

    @contextlib.contextmanager
    def mutating(self, line: str, block: int):
        """The ``mutate`` span of the mutations that executor ``line``
        applies before dispatching ``block``; it carries the id of the
        first push that landed in it (None: surgery's adoption)."""
        t0 = clock()
        cur = self._landing.current = _Landing(block)
        try:
            yield
        finally:
            self._landing.current = None
            self.push_span("mutate", t0, cur.requests[0] if cur.requests else None,
                           line, block)

    # -- reading ------------------------------------------------------------

    def spans(self) -> List[Span]:
        """Every span the rings hold, by start."""
        out = [Span(*t) for t in list(self._push_ring)]
        for ls in self.lines.values():
            out += ls.spans()
        return sorted(out, key=lambda s: s.start)

    def timeline(self) -> "Timeline":
        return Timeline(self.spans())

    def report(self) -> str:
        """Human-readable summary: per line its blocks, time in execute and
        that time a block split into self (the executor's own Python),
        feed, staging copies, ops, wait and receive; then the push path."""
        rows = [ls.report() for _, ls in sorted(self.lines.items())]
        if self.pushes:
            s = self.push_seconds
            rows.append(
                f"push path: {self.pushes} pushes, {self.late_targets} late: "
                + ", ".join(f"{k} {s.get(k, 0.0) * 1e3 / self.pushes:.3f}"
                            for k in ("push", "deliver", "mutate"))
                + " ms a push")
        return "\n".join(rows) if rows else "(no blocks recorded)"


class Timeline:
    """Where each span was innermost: every span's interval less its child
    spans', as pieces per thread (a line's; the push path's), searchable by
    interval. A span whose children the ring already dropped is left out."""

    def __init__(self, spans: List[Span]):
        kids: Dict[int, List[Span]] = {}
        for s in spans:
            if s.parent is not None:
                kids.setdefault(s.parent, []).append(s)
        lanes: Dict[Optional[str], list] = {}
        for s in spans:
            ch = sorted(kids.get(s.id, ()), key=lambda c: c.start)
            if sum(c.end - c.start for c in ch) < s.cover * (1 - 1e-9) - 1e-9:
                continue
            pieces = lanes.setdefault(s.line, [])
            t = s.start
            for c in ch:
                if c.start > t:
                    pieces.append((t, c.start, s.name))
                t = max(t, c.end)
            if s.end > t:
                pieces.append((t, s.end, s.name))
        # per lane, pieces by start and the running latest end: the pieces
        # before the first whose running end passes ``lo`` all end by ``lo``
        self._lanes = []
        for pieces in lanes.values():
            pieces.sort()
            self._lanes.append((pieces, list(itertools.accumulate(
                (p[1] for p in pieces), max))))

    def self_time(self, lo: float = float("-inf"),
                  hi: float = float("inf")) -> Dict[str, float]:
        """Seconds of ``[lo, hi]`` in which each span name was innermost on
        its thread: a span's self time, clipped to the interval. Threads
        that overlap in time each count."""
        out: Dict[str, float] = {}
        for pieces, ends in self._lanes:
            i = bisect.bisect_right(ends, lo)
            while i < len(pieces) and pieces[i][0] < hi:
                a, b, name = pieces[i]
                c = min(b, hi) - max(a, lo)
                if c > 0:
                    out[name] = out.get(name, 0.0) + c
                i += 1
        return out


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

"""The one traffic generator: it reads a mix's parameters and drives a
``Pipe`` with them.

- ``"loop": "closed"``: the feed hands over the next block at once (a
  renderer that reads as fast as the card takes it), until the window's
  deadline.
- ``"loop": "open"``: a generator thread queues block k at the moment its last
  sample exists in real time, ``t0 + (k + 1) * block / rate``, on a schedule
  that does not slow when the program does; the feed waits for it, or takes
  the oldest queued block where the program is behind. Every block due in
  the window is delivered, however late. ``"pushes"`` retunes the chain
  ``ahead_blocks`` before every landing block that is a multiple of
  ``every_blocks``.

The input is a seeded host buffer of a whole number of blocks, cycled. The
recorder times every feed and receive call on the host clock and keeps the
outputs of the stretches that the check compares.
"""

from __future__ import annotations

import collections
import queue
import threading
import time

import numpy as np

clock = time.perf_counter


class Stream:
    """The input stream: ``x`` (C, n) cycled, served in blocks."""

    def __init__(self, x: np.ndarray, block: int):
        if x.shape[1] % block:
            raise ValueError("the buffer must hold a whole number of blocks")
        self.x, self.block_frames = x, block
        self.n_buf = x.shape[1] // block

    def block(self, k: int) -> np.ndarray:
        i = k % self.n_buf
        return self.x[:, i * self.block_frames:(i + 1) * self.block_frames]

    def frames(self, start: int, stop: int) -> np.ndarray:
        """Frames ``[start, stop)`` of the stream (C, stop - start)."""
        n = self.x.shape[1]
        idx = np.arange(start, stop) % n
        return self.x[:, idx]


class Recorder:
    """Host times of every block, the kept outputs, and the spans of the
    harness's own calls into the program (feed, receive, push)."""

    def __init__(self, check: dict, seed: int):
        self.stretch = check["stretch_blocks"]
        self.period = check["period_blocks"]
        self.offset = int(np.random.default_rng([seed, 3]).integers(
            self.stretch, self.period - self.stretch + 1))
        # host times, plain floats (nothing for the garbage collector to scan):
        # a feed call's entry and return, a receive call's entry and return
        self.t_feed_call: list = []
        self.t_fed: list = []
        self.t_recv: list = []
        self.t_recv_done: list = []
        self.t_due: list = []
        self.push_spans: list = []
        self.kept: dict = {}
        self.last = collections.deque(maxlen=self.stretch)
        self.frames_recv = 0
        self.pushes = 0

    @property
    def n_fed(self) -> int:
        return len(self.t_fed)

    @property
    def n_recv(self) -> int:
        return len(self.t_recv)

    def keeps(self, k: int) -> bool:
        return k < self.stretch or (self.offset <= k % self.period
                                    < self.offset + self.stretch)

    def receive(self, out: np.ndarray) -> None:
        t = clock()
        k = len(self.t_recv)
        self.t_recv.append(t)
        self.frames_recv += out.shape[1]
        if self.keeps(k):
            self.kept[k] = out
        self.last.append((k, out))
        self.t_recv_done.append(clock())

    def spans(self, lo: float, hi: float) -> list:
        """``(name, start, end)`` of the harness's calls into the program
        that overlap ``[lo, hi]`` (host clock)."""
        out = []
        for name, starts, ends in (("feed", self.t_feed_call, self.t_fed),
                                   ("receive", self.t_recv, self.t_recv_done)):
            out += [(name, a, b) for a, b in zip(starts, ends) if b >= lo and a <= hi]
        return out + [("push", a, b) for a, b in self.push_spans if b >= lo and a <= hi]

    def stretches(self) -> tuple:
        """The complete kept stretches, each ``(first block, [outputs])``:
        the stream's first, the periodic ones, and the last received (None
        where it is one of the others)."""
        def stretch(k):
            run = [self.kept.get(j) for j in range(k, k + self.stretch)]
            return (k, run) if all(r is not None for r in run) else None

        first = stretch(0)
        periodic = [s for s in map(stretch, range(self.offset, self.n_recv, self.period)) if s]
        last = None
        if len(self.last) == self.stretch:
            k = self.last[0][0]
            if k != 0 and all(k != s[0] for s in periodic):
                last = (k, [o for _, o in self.last])
        return first, periodic, last


def _pace_until(t: float) -> None:
    while True:
        left = t - clock()
        if left <= 0:
            return
        time.sleep(min(left, 0.05) if left > 0.002 else left / 2)


class Feeder:
    """Feeds a pipe with one traffic mix: its ``feed_*`` method is the pipe's
    source feed, ``rec.receive`` its sink; ``retune(landing)`` gives the
    mutation of a push."""

    def __init__(self, traffic: dict, stream: Stream, rate_hz: float, recorder: Recorder):
        self.t, self.stream, self.rate, self.rec = traffic, stream, rate_hz, recorder
        self.retune = None  # set with the pipe: landing -> mutation
        self.pipe = None
        self.deadline = None
        self.n_total = None  # the stream's length in blocks: the warm-up's, the open loop's
        self._q: queue.Queue = queue.Queue()
        self.late_s: list = []  # how late the open-loop generator queued each block

    # -- feeds (called on the executor thread) ------------------------------

    def feed_closed(self, n: int):
        t = clock()
        k = self.rec.n_fed
        if t >= self.deadline:
            return None
        self.rec.t_feed_call.append(t)
        self.rec.t_fed.append(clock())
        return self.stream.block(k)

    def feed_open(self, n: int):
        t = clock()
        k = self._q.get()
        if k is None:
            return None
        self.rec.t_feed_call.append(t)
        self.rec.t_fed.append(clock())
        return self.stream.block(k)

    def feed_warmup(self, n: int):
        """Unpaced warm-up feed that also exercises the push path."""
        k = self.rec.n_fed
        if k >= self.n_total:
            return None
        self._push_for(k)
        self.rec.t_feed_call.append(clock())
        self.rec.t_fed.append(self.rec.t_feed_call[-1])
        return self.stream.block(k)

    # -- pushes ---------------------------------------------------------------

    def _push_for(self, k: int) -> None:
        p = self.t.get("pushes")
        if not p or self.retune is None:
            return
        target = k + p["ahead_blocks"]
        if target % p["every_blocks"] == 0 and (self.n_total is None
                                                or target < self.n_total):
            t = clock()
            self.pipe.push(self.retune(target // p["every_blocks"]), at_block=target)
            self.rec.pushes += 1
            self.rec.push_spans.append((t, clock()))

    # -- the window -------------------------------------------------------------

    def block_period(self) -> float:
        return self.stream.block_frames / self.rate

    def generate(self, t0: float, n: int) -> None:
        """Open loop: queue block k at its due time, push ahead of landings."""
        period = self.block_period()
        for k in range(n):
            due = t0 + (k + 1) * period
            _pace_until(due)
            self.rec.t_due.append(due)
            self.late_s.append(clock() - due)
            self._q.put(k)
            self._push_for(k)
        self._q.put(None)

    def run(self, pipe, seconds: float, timeout: float) -> tuple:
        """Run the window on a built, unstarted ``pipe``; returns the host
        times (t0, t1) of its start and of the last output's arrival, the
        device synchronized. In the open loop that is the last due block's
        output, which comes after ``seconds`` where the program is behind."""
        import torch

        self.pipe = pipe
        gen = None
        t0 = clock()
        if self.t["loop"] == "open":
            # the blocks whose last sample exists within the window
            n = self.n_total = int(seconds * self.rate / self.stream.block_frames + 1e-9)
            gen = threading.Thread(target=self.generate, args=(t0, n),
                                   name="portbench-generator", daemon=True)
        else:
            self.deadline = t0 + seconds
        pipe.start()
        if gen is not None:
            gen.start()
        try:
            pipe.wait(timeout)
        finally:
            if gen is not None:
                gen.join(timeout)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return t0, clock()

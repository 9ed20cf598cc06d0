"""File I/O components: the data-loader edge of the pipeline.

The counterpart of :mod:`pipe_tpu.io` on the port's components.

``WavSource`` streams a WAV file into the pipe through the native reader
(``native/wavio.cpp``) with a *prefetch thread*: disk reads run ahead of
the device stream, filling a lock-free SPSC ring (``native/ringbuf.cpp``),
and the component's ``feed`` callback only pops ready frames, so the block
dispatcher never waits on disk unless the reader falls behind. ``feed``
returns a host ``(channels, frames)`` float32 array, which the executor
stages to the card through its pinned buffers. It returns whole blocks
until the file ends (the last one may be short), so where the blocks fall
does not depend on how far ahead the reader is.

``WavSink`` writes the stream back to a WAV file through the native writer
on a background thread fed by a second ring, so file writes overlap with
compute. ``receive`` gets the executor's host copy of each block's valid
frames, ``(channels, frames)``.

Both fall back to pure Python (stdlib ``wave``) when no C++ toolchain is
present (:func:`pipe_tpu_torch.native.available`).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from pipe_tpu_torch import native
from pipe_tpu_torch.components import Sink as SinkComponent
from pipe_tpu_torch.components import Source as SourceComponent
from pipe_tpu_torch.signal import SignalProperties


class WavSource:
    """Streaming WAV file source with native prefetch.

    Args:
      path: WAV file (PCM16/24/32 or float32).
      prefetch_blocks: ring capacity in blocks (read-ahead depth).
    """

    def __init__(self, path: str, prefetch_blocks: int = 8):
        self.path = str(path)
        self.prefetch_blocks = prefetch_blocks
        rdr = native.WavReader(self.path)  # validate eagerly
        self.channels = rdr.channels
        self.sample_rate = rdr.sample_rate
        self.total_frames = rdr.total_frames
        rdr.close()
        self._thread: Optional[threading.Thread] = None
        self._ring: Optional[native.RingBuffer] = None
        self._stop = threading.Event()

    def source(self):
        def alloc(mctx, block_size: int) -> SourceComponent:
            ring = native.RingBuffer(
                max(self.prefetch_blocks, 2) * block_size, self.channels
            )
            self._ring = ring
            stop = self._stop

            def reader():
                rdr = native.WavReader(self.path)
                try:
                    while not stop.is_set():
                        chunk = rdr.read(block_size)
                        if chunk.shape[0] == 0:
                            break
                        # busy-backoff when the ring is full
                        pushed = 0
                        while pushed < chunk.shape[0] and not stop.is_set():
                            n = ring.push(chunk[pushed:])
                            if n == 0:
                                time.sleep(0.0005)
                            pushed += n
                finally:
                    rdr.close()
                    ring.close()

            def start():
                self._stop.clear()
                self._thread = threading.Thread(
                    target=reader, name="wav-prefetch", daemon=True
                )
                self._thread.start()

            def flush():
                stop.set()
                if self._thread is not None:
                    self._thread.join(timeout=5)
                    self._thread = None

            def feed(n: int) -> Optional[np.ndarray]:
                # n frames, waiting while the reader is behind; fewer only
                # when the file has ended (or the run was cancelled)
                parts, have = [], 0
                while have < n:
                    closed = ring.closed  # read before the pop: no lost tail
                    got = ring.pop(n - have)
                    if got.shape[0] > 0:
                        parts.append(got)
                        have += got.shape[0]
                    elif closed:
                        break
                    else:
                        time.sleep(0.0005)
                if not parts:
                    return None
                got = parts[0] if len(parts) == 1 else np.concatenate(parts)
                return got.T  # (channels, frames)

            return SourceComponent(
                output=SignalProperties(
                    sample_rate=float(self.sample_rate), channels=self.channels
                ),
                feed=feed,
                start=start,
                flush=flush,
            )

        return alloc


class WavSink:
    """Streaming WAV file sink with a background native writer thread.

    ``frames_written`` is advanced by the writer thread: it is final once
    ``flush`` has returned (``run`` and ``Pipe.wait`` call it)."""

    def __init__(self, path: str, bits: int = 32, buffer_blocks: int = 8):
        self.path = str(path)
        self.bits = bits
        self.buffer_blocks = buffer_blocks
        self._thread: Optional[threading.Thread] = None
        self._done = threading.Event()
        self.frames_written = 0

    def sink(self):
        def alloc(mctx, block_size: int, props: SignalProperties) -> SinkComponent:
            ring = native.RingBuffer(
                max(self.buffer_blocks, 2) * block_size, props.channels
            )
            done = self._done
            err: list[BaseException] = []

            def writer():
                w = None
                try:
                    # inside the try: a file that cannot be created must
                    # reach flush() as an error, not kill the thread unseen
                    w = native.WavWriter(
                        self.path, props.channels, int(props.sample_rate),
                        self.bits
                    )
                    while True:
                        chunk = ring.pop(block_size)
                        if chunk.shape[0] == 0:
                            if ring.closed:
                                break
                            time.sleep(0.0005)
                            continue
                        w.write(chunk)
                        self.frames_written += chunk.shape[0]
                except BaseException as e:  # noqa: BLE001 — surfaced on flush
                    err.append(e)
                finally:
                    if w is not None:
                        w.close()
                    done.set()

            def start():
                done.clear()
                self.frames_written = 0
                self._thread = threading.Thread(
                    target=writer, name="wav-writer", daemon=True
                )
                self._thread.start()

            def flush():
                ring.close()
                if self._thread is not None:
                    self._thread.join(timeout=30)
                    self._thread = None
                if err:
                    raise err[0]

            def receive(block: np.ndarray):
                frames = np.ascontiguousarray(np.asarray(block).T, np.float32)
                pushed = 0
                while pushed < frames.shape[0]:
                    n = ring.push(frames[pushed:])
                    if n == 0:
                        if done.is_set():  # the writer died: nobody drains
                            raise err[0] if err else IOError(
                                f"WAV writer for {self.path} has stopped")
                        time.sleep(0.0005)
                    pushed += n

            return SinkComponent(receive=receive, start=start, flush=flush)

        return alloc

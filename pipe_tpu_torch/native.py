"""Native runtime bindings (ctypes over the C++ in ``native/``).

The counterpart of :mod:`pipe_tpu.native`, over the same C++ sources. The
compute path is PyTorch and CUDA; the host-side transport and the file
codec around it are native C++:

- :class:`RingBuffer`: lock-free SPSC float ring (``native/ringbuf.cpp``)
  between a file thread and the thread that feeds or drains the pipe.
- :class:`WavReader` / :class:`WavWriter`: streaming WAV codec
  (``native/wavio.cpp``) used by :mod:`pipe_tpu_torch.io`.

The shared library is compiled at first use with ``g++ -O3`` into
``build/pipe_tpu_torch/`` beside the package, named by a hash of the
sources and flags, like the CUDA kernels of
:mod:`pipe_tpu_torch.kernels`: one build per process under a lock (a
``WavSource``'s prefetch thread and an executor thread can both be first),
each into a temporary name of its own that is moved into place, so another
process never loads a partial file. Where no C++ toolchain exists the
classes use pure-Python equivalents (``available()`` says which is live,
``build_error()`` why).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
SRC_DIR = _REPO / "native"
BUILD_DIR = _REPO / "build" / "pipe_tpu_torch"
_SOURCES = ("ringbuf.cpp", "wavio.cpp")
_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    for s in _SOURCES:
        h.update(s.encode())
        h.update((SRC_DIR / s).read_bytes())
    return BUILD_DIR / f"libpipe_native_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """Compile ``native/*.cpp`` unless the library for these sources
    exists. Called under ``_lock``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_CXX_FLAGS, "-o", str(tmp),
           *(str(SRC_DIR / s) for s in _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"native build failed:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: other processes never see a partial file
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except Exception as e:  # noqa: BLE001 - recorded; the classes fall back
            _build_error = str(e)
            return None
        _bind(lib)
        _lib = lib
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    fp = c.POINTER(c.c_float)
    sigs = {
        "pipe_ringbuf_create": ([c.c_int64, c.c_int64], c.c_void_p),
        "pipe_ringbuf_destroy": ([c.c_void_p], None),
        "pipe_ringbuf_capacity": ([c.c_void_p], c.c_int64),
        "pipe_ringbuf_size": ([c.c_void_p], c.c_int64),
        "pipe_ringbuf_close": ([c.c_void_p], None),
        "pipe_ringbuf_closed": ([c.c_void_p], c.c_int32),
        "pipe_ringbuf_push": ([c.c_void_p, fp, c.c_int64], c.c_int64),
        "pipe_ringbuf_pop": ([c.c_void_p, fp, c.c_int64], c.c_int64),
        "pipe_wav_open": ([c.c_char_p], c.c_void_p),
        "pipe_wav_close_reader": ([c.c_void_p], None),
        "pipe_wav_channels": ([c.c_void_p], c.c_int32),
        "pipe_wav_sample_rate": ([c.c_void_p], c.c_int32),
        "pipe_wav_total_frames": ([c.c_void_p], c.c_int64),
        "pipe_wav_read": ([c.c_void_p, fp, c.c_int64], c.c_int64),
        "pipe_wav_create": ([c.c_char_p, c.c_int32, c.c_int32, c.c_int32], c.c_void_p),
        "pipe_wav_write": ([c.c_void_p, fp, c.c_int64], c.c_int64),
        "pipe_wav_close_writer": ([c.c_void_p], None),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the native library is not available, or None when it is."""
    _load()
    return _build_error


def _as_float_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class RingBuffer:
    """SPSC float32 frame ring. Frames are (channels,)-interleaved rows;
    push/pop take/return (n, channels) float32 arrays and never block."""

    def __init__(self, capacity_frames: int, channels: int):
        lib = _load()
        self.channels = channels
        self._py = None
        if lib is None:
            self._py = _PyRing(capacity_frames, channels)
            self._h = None
            return
        self._lib = lib
        self._h = lib.pipe_ringbuf_create(capacity_frames, channels)
        if not self._h:
            raise MemoryError("ring buffer allocation failed")

    def push(self, frames: np.ndarray) -> int:
        if self._py is not None:
            return self._py.push(frames)
        frames = np.ascontiguousarray(frames, np.float32)
        return self._lib.pipe_ringbuf_push(
            self._h, _as_float_ptr(frames), frames.shape[0]
        )

    def pop(self, n: int) -> np.ndarray:
        if self._py is not None:
            return self._py.pop(n)
        out = np.empty((n, self.channels), np.float32)
        got = self._lib.pipe_ringbuf_pop(self._h, _as_float_ptr(out), n)
        return out[:got]

    def __len__(self) -> int:
        if self._py is not None:
            return len(self._py)
        return self._lib.pipe_ringbuf_size(self._h)

    def close(self) -> None:
        if self._py is not None:
            self._py.close()
        else:
            self._lib.pipe_ringbuf_close(self._h)

    @property
    def closed(self) -> bool:
        if self._py is not None:
            return self._py.closed
        return bool(self._lib.pipe_ringbuf_closed(self._h))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.pipe_ringbuf_destroy(h)
            self._h = None


class _PyRing:
    """Fallback ring (locked deque of rows) when no C++ toolchain exists."""

    def __init__(self, capacity_frames: int, channels: int):
        self.capacity = capacity_frames
        self.channels = channels
        self._buf: list[np.ndarray] = []
        self._n = 0
        self._lock = threading.Lock()
        self.closed = False

    def push(self, frames: np.ndarray) -> int:
        frames = np.asarray(frames, np.float32)
        with self._lock:
            take = min(frames.shape[0], self.capacity - self._n)
            if take > 0:
                self._buf.append(frames[:take].copy())
                self._n += take
            return take

    def pop(self, n: int) -> np.ndarray:
        with self._lock:
            out = []
            got = 0
            while self._buf and got < n:
                head = self._buf[0]
                take = min(n - got, head.shape[0])
                out.append(head[:take])
                if take == head.shape[0]:
                    self._buf.pop(0)
                else:
                    self._buf[0] = head[take:]
                got += take
            self._n -= got
            if not out:
                return np.empty((0, self.channels), np.float32)
            return np.concatenate(out, axis=0)

    def __len__(self) -> int:
        with self._lock:
            return self._n

    def close(self) -> None:
        self.closed = True


class WavReader:
    """Streaming WAV file reader (PCM16/24/32 + float32) -> float32
    frames. Falls back to the stdlib ``wave`` module without a toolchain."""

    def __init__(self, path: str):
        lib = _load()
        self._py = None
        if lib is None:
            self._py = _PyWavReader(path)
            self.channels = self._py.channels
            self.sample_rate = self._py.sample_rate
            self.total_frames = self._py.total_frames
            return
        self._lib = lib
        self._h = lib.pipe_wav_open(str(path).encode())
        if not self._h:
            raise IOError(f"cannot open WAV file: {path}")
        self.channels = lib.pipe_wav_channels(self._h)
        self.sample_rate = lib.pipe_wav_sample_rate(self._h)
        self.total_frames = lib.pipe_wav_total_frames(self._h)

    def read(self, n: int) -> np.ndarray:
        """Next ``(frames, channels)`` float32 chunk; empty at EOF."""
        if self._py is not None:
            return self._py.read(n)
        out = np.empty((n, self.channels), np.float32)
        got = self._lib.pipe_wav_read(self._h, _as_float_ptr(out), n)
        return out[:got]

    def close(self) -> None:
        if self._py is not None:
            self._py.close()
        elif getattr(self, "_h", None):
            self._lib.pipe_wav_close_reader(self._h)
            self._h = None

    def __del__(self):
        self.close()


class WavWriter:
    """Streaming WAV file writer (float32 or PCM16)."""

    def __init__(self, path: str, channels: int, sample_rate: int, bits: int = 32):
        lib = _load()
        self._py = None
        if lib is None:
            self._py = _PyWavWriter(path, channels, sample_rate, bits)
            return
        self._lib = lib
        self._h = lib.pipe_wav_create(
            str(path).encode(), channels, sample_rate, bits
        )
        if not self._h:
            raise IOError(f"cannot create WAV file: {path}")
        self.channels = channels

    def write(self, frames: np.ndarray) -> int:
        if self._py is not None:
            return self._py.write(frames)
        frames = np.ascontiguousarray(frames, np.float32)
        return self._lib.pipe_wav_write(self._h, _as_float_ptr(frames), frames.shape[0])

    def close(self) -> None:
        if self._py is not None:
            self._py.close()
        elif getattr(self, "_h", None):
            self._lib.pipe_wav_close_writer(self._h)
            self._h = None

    def __del__(self):
        self.close()


class _PyWavReader:
    def __init__(self, path: str):
        import wave

        self._w = wave.open(str(path), "rb")
        self.channels = self._w.getnchannels()
        self.sample_rate = self._w.getframerate()
        self.total_frames = self._w.getnframes()
        self._width = self._w.getsampwidth()

    def read(self, n: int) -> np.ndarray:
        raw = self._w.readframes(n)
        if not raw:
            return np.empty((0, self.channels), np.float32)
        if self._width == 2:
            a = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        elif self._width == 3:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
            a32 = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)
            a32 = np.where(a32 >= 1 << 23, a32 - (1 << 24), a32)
            a = a32.astype(np.float32) / 8388608.0
        elif self._width == 4:
            a = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise IOError(f"unsupported sample width {self._width}")
        return a.reshape(-1, self.channels)

    def close(self) -> None:
        self._w.close()


class _PyWavWriter:
    """Toolchain-less fallback. stdlib ``wave`` has no IEEE-float support,
    so ``bits`` maps to integer PCM of the same depth: 16 -> PCM16,
    24 -> PCM24, 32 -> PCM32 (which preserves MORE mantissa than float32
    for |x| <= 1, so a float stream loses nothing)."""

    def __init__(self, path: str, channels: int, sample_rate: int, bits: int):
        import wave

        if bits not in (16, 24, 32):
            raise ValueError(f"unsupported WAV bit depth {bits}")
        self._bits = bits
        self._w = wave.open(str(path), "wb")
        self._w.setnchannels(channels)
        self._w.setframerate(sample_rate)
        self._w.setsampwidth(bits // 8)
        self.channels = channels

    def write(self, frames: np.ndarray) -> int:
        x = np.clip(np.asarray(frames, np.float64), -1.0, 1.0)
        if self._bits == 16:
            raw = (x * 32767.0).astype("<i2").tobytes()
        elif self._bits == 24:
            pcm = (x * 8388607.0).astype("<i4")
            b = pcm.astype("<i4").view(np.uint8).reshape(-1, 4)
            raw = np.ascontiguousarray(b[:, :3]).tobytes()
        else:  # 32
            raw = (x * 2147483647.0).astype("<i4").tobytes()
        self._w.writeframes(raw)
        return frames.shape[0]

    def close(self) -> None:
        self._w.close()

"""Hand-written CUDA kernels of the port and their Python wrappers.

The sources live in ``pipe_tpu_torch/csrc/``. At first use they are compiled
with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, under ``build/pipe_tpu_torch/`` beside the package (cached by a
hash of the sources and flags), and bound with ``ctypes``. A missing
``nvcc`` or a failed build raises: there is no fallback.

Each wrapper checks its inputs and raises on what the kernel does not take,
launches on ``torch.cuda.current_stream()``, raises if the launch reports a
CUDA error, and counts its launches in a module-level integer
(``iir_tiles_launches``) and per launching thread (:func:`launch_counts`),
so a run can show that it went through the kernel. Executor threads launch
kernels concurrently: the build and the counts are under locks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "pipe_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC",
)

IIR_TILE = 256  # tile length Q of the biquad kernel
IIR_CHANNELS_PER_BLOCK = 8
IIR_MIN_B = 2048

iir_tiles_launches = 0

_lib = None
_lib_lock = threading.RLock()  # one build and one load per process
_count_lock = threading.Lock()
_thread_launches: dict = {}  # thread name -> {kernel name: launches}


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``; raises if none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        cands.append(Path(on_path))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): the "
        "port's CUDA kernels cannot be built"
    )


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libpipe_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.
    Raises ``RuntimeError`` with the compiler's output on failure. Threads
    of one process build one at a time; separate processes may build at
    once, each into its own temporary file."""
    with _lib_lock:
        out = library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *map(str, sorted(CSRC_DIR.glob("*.cu")))]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {res.returncode}:\n"
                f"{' '.join(cmd)}\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, out)  # atomic: other processes never see a partial file
        return out


def _library():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        p = ctypes.c_void_p
        lib.pipe_iir_tiles.argtypes = [p, p, p, p, p, ctypes.c_int,
                                       ctypes.c_int, p]
        lib.pipe_iir_tiles.restype = ctypes.c_int
        lib.pipe_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pipe_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def _check_launch(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.pipe_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(f"iir_tiles: {what}")


def iir_tiles(v: torch.Tensor, s: torch.Tensor, a1: torch.Tensor,
              a2: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel ``csrc/iir_tiles.cu``: ``y[n] = v[n] - a1 y[n-1] -
    a2 y[n-2]`` over ``v`` (C, B) from the carried state ``s`` (C, 2) =
    (y[-1], y[-2]). ``a1``/``a2`` are 0-d tensors on the same card (read by
    the kernel, so no host sync). Needs float32 contiguous CUDA tensors,
    ``C % 8 == 0``, ``B % 256 == 0`` and ``B >= 2048``."""
    global iir_tiles_launches
    _require(v.is_cuda, f"v must be a CUDA tensor, got {v.device}")
    _require(v.ndim == 2, f"v must be (C, B), got shape {tuple(v.shape)}")
    C, B = v.shape
    _require(C % IIR_CHANNELS_PER_BLOCK == 0, f"C={C} is not a multiple of 8")
    _require(B % IIR_TILE == 0 and B >= IIR_MIN_B,
             f"B={B} must be a multiple of 256 and >= 2048")
    _require(tuple(s.shape) == (C, 2), f"s must be ({C}, 2), got {tuple(s.shape)}")
    for name, t in (("v", v), ("s", s), ("a1", a1), ("a2", a2)):
        _require(t.device == v.device, f"{name} is on {t.device}, v on {v.device}")
        _require(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(a1.numel() == 1 and a2.numel() == 1, "a1 and a2 must be scalars")
    lib = _library()
    y = torch.empty_like(v)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.pipe_iir_tiles(v.data_ptr(), s.data_ptr(), a1.data_ptr(),
                                 a2.data_ptr(), y.data_ptr(), C, B, stream)
    _check_launch(lib, err, "iir_tiles")
    _count("iir_tiles")
    return y


def _count(name: str) -> None:
    """Add one launch of kernel ``name``, in total and for this thread."""
    global iir_tiles_launches
    thread = threading.current_thread().name
    with _count_lock:
        iir_tiles_launches += 1
        per = _thread_launches.setdefault(thread, {})
        per[name] = per.get(name, 0) + 1


def reset_counts() -> None:
    """Set every launch count to 0."""
    global iir_tiles_launches
    with _count_lock:
        iir_tiles_launches = 0
        _thread_launches.clear()


def launch_counts(by_thread: bool = False) -> dict:
    """Launch count of each kernel since the last :func:`reset_counts`;
    with ``by_thread``, ``{thread name: {kernel: count}}`` instead (the
    Pipe names each executor thread after the line it runs)."""
    with _count_lock:
        if by_thread:
            return {t: dict(c) for t, c in _thread_launches.items()}
        return {"iir_tiles": iir_tiles_launches}

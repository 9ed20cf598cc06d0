"""Hand-written CUDA kernels of the port and their Python wrappers.

The sources live in ``pipe_tpu_torch/csrc/``. At first use they are compiled
with ``nvcc`` for ``sm_90a`` into one shared library with a plain C
interface, under ``build/pipe_tpu_torch/`` beside the package (cached by a
hash of the sources and flags), and bound with ``ctypes``. A missing
``nvcc`` or a failed build raises: there is no fallback.

The two biquad entry points, :func:`iir_tiles` (the counterpart of the TPU's
Pallas call) and :func:`biquad_section`, are backed by the same device code
and take the same blocks, which one predicate decides
(:func:`section_gate`): any (C, B) block with ``C`` a positive multiple of 8,
no more 8-channel groups than a grid's 65,535 rows, and ``B >= 1``. The last
256-frame tile may be partial: the kernels read it as zeros past B and store
nothing there. :func:`envelope_block` (``csrc/envelope.cu``: a compressor's,
limiter's or noise gate's block in one launch) takes any ``C >= 1`` and
``B >= 1``.

Each wrapper checks its inputs and raises on what the kernel does not take,
allocates outputs and scratch with ``torch.empty``, enqueues its kernels on
``torch.cuda.current_stream()`` with one call into the library, raises if
that reports a CUDA error, and counts the call per kernel name, in total and
per launching thread (:func:`launch_counts`), so a run can show that it went
through the kernel. Executor threads launch kernels concurrently: the build
and the counts are under locks, and scratch is per call.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
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
IIR_MAX_GROUPS = 65535  # 8-channel groups: a CUDA grid's y extent

KERNELS = ("iir_tiles", "biquad_section", "envelope_block")  # the wrappers below

_lib = None
_lib_lock = threading.RLock()  # one build and one load per process
_count_lock = threading.Lock()
_launches = dict.fromkeys(KERNELS, 0)  # kernel name -> launches
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
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pipe_iir_tiles.argtypes = [p, p, p, p, p, p, i, i, p]
        lib.pipe_iir_tiles.restype = ctypes.c_int
        lib.pipe_biquad_section.argtypes = [p, p, p, p, i, i, p, p, p, p, i, i, p]
        lib.pipe_biquad_section.restype = ctypes.c_int
        f = ctypes.c_float
        lib.pipe_envelope_block.argtypes = [p, p, p, p, p, p, p, p, f, i, i,
                                            p, p, p, i, i, p]
        lib.pipe_envelope_block.restype = ctypes.c_int
        lib.pipe_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pipe_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return _lib


def _check_launch(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.pipe_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def section_gate(C: int, B: int) -> bool:
    """Whether a (C, B) block is one the biquad kernels (:func:`iir_tiles`,
    :func:`biquad_section`) take: whole 8-channel groups, at most
    ``IIR_MAX_GROUPS`` of them, and at least one frame, the last tile
    possibly partial."""
    groups, rest = divmod(C, IIR_CHANNELS_PER_BLOCK)
    return 0 < groups <= IIR_MAX_GROUPS and rest == 0 and B >= 1


_SECTION_RULE = ("C must be a positive multiple of 8 of at most "
                 f"{IIR_CHANNELS_PER_BLOCK * IIR_MAX_GROUPS} and B >= 1")


def _tiles(B: int) -> int:
    """256-frame tiles of a B-frame row, the last one possibly partial."""
    return -(-B // IIR_TILE)


def _check_block(name: str, x: torch.Tensor, state, params,
                 gate=section_gate, rule: str = _SECTION_RULE) -> tuple:
    """``x`` must be a float32 contiguous CUDA (C, B) block that passes
    ``gate`` (``rule`` says how), every ``(label, tensor)`` of ``state`` a
    (C, 2) tensor and every ``(label, tensor, shape)`` of ``params`` of that
    many elements, all float32, contiguous and on the same card. Returns
    (C, B); raises ``ValueError`` naming the first thing the kernel does not
    take: the block's shape, then each tensor's type, layout and shape, then
    the device."""
    C, B = x.shape if x.ndim == 2 else (0, 0)
    dev = x.device

    def ok(t, shape, exact):
        return (t.dtype is torch.float32 and t.is_contiguous()
                and (t.shape == shape if exact else t.numel() == math.prod(shape)))

    tensors = (("the block", x, (C, B), True),
               *((label, t, (C, 2), True) for label, t in state),
               *((label, t, shape, False) for label, t, shape in params))
    if (x.is_cuda and gate(C, B)
            and all(ok(t, shape, exact) and t.device == dev
                    for _, t, shape, exact in tensors)):
        return C, B
    if x.ndim != 2:
        raise ValueError(f"{name}: the block must be (C, B), got {tuple(x.shape)}")
    if not gate(C, B):
        raise ValueError(f"{name}: block ({C}, {B}) is off its gate: {rule}")
    for label, t, shape, exact in tensors:
        if not ok(t, shape, exact):
            raise ValueError(
                f"{name}: {label} must be a contiguous float32 tensor of "
                f"shape {shape}, got {t.dtype} {tuple(t.shape)}, contiguous: "
                f"{t.is_contiguous()}")
    if not x.is_cuda:
        raise ValueError(f"{name}: the block must be a CUDA tensor, got {dev}")
    for label, t, _, _ in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {label} must be on {dev}, got {t.device}")
    raise AssertionError("unreachable")


# the current stream's handle without building a ``torch.cuda.Stream``
# (tens of microseconds a call); absent from builds of torch without CUDA
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _current_stream(index: int) -> int:
    if _raw_stream is not None:
        return _raw_stream(index)
    return torch.cuda.current_stream(index).cuda_stream


def _launch(name: str, device: torch.device, fn, *args) -> None:
    """Call the library's ``fn(*args, stream)`` on ``device``'s current
    stream, raise on a CUDA error, and count one launch of ``name``."""
    lib = _library()
    if device.index == torch.cuda.current_device():
        err = fn(*args, _current_stream(device.index))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _current_stream(device.index))
    _check_launch(lib, err, name)
    _count(name)


def iir_tiles(v: torch.Tensor, s: torch.Tensor, a1: torch.Tensor,
              a2: torch.Tensor) -> torch.Tensor:
    """The tile-parallel recurrence of ``csrc/iir_tiles.cu``: ``y[n] = v[n]
    - a1 y[n-1] - a2 y[n-2]`` over ``v`` (C, B) from the carried state ``s``
    (C, 2) = (y[-1], y[-2]). ``a1``/``a2`` are 0-d tensors on the same card
    (read by the kernel, so no host sync). Needs float32 contiguous CUDA
    tensors and a block on :func:`section_gate`."""
    C, B = _check_block("iir_tiles", v, (("s", s),),
                        (("a1", a1, ()), ("a2", a2, ())))
    y = torch.empty_like(v)
    zl = torch.empty(2 * C * _tiles(B), dtype=torch.float32, device=v.device)
    _launch("iir_tiles", v.device, _library().pipe_iir_tiles,
            v.data_ptr(), s.data_ptr(), a1.data_ptr(), a2.data_ptr(),
            y.data_ptr(), zl.data_ptr(), C, B)
    return y


def biquad_section(x: torch.Tensor, frames: int, x_tail: torch.Tensor,
                   s: torch.Tensor, coefs: torch.Tensor, refine: bool = True):
    """One biquad EQ section over a block in one call
    (``csrc/iir_tiles.cu``): what
    :func:`pipe_tpu_torch.ops.biquad.biquad_section_block` computes. ``x``
    (C, B) is valid to the host int ``frames``; ``x_tail`` and ``s`` (C, 2)
    are the carried state, ``coefs`` the live (6,) row [b0, b1, b2, 1, a1,
    a2] on the card (read by the kernels, no host sync). Returns ``(y,
    new_x_tail, new_s)``. Needs float32 contiguous CUDA tensors and a block
    on :func:`section_gate`."""
    C, B = _check_block("biquad_section", x, (("x_tail", x_tail), ("s", s)),
                        (("coefs", coefs, (6,)),))
    frames = int(frames)
    if not 0 <= frames <= B:
        raise ValueError(f"biquad_section: frames={frames} outside [0, {B}]")
    y = torch.empty_like(x)
    new_x_tail, new_s = torch.empty(
        (2, C, 2), dtype=torch.float32, device=x.device).unbind(0)
    n_scratch = 4 * C * _tiles(B) + (C * B if refine else 0)
    scratch = torch.empty(n_scratch, dtype=torch.float32, device=x.device)
    _launch("biquad_section", x.device, _library().pipe_biquad_section,
            x.data_ptr(), x_tail.data_ptr(), s.data_ptr(), coefs.data_ptr(),
            frames, int(bool(refine)), y.data_ptr(), new_x_tail.data_ptr(),
            new_s.data_ptr(), scratch.data_ptr(), C, B)
    return y, new_x_tail, new_s


def envelope_block(x: torch.Tensor, frames: int, env: torch.Tensor,
                   env_lo: torch.Tensor, attack_ms: torch.Tensor,
                   release_ms: torch.Tensor, sample_rate: float, gate: bool,
                   threshold_db: torch.Tensor, amount: torch.Tensor,
                   makeup_db=None) -> tuple:
    """One compressor, limiter or noise gate over a block in one call
    (``csrc/envelope.cu``): what
    :func:`pipe_tpu_torch.ops.dynamics.envelope_block` and the op's gain
    compute, and ``y = x * gain``. ``x`` (C, B) is valid to the host int
    ``frames``; ``env`` (C, 2) and ``env_lo`` (C,) are the carried state.
    ``attack_ms``, ``release_ms``, ``threshold_db``, ``amount`` and
    ``makeup_db`` are the op's live 0-d params on the card (read by the
    kernel, no host sync): a gate (``gate`` true) takes ``amount`` as its
    range_db and no ``makeup_db``, a compressor or limiter ``amount`` as its
    ratio (inf limits) and a ``makeup_db``. Returns ``(y, new_env,
    new_env_lo)``. Needs float32 contiguous CUDA tensors, ``C >= 1`` and
    ``B >= 1``."""
    if gate != (makeup_db is None):
        raise ValueError("envelope_block: a gate takes no makeup_db, a "
                         "compressor needs one")
    gain = (threshold_db, amount) + (() if gate else (makeup_db,))
    C = x.shape[0] if x.ndim == 2 else 0
    params = (("env_lo", env_lo, (C,)), ("attack_ms", attack_ms, ()),
              ("release_ms", release_ms, ()),
              *((label, t, ()) for label, t in
                zip(("threshold_db", "amount", "makeup_db"), gain)))
    C, B = _check_block("envelope_block", x, (("env", env),), params,
                        lambda C, B: C >= 1 and B >= 1, "C and B must be >= 1")
    frames = int(frames)
    if not 0 <= frames <= B:
        raise ValueError(f"envelope_block: frames={frames} outside [0, {B}]")
    y = torch.empty_like(x)
    carry = torch.empty(3 * C, dtype=torch.float32, device=x.device)
    new_env, new_lo = carry[:2 * C].view(C, 2), carry[2 * C:]
    _launch("envelope_block", x.device, _library().pipe_envelope_block,
            x.data_ptr(), env.data_ptr(), env_lo.data_ptr(),
            attack_ms.data_ptr(), release_ms.data_ptr(),
            threshold_db.data_ptr(), amount.data_ptr(),
            gain[-1].data_ptr(),  # a gate's is never read
            float(sample_rate), frames, int(gate),
            y.data_ptr(), new_env.data_ptr(), new_lo.data_ptr(), C, B)
    return y, new_env, new_lo


def _count(name: str) -> None:
    """Add one launch of kernel ``name``, in total and for this thread."""
    thread = threading.current_thread().name
    with _count_lock:
        _launches[name] = _launches.get(name, 0) + 1
        per = _thread_launches.setdefault(thread, {})
        per[name] = per.get(name, 0) + 1


def reset_counts() -> None:
    """Set every launch count to 0."""
    with _count_lock:
        _launches.clear()
        _launches.update(dict.fromkeys(KERNELS, 0))
        _thread_launches.clear()


def launch_counts(by_thread: bool = False) -> dict:
    """Launch count of each kernel since the last :func:`reset_counts`;
    with ``by_thread``, ``{thread name: {kernel: count}}`` instead (the
    Pipe names each executor thread after the line it runs)."""
    with _count_lock:
        if by_thread:
            return {t: dict(c) for t, c in _thread_launches.items()}
        return dict(_launches)


"""Global knobs: the device the entry points default to, and the float32
precision of matrix products and convolutions.

``run``, ``Pipe``, ``process`` and ``make_flagship`` work on the card unless
the caller asks for the CPU: with no ``device`` argument they take
:func:`default_device`, which is the device given to
:func:`set_default_device`, else the current CUDA device, and which raises
where there is neither. It never falls back to the CPU by itself.

On the card, a float32 ``torch.matmul`` runs in IEEE FP32 by default, but a
float32 convolution goes through cuDNN in TF32 (about three decimal digits).
The FIR, the polyphase resampler and ``combine_bank`` are convolutions, so
in TF32 the flagship chain would fall far below the 100 dB bar.

``'highest'`` (the default, applied when this module is imported) therefore
pins IEEE FP32 for cuBLAS AND cuDNN. ``'default'`` allows TF32 in both.
``'high'`` is the three-pass emulation (3xTF32), the counterpart of the JAX
package's ``'high'``: each float32 operand is split into a head that TF32
holds exactly and the remainder, and the product is formed as ``a_hi b_hi +
a_hi b_lo + a_lo b_hi``, three TF32 products accumulated in FP32. The JAX
package's ``'mixed'`` has no counterpart and raises ``ValueError``.

Every non-recursive product of the port (FIR, resampler, fused banks,
mixer, channelizer) goes through :func:`matmul`, :func:`einsum` or
:func:`conv1d` below, which read the precision name once per call and so
take one product or three consistently within a call. The recursive paths
(the biquad's tile product, its prefix scans and its defect) do not consult
the knob at all: they compute in float64 or elementwise and give the same
bits under every name.

A line keeps the name it started with, as a JAX line keeps the precision
its step was traced with: every executor reads the name once when its run
starts and binds it to each of its sweeps (:func:`precision_bound`, a
per-thread binding that the helpers read before the process-wide name), so
a :func:`set_matmul_precision` or a :func:`matmul_precision_scope` in
another thread leaves a running pipe's choice between one product and
three alone.

The knobs behind the names are torch's process-wide ``fp32_precision``
settings of the two backends (TF32 for ``'default'`` and ``'high'``, IEEE
for ``'highest'``); they take effect at the next call and change nothing on
the CPU. They stay process-wide, and a name set in one thread moves them
for every thread while it holds. So on the card a ``'highest'`` product
that finds them at TF32 takes the three products of ``'high'``: a line
started under ``'highest'`` computes in IEEE FP32, or at worst at
``'high'``, never in single TF32 products. A ``'default'`` line's single
products run in IEEE FP32 while another thread holds ``'highest'``. Two
scopes open at once in two threads restore in whatever order they exit.
Set the precision before starting pipes, or from one thread only.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

# precision name -> torch fp32_precision value for cuBLAS and cuDNN
_NAMED = {"default": "tf32", "high": "tf32", "highest": "ieee"}

_matmul_precision = "highest"
_default_device = None  # set by set_default_device; None: the current card
_bound = threading.local()  # .name: this thread's bound precision name


def set_default_device(device) -> None:
    """Make ``device`` (``"cpu"``, ``"cuda"``, ``"cuda:1"``, a
    ``torch.device``) what the entry points use when they are given no
    ``device``; ``None`` clears it, back to the current CUDA device."""
    global _default_device
    _default_device = None if device is None else torch.device(device)


def default_device() -> torch.device:
    """The device of an entry point called without ``device``: the one set
    by :func:`set_default_device`, else the current CUDA device. Raises
    ``RuntimeError`` when nothing was set and there is no card."""
    if _default_device is not None:
        return _default_device
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    raise RuntimeError(
        "no CUDA card is available and no default device was set: pass "
        'device="cpu" or call pipe_tpu_torch.set_default_device("cpu") to '
        "run on the CPU"
    )


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or :func:`default_device` for
    ``None``."""
    return default_device() if device is None else torch.device(device)


def _apply(name: str) -> None:
    mode = _NAMED[name]
    torch.backends.cuda.matmul.fp32_precision = mode
    torch.backends.cudnn.conv.fp32_precision = mode


def fp32_pinned() -> bool:
    """True when both cuBLAS and cuDNN run float32 in IEEE FP32 (no TF32)."""
    return (
        torch.backends.cuda.matmul.fp32_precision == "ieee"
        and torch.backends.cudnn.conv.fp32_precision == "ieee"
    )


def set_matmul_precision(p: str) -> None:
    """Set the float32 precision of matmuls and convolutions:
    ``'highest'`` (IEEE FP32), ``'high'`` (3xTF32 through the helpers of
    this module) or ``'default'`` (TF32)."""
    global _matmul_precision
    if not isinstance(p, str):
        raise TypeError(f"expected a precision name, got {type(p)!r}")
    name = p.lower()
    if name not in _NAMED:
        raise ValueError(
            f"unknown precision {p!r}; expected one of {sorted(_NAMED)}"
        )
    _apply(name)
    _matmul_precision = name


def matmul_precision() -> str:
    """The current precision name: the one bound to this thread by
    :func:`precision_bound`, else the process-wide one."""
    return getattr(_bound, "name", None) or _matmul_precision


@contextmanager
def precision_bound(name: Optional[str]) -> Iterator[None]:
    """Make ``name`` this thread's precision name while the block runs
    (``None`` binds nothing). An executor binds the name its run started
    with around every sweep; the backends' flags are not touched."""
    if name is None:
        yield
        return
    prev = getattr(_bound, "name", None)
    _bound.name = name
    try:
        yield
    finally:
        _bound.name = prev


@contextmanager
def matmul_precision_scope(p: str) -> Iterator[None]:
    """Temporarily override the precision."""
    old = _matmul_precision
    set_matmul_precision(p)
    try:
        yield
    finally:
        set_matmul_precision(old)


def _split_tf32(a):
    """``a`` (float32) as ``(hi, lo)`` with ``hi + lo == a`` exactly: ``hi``
    is ``a`` rounded to nearest at TF32's 10 explicit mantissa bits, so a
    TF32 product reads it without loss, and ``lo`` the remainder (at most
    12 significant bits). A value so large that its head would round to
    infinity keeps itself as the head. The split has no meaning for a
    non-finite value (``inf - inf``): under ``'high'`` an infinite or NaN
    sample gives NaN, where ``'highest'`` may give an infinity, in exactly
    the outputs that the sample enters."""
    bits = a.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    hi = torch.where(torch.isfinite(hi), hi, a)
    return hi, a - hi


def _bilinear(fn, a, b):
    """``fn(a, b)`` for a bilinear ``fn`` at the current precision: one call
    under ``'highest'`` and ``'default'`` (the backends' flags decide how it
    is computed on the card), three under ``'high'``, and three under
    ``'highest'`` on the card while another thread holds the flags at TF32.
    The name (this thread's bound one, else the process-wide one) is read
    once, so a change made by another thread cannot mix the two within a
    call."""
    name = matmul_precision()
    if a.dtype is not torch.float32 or not (
            name == "high" or (name == "highest" and a.is_cuda
                               and not fp32_pinned())):
        return fn(a, b)
    a_hi, a_lo = _split_tf32(a)
    b_hi, b_lo = _split_tf32(b)
    # small terms first, so their sum is not rounded away in the large one
    return (fn(a_hi, b_lo) + fn(a_lo, b_hi)) + fn(a_hi, b_hi)


def matmul(a, b):
    """``torch.matmul(a, b)`` at the current precision."""
    return _bilinear(torch.matmul, a, b)


def einsum(equation: str, a, b):
    """``torch.einsum(equation, a, b)`` at the current precision."""
    return _bilinear(lambda p, q: torch.einsum(equation, p, q), a, b)


def conv1d(x, w, padding: int = 0, groups: int = 1):
    """``F.conv1d(x, w, padding=padding, groups=groups)`` at the current
    precision."""
    return _bilinear(
        lambda p, q: F.conv1d(p, q, padding=padding, groups=groups), x, w)


_apply(_matmul_precision)

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
The knobs are torch's process-wide ``fp32_precision`` settings of the two
backends; they take effect at the next call and change nothing on the CPU.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

import torch

# precision name -> torch fp32_precision value for cuBLAS and cuDNN
_NAMED = {"default": "tf32", "highest": "ieee"}

_matmul_precision = "highest"
_default_device = None  # set by set_default_device; None: the current card


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
    ``'highest'`` (IEEE FP32) or ``'default'`` (TF32)."""
    global _matmul_precision
    if not isinstance(p, str):
        raise TypeError(f"expected a precision name, got {type(p)!r}")
    name = p.lower()
    if name == "high":
        raise NotImplementedError("'high' (3xTF32) is not ported yet")
    if name not in _NAMED:
        raise ValueError(
            f"unknown precision {p!r}; expected one of {sorted(_NAMED)}"
        )
    _apply(name)
    _matmul_precision = name


def matmul_precision() -> str:
    """The current precision name."""
    return _matmul_precision


@contextmanager
def matmul_precision_scope(p: str) -> Iterator[None]:
    """Temporarily override the precision."""
    old = _matmul_precision
    set_matmul_precision(p)
    try:
        yield
    finally:
        set_matmul_precision(old)


_apply(_matmul_precision)

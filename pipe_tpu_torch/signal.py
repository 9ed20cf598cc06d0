"""Signal buffers — planar ``(channels, frames)`` float32 tensors.

The PyTorch counterpart of :mod:`pipe_tpu.signal`. A :class:`Signal`
carries a fixed-capacity data tensor plus ``frames``, the number of leading
frames that are valid; everything past ``frames`` is garbage downstream
stages must mask or ignore (the reference's short-read ``Slice``,
``pipe.go:404-406``).

``frames`` is a host ``int`` here, not a device scalar: the executor knows
every block's frame count on the host (a host feed's read length, or a
device source's count read back once per block), so the ops slice by it
directly instead of indexing with device tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

DEFAULT_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class Signal:
    """A fixed-capacity block of multi-channel samples: ``data`` is
    ``(channels, block_size)``, ``frames`` (host int) the valid prefix."""

    data: torch.Tensor
    frames: int

    @property
    def channels(self) -> int:
        return self.data.shape[0]

    @property
    def block_size(self) -> int:
        return self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    def mask(self) -> torch.Tensor:
        """``(1, block_size)`` mask in the data's dtype, on the data's
        device: 1.0 for valid frames, else 0.0."""
        idx = torch.arange(self.block_size, device=self.data.device)[None, :]
        return (idx < self.frames).to(self.data.dtype)

    def masked(self) -> "Signal":
        """Return a signal with invalid frames zeroed."""
        return Signal(zero_past(self.data, self.frames), self.frames)

    def with_data(self, data: torch.Tensor) -> "Signal":
        return Signal(data, self.frames)

    def with_frames(self, frames: int) -> "Signal":
        return Signal(self.data, int(frames))


@dataclasses.dataclass(frozen=True)
class SignalProperties:
    """Stream metadata threaded source -> processors -> sink during graph
    construction (reference ``line.go:38-41,62-90``). ``device`` is where
    the stream's tensors live; the route builder fills it in for the whole
    line, so allocators create their state with ``props.device``."""

    sample_rate: float
    channels: int
    device: Optional[torch.device] = None

    def __post_init__(self):
        if self.channels <= 0:
            raise ValueError(f"channels must be positive, got {self.channels}")
        if self.sample_rate < 0:
            raise ValueError(f"sample_rate must be >= 0, got {self.sample_rate}")


def zero_past(x: torch.Tensor, frames: int) -> torch.Tensor:
    """``x`` with every column at or past ``frames`` set to zero (``x``
    itself when the whole block is valid)."""
    if frames >= x.shape[1]:
        return x
    out = x.clone()
    out[:, frames:] = 0.0
    return out


def silence(channels: int, block_size: int, device=None,
            dtype=DEFAULT_DTYPE) -> Signal:
    """An all-zero full block."""
    return Signal(
        torch.zeros((channels, block_size), dtype=dtype, device=device),
        block_size,
    )


def empty(channels: int, block_size: int, device=None,
          dtype=DEFAULT_DTYPE) -> Signal:
    """An all-zero block with zero valid frames (an EOF placeholder)."""
    return Signal(
        torch.zeros((channels, block_size), dtype=dtype, device=device), 0)


def from_array(x, frames: Optional[int] = None, device=None,
               dtype=DEFAULT_DTYPE) -> Signal:
    """Build a Signal from a ``(channels, block)`` array-like (copied)."""
    data = torch.tensor(np.asarray(x), dtype=dtype, device=device)
    if data.ndim == 1:
        data = data[None, :]
    if data.ndim != 2:
        raise ValueError(f"expected 1D or 2D array, got shape {np.shape(x)}")
    n = data.shape[1] if frames is None else int(frames)
    return Signal(data, n)


def to_numpy(sig: Signal) -> np.ndarray:
    """Fetch only the valid frames as a host ``(channels, frames)`` array."""
    return sig.data[:, : sig.frames].cpu().numpy()


def snr_db(ref: np.ndarray, test: np.ndarray) -> float:
    """Signal-to-noise ratio of ``test`` against oracle ``ref``, in dB (the
    numeric-fidelity metric of the golden tests; target >= 100 dB)."""
    ref = np.asarray(ref, np.float64)
    test = np.asarray(test, np.float64)
    noise = ref - test
    num = float(np.sum(ref * ref))
    den = float(np.sum(noise * noise))
    if den == 0.0:
        return float("inf")
    if num == 0.0:
        return float("-inf")
    return 10.0 * np.log10(num / den)

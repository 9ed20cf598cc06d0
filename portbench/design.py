"""The benchmark's own designs of the coefficients it hands to both sides.

Every coefficient is designed here in float64 from the run's seed and then
rounded to float32, the type the stream is served in, so the program and the
reference read the same numbers.
"""

from __future__ import annotations

import numpy as np


def f32(a) -> np.ndarray:
    """``a`` rounded to float32 and held as float64."""
    return np.asarray(a, np.float32).astype(np.float64)


def lowpass(num_taps: int, cutoff_hz: float, rate_hz: float) -> np.ndarray:
    """Hamming-windowed sinc low-pass, unit gain at DC."""
    fc = cutoff_hz / rate_hz
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = 2.0 * fc * np.sinc(2.0 * fc * n) * np.hamming(num_taps)
    return h / h.sum()


def peaking(rate_hz: float, freq_hz: float, q: float, gain_db: float) -> np.ndarray:
    """RBJ cookbook peaking section [b0 b1 b2 1 a1 a2]."""
    a = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * np.pi * freq_hz / rate_hz
    alpha = np.sin(w0) / (2.0 * q)
    b = np.array([1 + alpha * a, -2 * np.cos(w0), 1 - alpha * a])
    den = np.array([1 + alpha / a, -2 * np.cos(w0), 1 - alpha / a])
    return np.concatenate([b / den[0], [1.0], den[1:] / den[0]])


def peaking_sections(rng, eq: dict, rate_hz: float) -> np.ndarray:
    """``eq["sections"]`` peaking rows drawn from ``rng``: log-uniform
    frequency, uniform q and gain over the configuration's ranges; (S, 6),
    rounded to float32 with ``a0 == 1``."""
    rows = [peaking_row(rng, eq, rate_hz) for _ in range(eq["sections"])]
    return f32(np.stack(rows))


def peaking_row(rng, eq: dict, rate_hz: float) -> np.ndarray:
    lo, hi = np.log(eq["freq_hz"][0]), np.log(eq["freq_hz"][1])
    return peaking(rate_hz, float(np.exp(rng.uniform(lo, hi))),
                   float(rng.uniform(*eq["q"])), float(rng.uniform(*eq["gain_db"])))

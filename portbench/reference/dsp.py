"""Plain float64 versions of the ops the benchmark's chains use.

Every function starts from a zero state, as a stream does at its first
sample, and returns the first ``len(x)`` outputs (the resampler: the outputs
those inputs determine). A stretch from the middle of a stream is computed by
running from far enough before it that the zero start has died away; the
harness chooses that lead.
"""

from __future__ import annotations

import numpy as np


def tf32(a) -> np.ndarray:
    """``a`` rounded to TF32 (float32 with 10 explicit mantissa bits, to
    nearest), as float64: what a TF32 product reads of an operand."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    bits = ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32)
    return bits.view(np.float32).astype(np.float64)


def convolve(x, taps) -> np.ndarray:
    """Causal convolution ``y[n] = sum_k taps[k] x[n-k]`` of every row of
    ``x`` (C, N) with ``taps`` (T,), zero before the first sample; (C, N)."""
    x = np.asarray(x, np.float64)
    taps = np.asarray(taps, np.float64)
    n = x.shape[1]
    size = 1 << int(np.ceil(np.log2(n + taps.shape[0] - 1)))
    spec = np.fft.rfft(x, size, axis=1) * np.fft.rfft(taps, size)[None, :]
    return np.fft.irfft(spec, size, axis=1)[:, :n]


def polyphase_bank(up: int, down: int, taps_per_phase: int,
                   beta: float = 12.0) -> np.ndarray:
    """The polyphase bank ``hp`` (L, K) of an L/M rate change: a
    Kaiser-windowed sinc prototype of K*L taps at the upsampled rate, cut
    off at 94 % of the smaller Nyquist, scaled to unit DC gain times L;
    ``hp[p, i] = h[i*L + p]``."""
    L, K = up, taps_per_phase
    n = K * L
    cutoff = 0.94 * min(0.5, up / (2.0 * down))  # in units of the rate L
    c = cutoff / (L / 2.0)  # normalized to the upsampled Nyquist
    m = np.arange(n, dtype=np.float64) - 0.5 * (n - 1)
    h = c * np.sinc(c * m) * np.kaiser(n, beta)
    h = h / h.sum() * L
    return h.reshape(K, L).T.copy()


def resample(x, bank, up: int, down: int) -> np.ndarray:
    """Polyphase L/M resampling of every row of ``x`` (C, N) with ``bank``
    (L, K): output ``j`` sits at upsampled position ``u = j*M``, its phase
    is ``u % L`` and its newest input ``u // L``, so
    ``y[j] = sum_i bank[u % L, i] * x[u // L - i]``; ``ceil(N*L/M)``
    outputs.

    Computed a supercycle at a time: the L outputs ``j = L s + q`` read the
    inputs ``M s - (K - 1)`` to ``M s + M - 1``, so they are one product of a
    fixed (L, K - 1 + M) matrix, whose row ``q`` holds ``bank[q M % L, i]``
    at column ``K - 1 + (q M) // L - i``, with that window of the input."""
    x = np.asarray(x, np.float64)
    bank = np.asarray(bank, np.float64)
    L, M = up, down
    C, N = x.shape
    K = bank.shape[1]
    n_out = -(-N * L // M)
    cycles = -(-N // M)
    W = np.zeros((L, K - 1 + M))
    for q in range(L):
        for i in range(K):
            W[q, K - 1 + (q * M) // L - i] = bank[(q * M) % L, i]
    xp = np.zeros((C, K - 1 + cycles * M))
    xp[:, K - 1:K - 1 + N] = x
    s0, s1 = xp.strides
    windows = np.lib.stride_tricks.as_strided(
        xp, (C, cycles, K - 1 + M), (s0, M * s1, s1), writeable=False)
    y = windows.reshape(C * cycles, K - 1 + M) @ W.T  # one copy, one product
    return y.reshape(C, cycles * L)[:, :n_out]


def biquad_cascade(x, sections, block: int) -> np.ndarray:
    """A cascade of biquad sections over every row of ``x`` (C, N), zero
    state at the start. ``sections`` is (S, 6) [b0 b1 b2 a0 a1 a2] with
    ``a0 == 1``, or (n_blocks, S, 6): the rows in force for each ``block``
    samples, switched at the block boundary with the state carried (direct
    form I: ``v[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2]``, ``y[n] = v[n] -
    a1 y[n-1] - a2 y[n-2]``, the new rows applied to the old history)."""
    y = np.asarray(x, np.float64).T.copy()  # (N, C): a row per sample
    N = y.shape[0]
    sections = np.asarray(sections, np.float64)
    if sections.ndim == 2:
        sections = np.broadcast_to(sections, (-(-N // block),) + sections.shape)
    for s in range(sections.shape[1]):
        xin = np.concatenate([np.zeros((2, y.shape[1])), y], axis=0)
        out = np.zeros((N + 2, y.shape[1]))
        for k in range(-(-N // block)):
            b0, b1, b2, a0, a1, a2 = sections[k, s]
            if a0 != 1.0:
                raise ValueError("sections must have a0 == 1")
            lo, hi = k * block, min(N, (k + 1) * block)
            v = (b0 * xin[lo + 2:hi + 2] + b1 * xin[lo + 1:hi + 1]
                 + b2 * xin[lo:hi])
            for n in range(lo, hi):
                out[n + 2] = v[n - lo] - a1 * out[n + 1] - a2 * out[n]
        y = out[2:]
    return y.T.copy()


def mix(x, matrix) -> np.ndarray:
    """``matrix`` (C_out, C_in) times ``x`` (C_in, N), in float64."""
    return np.asarray(matrix, np.float64) @ np.asarray(x, np.float64)

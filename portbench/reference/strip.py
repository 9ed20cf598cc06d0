"""Plain float64 versions of the mastering strip's nonlinear recurrences:
the envelope follower and attack smoother of a gate or compressor, their
gains, and a feedback echo.

Every function starts from a zero state and returns the first ``len(x)``
outputs, as :mod:`portbench.reference.dsp` does. Each recurrence is the
definition below, computed in blocks where the blocked form is exact to
float64 rounding (the tests tie each one to a loop over single samples):

- release follower ``env[n] = max(|x[n]|, r env[n-1])``: within a block of
  at most ``FOLLOW`` samples, ``env[n] = max_k r^(n-k) |x[k]|`` (the carried value
  as a sample before the block), taken as a running maximum of
  ``log|x[k]| - k log r``;
- attack smoother ``e[n] = (1 - a) e[n-1] + a u[n]``: within a block of
  ``SMOOTH`` samples, a lower-triangular Toeplitz product with
  ``(1 - a)^(i-j)``, the blocks joined by their carries;
- echo ``s[n] = x[n] + fb s[n-D]``, ``y[n] = dry x[n] + wet s[n-D]``: one
  ``D``-sample row at a time.
"""

from __future__ import annotations

import numpy as np

FOLLOW = 4096  # samples a block of the follower
SMOOTH = 128  # samples a block of the smoother


def follower(x_abs, r: float) -> np.ndarray:
    """``env[n] = max(x_abs[n], r env[n-1])`` along axis 1 of ``x_abs``
    (C, N), zero before the first sample, ``0 < r < 1``."""
    x_abs = np.asarray(x_abs, np.float64)
    C, N = x_abs.shape
    log_r = np.log(r)
    out = np.empty((C, N))
    carry = np.zeros(C)
    # short enough a block that the decay over it stays within e^-16: the
    # exponents' rounding then costs a few ulps
    step = int(min(FOLLOW, max(1.0, 16.0 / -log_r)))
    k = np.arange(step, dtype=np.float64)
    with np.errstate(divide="ignore"):
        for lo in range(0, N, step):
            blk = x_abs[:, lo:lo + step]
            n = blk.shape[1]
            # the carry stands at k = -1; zeros are log 0 = -inf, never the max
            z = np.concatenate([np.log(carry)[:, None] + log_r,
                                np.log(blk) - k[:n] * log_r], axis=1)
            run = np.maximum.accumulate(z, axis=1)[:, 1:]
            out[:, lo:lo + n] = np.exp(run + k[:n] * log_r)
            carry = out[:, lo + n - 1]
    return out


def one_pole(u, a: float) -> np.ndarray:
    """``e[n] = (1 - a) e[n-1] + a u[n]`` along axis 1 of ``u`` (C, N), zero
    before the first sample; ``1 - a`` is taken exactly in float64."""
    u = np.asarray(u, np.float64)
    C, N = u.shape
    L = SMOOTH
    p = 1.0 - a
    m = -(-N // L)
    up = np.zeros((C, m * L))
    up[:, :N] = a * u
    i = np.arange(L)
    lag = i[:, None] - i[None, :]
    T = np.where(lag >= 0, p ** np.maximum(lag, 0), 0.0)  # (L, L), T[i, j] = p^(i-j)
    local = up.reshape(C, m, L) @ T.T  # each block from a zero carry
    # the carry leaving block b: p^L times the one entering it, plus the
    # block's own last sample
    last = np.ascontiguousarray(local[:, :, -1].T)  # (m, C)
    carry = np.zeros((m + 1, C))  # carry[b]: the one entering block b
    pl = p ** L
    for b in range(m):
        carry[b + 1] = pl * carry[b] + last[b]
    local += carry[:m].T[:, :, None] * (p ** (i + 1.0))  # its decay over the block
    return local.reshape(C, m * L)[:, :N]


def smoothed_envelope(x, release_coef: float, attack_a: float) -> np.ndarray:
    """The attack-smoothed peak envelope of ``x`` (C, N)."""
    return one_pole(follower(np.abs(np.asarray(x, np.float64)), release_coef), attack_a)


def level_db(env) -> np.ndarray:
    return 20.0 * np.log10(np.maximum(env, 1e-8))


def compressor_gain(env, threshold_db: float, ratio: float, makeup_db: float) -> np.ndarray:
    """Hard-knee downward compression: ``10^((-max(L - T, 0) (1 - 1/max(ratio,
    1)) + makeup) / 20)`` of the level ``L`` in dB; ``ratio`` inf limits."""
    over = np.maximum(level_db(env) - threshold_db, 0.0)
    slope = 1.0 - 1.0 / max(ratio, 1.0)
    return np.exp((-over * slope + makeup_db) * (np.log(10.0) / 20.0))


def gate_gain(env, threshold_db: float, range_db: float) -> np.ndarray:
    """1 where the level is at the threshold or above, else ``-range_db`` dB."""
    return np.where(level_db(env) >= threshold_db, 1.0, 10.0 ** (-range_db / 20.0))


def echo(x, delay: int, feedback: float, wet: float, dry: float) -> np.ndarray:
    """``s[n] = x[n] + feedback s[n-D]``, ``y[n] = dry x[n] + wet s[n-D]``,
    ``s`` zero before the first sample."""
    x = np.asarray(x, np.float64)
    C, N = x.shape
    m = -(-N // delay)
    xp = np.zeros((C, m, delay))
    xp.reshape(C, m * delay)[:, :N] = x
    s = np.zeros((C, m + 1, delay))  # row 0: before the stream
    for j in range(m):
        s[:, j + 1] = xp[:, j] + feedback * s[:, j]
    delayed = s[:, :m].reshape(C, m * delay)[:, :N]
    return dry * x + wet * delayed

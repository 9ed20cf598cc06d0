"""Streaming FIR filtering with an explicit ``(C, T-1)`` tail state.

The PyTorch counterpart of :mod:`pipe_tpu.ops.fir`, with the same
formulation. For shared taps (T >= 32, block >= 128) the signal is reframed
into ``S = 128``-sample frames treated as channels, and the FIR becomes one
``conv1d`` with ``S`` input channels, ``S`` output channels and
``ceil((T-1)/S)+1`` taps whose kernel stacks the block-Toeplitz slices of
the taps. Short or per-channel filters use a depthwise ``conv1d``.

The Toeplitz kernel is rebuilt from the live tap tensor every block, so a
``set_taps`` mutation needs no rebuild hook. Convolutions run at the
precision of :mod:`pipe_tpu_torch.config` (IEEE FP32 unless it is changed).
"""

from __future__ import annotations

import numpy as np
import torch

from pipe_tpu_torch import config
from pipe_tpu_torch.components import Processor, param_tensor
from pipe_tpu_torch.signal import Signal, zero_past


def fir_init_tail(channels: int, num_taps: int, device=None,
                  dtype=torch.float32):
    """Zero tail state ``(C, T-1)``."""
    return torch.zeros((channels, max(num_taps - 1, 0)), dtype=dtype,
                       device=device)


def _conv_valid(buf, taps_rev):
    """Depthwise valid 1D correlation. ``buf``: (C, L). ``taps_rev``: (T,)
    shared or (C, T) per-channel, already reversed so the correlation
    computes the causal convolution ``y[n] = sum_k h[k] x[n-k]``."""
    if taps_rev.ndim == 1:
        return config.conv1d(buf[:, None, :], taps_rev[None, None, :])[:, 0, :]
    C = buf.shape[0]
    return config.conv1d(buf[None], taps_rev[:, None, :], groups=C)[0]


def _toeplitz_kernel(taps, S: int, n_blk: int):
    """Stack the block-Toeplitz slices of ``taps`` into a conv kernel
    ``(S_out, S_in, n_blk)``: spatial tap ``j`` holds ``H_{n_blk-1-j}`` with
    ``H_t[i, m] = taps[t*S + i - m]`` (zero outside ``[0, T)``)."""
    T = taps.shape[-1]
    dev = taps.device
    i = torch.arange(S, device=dev)[:, None, None]
    m = torch.arange(S, device=dev)[None, :, None]
    j = torch.arange(n_blk, device=dev)[None, None, :]
    k = (n_blk - 1 - j) * S + i - m
    valid = (k >= 0) & (k < T)
    return torch.where(valid, taps[k.clamp(0, T - 1)], 0.0)


def fir_apply(tail, x, taps):
    """FIR over a fully-valid block: ``tail`` (C, T-1) left context, ``x``
    (C, B). Returns y (C, B)."""
    C, B = x.shape
    T = taps.shape[-1]
    if taps.ndim != 1 or T < 32 or B < 128:
        buf = torch.cat([tail, x], dim=1)
        return _conv_valid(buf, torch.flip(taps, (-1,)))
    S = 128
    Bp = -(-B // S) * S
    n_blk = -(-(T - 1) // S) + 1
    pad = S * (n_blk - 1)
    kern = _toeplitz_kernel(taps, S, n_blk)
    xp = x.new_zeros((C, pad + Bp))
    xp[:, pad - (T - 1): pad] = tail
    xp[:, pad: pad + B] = x
    lhs = xp.reshape(C, n_blk - 1 + Bp // S, S).transpose(1, 2)  # (C, S, W')
    out = config.conv1d(lhs, kern)  # (C, S, W)
    y = out.transpose(1, 2).reshape(C, Bp)
    return y[:, :B] if Bp != B else y


def fir_block(tail, x, frames: int, taps):
    """One streaming FIR block: ``tail`` (C, T-1) carried history, ``x``
    (C, B) valid to ``frames``. Returns ``(new_tail, y)``; outputs past
    ``frames`` are garbage (same contract as the input)."""
    T = taps.shape[-1]
    xm = zero_past(x, frames)
    y = fir_apply(tail, xm, taps)
    # the stream's last T-1 valid samples start at offset `frames` in buf
    buf = torch.cat([tail, xm], dim=1)
    new_tail = buf[:, frames: frames + T - 1].contiguous()
    return new_tail, y


class FIR:
    """FIR processor factory. ``taps`` may be ``(T,)`` (shared across
    channels) or ``(C, T)`` (per-channel). Coefficients are a live parameter
    (tap shape must stay fixed across mutations)."""

    def __init__(self, taps):
        self._init_taps = param_tensor(taps)
        if self._init_taps.ndim not in (1, 2):
            raise ValueError("taps must be (T,) or (C, T)")
        self._component = None
        self._delegate = None  # set by pipe_tpu_torch.optimize.fuse
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props):
            taps = self._init_taps
            if taps.ndim == 2 and taps.shape[0] != props.channels:
                raise ValueError(
                    f"per-channel taps for {taps.shape[0]} channels, "
                    f"line has {props.channels}"
                )
            self.context = mctx
            T = taps.shape[-1]

            def step(state, params, sig: Signal):
                new_tail, y = fir_block(
                    state["tail"], sig.data, sig.frames, params["taps"]
                )
                return {"tail": new_tail}, sig.with_data(y)

            self._component = Processor(
                output=props,
                step=step,
                state={"tail": fir_init_tail(props.channels, T, props.device)},
                params={"taps": taps.to(props.device)},
            )
            return self._component

        alloc.fusion_tag = ("fir", self)
        return alloc

    def set_taps(self, taps):
        if self._delegate is not None:  # fused away by optimize.fuse
            return self._delegate.set_taps(taps)

        def fn():
            cur = self._component.get_param("taps")
            self._component.set_param("taps", param_tensor(taps, cur.device))

        return self.context.mutate(fn)


def design_lowpass(num_taps: int, cutoff: float, sample_rate: float) -> np.ndarray:
    """Windowed-sinc (Hamming) lowpass design, float64 on the host."""
    if num_taps < 1:
        raise ValueError("num_taps must be >= 1")
    fc = cutoff / sample_rate
    n = np.arange(num_taps, dtype=np.float64) - (num_taps - 1) / 2.0
    h = 2.0 * fc * np.sinc(2.0 * fc * n)
    h *= np.hamming(num_taps)
    h /= np.sum(h)
    return h

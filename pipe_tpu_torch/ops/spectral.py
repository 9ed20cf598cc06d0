"""Streaming STFT processing: windowed overlap-add spectral ops.

The PyTorch counterpart of :mod:`pipe_tpu.ops.spectral`, with the same
state: a streaming STFT -> per-bin transform -> weighted-OLA resynthesis
engine with exact COLA normalization, and two processors on it (a per-bin
gain curve and a spectral noise gate).

All analysis windows of a block are framed into a ``(C, F, W)`` tensor by
shifted reshapes and transformed by one batched rfft (cuFFT on the card);
the overlap-add fold is a ``W/hop``-step shift-and-add over hop-sized
panes.

Streaming contract. The engine has the real-time STFT latency of
``W - hop`` samples. Any block size and any mid-stream partial frame count
are exact: the hop grid anchors to the absolute stream position, samples
short of the next hop boundary ride a residue carry, and output is emitted
in whole hops, so a block may emit fewer or more samples than it consumed
(possibly none). The residue count ``nres`` is a host int, so the number
of windows a block completes and the frames it emits are host ints too.
Per-window transforms must be memoryless across windows.
"""

from __future__ import annotations

import numpy as np
import torch

from pipe_tpu_torch.components import Processor, param_tensor
from pipe_tpu_torch.ops.prims import dynamic_slice
from pipe_tpu_torch.signal import Signal, zero_past


def design_stft_window(window_size: int, hop: int):
    """Periodic-Hann analysis/synthesis window pair with exact weighted-OLA
    normalization, designed in float64 on the host.

    Returns float32 ``(w_analysis, w_synthesis)`` of shape ``(W,)`` with
    ``sum_j w_a[t - j*hop] * w_s[t - j*hop] == 1`` for every steady-state
    ``t``.
    """
    W, H = int(window_size), int(hop)
    if W <= 0 or H <= 0 or W % H != 0:
        raise ValueError("window_size must be a positive multiple of hop")
    n = np.arange(W, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / W)  # periodic Hann
    if W == H:  # rectangular degenerate case: no overlap
        w = np.ones(W, np.float64)
    # norm[r] = sum_j w[r + j*H]^2, constant per residue class mod H
    den = (w.reshape(W // H, H) ** 2).sum(axis=0)
    if np.any(den <= 0):
        raise ValueError("window/hop pair is not invertible (zero overlap sum)")
    w_s = w / np.tile(den, W // H)
    return w.astype(np.float32), w_s.astype(np.float32)


def frame_hops(ext, window_size: int, hop: int, n_frames: int):
    """Frame ``ext`` (C, W-H + F*H) into (C, F, W) hop-aligned windows:
    window f = ext[:, f*H : f*H + W], built from ``K = W/H`` shifted
    hop-pane reshapes concatenated on the last axis."""
    C = ext.shape[0]
    W, H, F = window_size, hop, n_frames
    panes = [ext[:, k * H: k * H + F * H].reshape(C, F, H)
             for k in range(W // H)]
    return torch.cat(panes, dim=-1)


def stft_frames(hist, x, window, hop: int):
    """Frame ``cat([hist, x])`` into hop-aligned windows and analyze.

    ``hist``: (C, W-H) carried samples; ``x``: (C, B) with ``B % hop == 0``.
    Returns ``(re, im)`` planes of shape (C, F, bins), F = B // hop.
    """
    B = x.shape[1]
    W = window.shape[0]
    ext = torch.cat([hist, x], dim=1)
    spec = torch.fft.rfft(frame_hops(ext, W, hop, B // hop) * window, dim=-1)
    return spec.real.contiguous(), spec.imag.contiguous()


def _ola_fold(out, hop: int):
    """Overlap-add windows back to samples: ``out`` (C, F, W) with frame f
    at offset f*hop -> (C, F*hop + W - hop)."""
    C, F, W = out.shape
    K = W // hop
    panes = out.reshape(C, F, K, hop)
    acc = out.new_zeros((C, F + K - 1, hop))
    for k in range(K):
        acc[:, k: k + F] += panes[:, :, k]
    return acc.reshape(C, (F + K - 1) * hop)


def spectral_block(state, x, frames: int, transform, window_a, window_s,
                   hop: int):
    """One streaming spectral block: STFT -> ``transform`` -> weighted OLA,
    for any block size and any valid frame count.

    The carried ``hist`` holds the last ``W - H`` processed samples plus up
    to ``H - 1`` residue samples short of the next hop boundary (``nres``);
    a block completes ``hops = (nres + frames) // H`` new windows and
    emits exactly ``hops * H`` samples.

    Args:
      state: ``hist`` (C, W-1) input history and residue, ``nres`` (host
        int) residue count, ``tail`` (C, W-H) pending OLA output.
      x: (C, B) input block, valid to ``frames`` (host int).
      transform: ``(re, im) -> (re, im)`` over (C, F, bins) planes.
      window_a / window_s: (W,) analysis / synthesis windows.
      hop: hop size.

    Returns ``(new_state, (y, out_frames))``: ``y`` of width
    ``ceil((B + H - 1)/H) * H``, valid to ``out_frames = hops * H``.
    """
    C, B = x.shape
    W = window_a.shape[0]
    H = hop
    L = W - H
    R = H - 1  # residue capacity
    F_cap = (B + R) // H  # most windows a block can complete
    xm = zero_past(x, frames)

    nres = state["nres"]
    hops = (nres + frames) // H
    new_nres = nres + frames - hops * H

    # assembly: [hist + residue (L+R) | x at offset L + nres]; the extra R
    # columns keep the new-hist window (start hops*H, width L+R) inside
    ext = xm.new_zeros((C, L + 2 * R + B))
    ext[:, : L + R] = state["hist"]
    ext[:, L + nres: L + nres + B] = xm

    wins = frame_hops(ext, W, H, F_cap) * window_a  # (C, F_cap, W)
    spec = torch.fft.rfft(wins, dim=-1)
    re, im = transform(spec.real, spec.imag)
    out = torch.fft.irfft(torch.complex(re, im), n=W, dim=-1) * window_s
    out[:, hops:] = 0.0  # a window is complete iff its newest hop arrived

    acc = _ola_fold(out, H)  # (C, F_cap*H + L)
    emitted = hops * H
    if L > 0:
        acc[:, :L] += state["tail"]
        new_tail = dynamic_slice(acc, emitted, L)
    else:
        new_tail = state["tail"]
    new_hist = dynamic_slice(ext, emitted, L + R)
    new_state = {"hist": new_hist, "nres": new_nres, "tail": new_tail}
    return new_state, (acc[:, : F_cap * H], emitted)


def spectral_out_capacity(block_size: int, hop: int) -> int:
    """Output width per block: whole hops covering ``block_size`` (so
    ``>= block_size``)."""
    return ((block_size + hop - 1) // hop) * hop


def spectral_init_state(channels: int, window_size: int, hop: int,
                        device=None):
    """Zero state: input history and residue (C, W-1), the residue count
    (host int) and the pending OLA tail (C, W-H)."""
    L = window_size - hop
    return {
        "hist": torch.zeros((channels, L + hop - 1), dtype=torch.float32,
                            device=device),
        "nres": 0,
        "tail": torch.zeros((channels, L), dtype=torch.float32,
                            device=device),
    }


class _SpectralBase:
    """Shared allocator plumbing of the STFT processors."""

    def __init__(self, window_size: int, hop: int):
        self.window_size = int(window_size)
        self.hop = int(hop)
        self._wa, self._ws = design_stft_window(self.window_size, self.hop)
        self._component = None
        self.context = None

    @property
    def bins(self) -> int:
        return self.window_size // 2 + 1

    @property
    def latency(self) -> int:
        """Group delay in samples (W - hop)."""
        return self.window_size - self.hop

    def _make_processor(self, props, block_size, params, transform):
        wa = torch.from_numpy(self._wa).to(props.device)
        ws = torch.from_numpy(self._ws).to(props.device)
        hop = self.hop

        def step(state, p, sig: Signal):
            new_state, (y, out_frames) = spectral_block(
                state, sig.data, sig.frames,
                lambda re, im: transform(re, im, p), wa, ws, hop,
            )
            return new_state, Signal(y, out_frames)

        self._component = Processor(
            output=props,
            step=step,
            state=spectral_init_state(props.channels, self.window_size, hop,
                                      props.device),
            params={k: v.to(props.device) for k, v in params.items()},
            # whole hops covering the block: downstream ops size to it
            out_capacity=spectral_out_capacity(block_size, hop),
        )
        return self._component

    def _setter(self, name: str, value):
        return self.context.mutate(
            lambda: self._component.replace_param(name, value))


class SpectralGain(_SpectralBase):
    """Per-bin gain curve applied in the STFT domain.

    ``gains`` is ``(bins,)`` shared or ``(C, bins)`` per-channel, a live
    param. With ``gains == 1`` the engine reconstructs the input (to
    float32/FFT rounding) delayed by ``window_size - hop`` samples.
    """

    def __init__(self, window_size: int, hop: int, gains=None):
        super().__init__(window_size, hop)
        if gains is None:
            gains = np.ones(self.bins, np.float32)
        g = param_tensor(gains)
        if g.ndim not in (1, 2) or g.shape[-1] != self.bins:
            raise ValueError(
                f"gains must be (bins,) or (C, bins) with bins={self.bins}")
        self._init_gains = g

    def processor(self):
        def alloc(mctx, block_size, props):
            g = self._init_gains
            if g.ndim == 2 and g.shape[0] != props.channels:
                raise ValueError(
                    f"per-channel gains for {g.shape[0]} channels, "
                    f"line has {props.channels}"
                )
            self.context = mctx

            def transform(re, im, p):
                gg = p["gains"]
                gg = gg[None, None, :] if gg.ndim == 1 else gg[:, None, :]
                return re * gg, im * gg

            return self._make_processor(props, block_size, {"gains": g},
                                        transform)

        return alloc

    def set_gains(self, gains):
        """Swap the bin-gain curve mid-stream (same shape)."""
        return self._setter("gains", gains)


class SpectralGate(_SpectralBase):
    """Per-bin noise gate (downward spectral expander).

    Bins whose magnitude falls below ``threshold`` (linear amplitude) are
    attenuated by ``reduction_db``, with a knee of ``knee_db`` around the
    threshold. Threshold and reduction are live params. Per-window gains
    are memoryless, so gating does not depend on the block size.
    """

    def __init__(self, window_size: int, hop: int, threshold: float,
                 reduction_db: float = -80.0, knee_db: float = 6.0):
        super().__init__(window_size, hop)
        self._init_params = {
            "threshold": param_tensor(threshold),
            "reduction_db": param_tensor(reduction_db),
        }
        self.knee_db = float(knee_db)

    def processor(self):
        def alloc(mctx, block_size, props):
            self.context = mctx
            knee = max(self.knee_db, 1e-3)

            def transform(re, im, p):
                mag = torch.sqrt(re * re + im * im) + 1e-30
                over_db = 20.0 * torch.log10(mag / p["threshold"])
                # 0 -> reduction, 1 -> unity across the knee
                frac = torch.clamp(over_db / knee + 0.5, 0.0, 1.0)
                floor = 10.0 ** (p["reduction_db"] / 20.0)
                gain = floor + (1.0 - floor) * frac
                return re * gain, im * gain

            return self._make_processor(props, block_size,
                                        dict(self._init_params), transform)

        return alloc

    def set_threshold(self, threshold: float):
        return self._setter("threshold", threshold)

    def set_reduction(self, reduction_db: float):
        return self._setter("reduction_db", reduction_db)

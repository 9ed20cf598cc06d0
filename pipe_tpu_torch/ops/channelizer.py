"""Polyphase DFT filterbank channelizer (critically sampled analysis bank):
splits a wideband stream into K uniformly spaced subbands, each lowpass
filtered and decimated by K.

The PyTorch counterpart of :mod:`pipe_tpu.ops.channelizer`, with the same
state and output layout. The k-th channel is
``y_k[m] = sum_n x[n] e^{-j2πkn/K} h[mK - n]``; with ``n = rK + p``,

    u_p[m] = sum_r x[rK + p] * g_p[m - r],   g_p[s] = h[sK - p]
    y[k, m] = DFT_K over p of u_p[m]

so the bank is K branch FIRs (one grouped ``conv1d`` at the precision of
:mod:`pipe_tpu_torch.config`) followed by an rfft across the
branches, which gives the K/2+1 unique bins of a real input.

The Processor emits ``C * 2 * (K//2+1)`` output channels at rate ``sr/K``,
ordered ``[c0_bin0_re, c0_bin0_im, c0_bin1_re, ..., c1_bin0_re, ...]``;
:func:`split_bins` reassembles ``(C, K//2+1, M)`` complex on the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pipe_tpu_torch import config
from pipe_tpu_torch.components import Processor, param_tensor
from pipe_tpu_torch.ops.prims import dynamic_slice
from pipe_tpu_torch.signal import Signal, SignalProperties, zero_past


def design_prototype(num_channels: int, taps_per_branch: int = 16,
                     beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc prototype lowpass for a K-channel bank, cutoff
    at the channel Nyquist (1/(2K)); float64 on the host."""
    import scipy.signal

    K = num_channels
    h = scipy.signal.firwin(K * taps_per_branch, 1.0 / K, window=("kaiser", beta))
    return np.asarray(h, np.float64)


def polyphase_branches(h: np.ndarray, num_channels: int) -> np.ndarray:
    """Branch filters ``g_p[s] = h[sK - p]`` as a ``(K, S)`` array
    (``S = ceil(P/K) + 1``, zero where ``sK - p`` is out of range)."""
    K = num_channels
    P = h.shape[0]
    S = -(-P // K) + 1
    g = np.zeros((K, S), np.float64)
    for p in range(K):
        for s in range(S):
            idx = s * K - p
            if 0 <= idx < P:
                g[p, s] = h[idx]
    return g


def channelize_block(hist, x, gp, num_channels: int):
    """One aligned window through the bank.

    ``hist``: ``(C, K*(S-1))`` carried input samples ending at a polyphase
    group boundary; ``x``: ``(C, W)`` with ``W % K == 0``; ``gp``: ``(K, S)``
    branch filters. Returns ``(re, im)``, each ``(C, K//2+1, W//K)``.
    """
    K = num_channels
    C, W = x.shape
    S = gp.shape[1]
    if W % K:
        raise ValueError(f"window must be a multiple of K={K}, got {W}")
    M = W // K
    ctx = torch.cat([hist, x], dim=1)  # (C, K*(S-1) + W)
    # frames[c, r, p] = ctx[rK + p]; branch p's input is frames[:, :, p]
    frames = ctx.reshape(C, S - 1 + M, K)
    # u_p[m] = sum_s frames[c, (S-1) + m - s, p] * gp[p, s]: one grouped
    # conv over the frame axis
    u = config.conv1d(frames.transpose(1, 2),
                      torch.flip(gp, (-1,))[:, None, :], groups=K)  # (C, K, M)
    Y = torch.fft.rfft(u.transpose(1, 2), dim=-1).transpose(1, 2)
    return Y.real, Y.imag  # (C, K//2+1, M)


def split_bins(data: np.ndarray, num_channels: int) -> np.ndarray:
    """Host helper: reassemble the Processor's stacked-channel output
    ``(C*2*(K//2+1), M)`` into complex ``(C, K//2+1, M)``."""
    bins = num_channels // 2 + 1
    C = data.shape[0] // (2 * bins)
    d = data.reshape(C, bins, 2, -1)
    return d[:, :, 0, :] + 1j * d[:, :, 1, :]


class Channelizer:
    """K-channel analysis filterbank processor. The prototype filter is a
    live param (same length across retunes)."""

    def __init__(self, num_channels: int, taps_per_branch: int = 16):
        if num_channels < 2 or num_channels % 2:
            raise ValueError("num_channels must be even and >= 2")
        self.num_channels = num_channels
        self.taps_per_branch = taps_per_branch
        self._gp = param_tensor(polyphase_branches(
            design_prototype(num_channels, taps_per_branch), num_channels))
        self._component = None
        self.context = None

    def processor(self):
        K = self.num_channels
        S = int(self._gp.shape[1])
        bins = K // 2 + 1

        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            C, B = props.channels, block_size
            H = K * (S - 1)
            Wcap = -(-(B + K - 1) // K) * K  # >= pcnt + frames

            def step(state, params, sig: Signal):
                # A mid-stream partial block leaves the stream at any
                # position mod K, so up to K-1 valid samples are held over
                # ("pend") until the next block completes their polyphase
                # group, keeping the phase assignment exact; the same
                # carry absorbs a block size that is not a multiple of K.
                xm = zero_past(sig.data, sig.frames)
                pcnt = state["pcnt"]
                # tail region: [pend(:pcnt) | xm | zeros], whole groups
                tailp = xm.new_zeros((C, Wcap + B))
                tailp[:, :pcnt] = state["pend"][:, :pcnt]
                tailp[:, pcnt: pcnt + B] = xm
                total = pcnt + sig.frames
                g = total // K  # whole groups ready

                re, im = channelize_block(state["hist"], tailp[:, :Wcap],
                                          params["gp"], K)
                out = torch.stack([re, im], dim=2).reshape(C * bins * 2,
                                                           Wcap // K)
                # advance: the processed stream ends at group boundary g*K
                ctx = torch.cat([state["hist"], tailp[:, : Wcap + K - 1]],
                                dim=1)
                new_state = {
                    "hist": dynamic_slice(ctx, g * K, H),
                    "pend": dynamic_slice(ctx, H + g * K, K - 1),
                    "pcnt": total - g * K,
                }
                return new_state, Signal(out, g)

            self._component = Processor(
                output=dataclasses.replace(
                    props, sample_rate=props.sample_rate / K,
                    channels=C * bins * 2),
                step=step,
                state={
                    "hist": torch.zeros((C, H), dtype=torch.float32,
                                        device=props.device),
                    "pend": torch.zeros((C, K - 1), dtype=torch.float32,
                                        device=props.device),
                    "pcnt": 0,
                },
                params={"gp": self._gp.to(props.device)},
                out_capacity=Wcap // K,  # decimated group width
            )
            return self._component

        return alloc

    def set_prototype(self, h):
        """Swap the prototype lowpass mid-stream (same length)."""
        gp = polyphase_branches(np.asarray(h, np.float64), self.num_channels)
        return self.context.mutate(
            lambda: self._component.replace_param("gp", gp))

"""Streaming polyphase resampler (L/M rational rate change).

The PyTorch counterpart of :mod:`pipe_tpu.ops.resample`. For output index
``j`` at upsampled position ``u = off + j*M``: phase ``p = u % L`` selects
the subfilter and ``n0 = u // L`` the newest input sample,

    y[j] = sum_i hp[p, i] * x[n0 - i]        (hp: (L, K) polyphase bank)

Full blocks with ``B % M == 0`` at zero phase offset take the supercycle
path (:func:`resample_apply`): frames of ``M`` inputs become channels and
the whole bank is one 2-tap ``conv1d`` with the ``(K-1+M, L)`` matrix ``W``,
rebuilt from the live bank every block. Partial blocks and phase offsets
take the gather path. The phase offset ``off`` is a host int, so the choice
between the two is a host branch (the JAX package's ``lax.cond``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from pipe_tpu_torch.components import Processor, param_tensor
from pipe_tpu_torch.signal import Signal, SignalProperties, zero_past


def polyphase_design(
    up: int, down: int, taps_per_phase: int = 32, beta: float = 12.0
) -> np.ndarray:
    """Design the polyphase bank ``(L, K)`` for an L/M rate change, float64
    host-side: a Kaiser-windowed sinc prototype at the upsampled rate with
    its cutoff at 94% of the smaller Nyquist."""
    import scipy.signal

    L, M = up, down
    K = taps_per_phase
    cutoff = 0.94 * min(0.5, L / (2.0 * M))
    h = scipy.signal.firwin(K * L, cutoff, window=("kaiser", beta), fs=float(L))
    h = np.asarray(h, np.float64) * L
    return h.reshape(K, L).T.copy()  # hp[p, i] = h[i*L + p]


def _reduce_ratio(up: int, down: int):
    g = math.gcd(up, down)
    return up // g, down // g


def resample_apply(hist, x, hp, up: int, down: int):
    """Full-block polyphase resample (hot path).

    ``hist``: ``(C, K-1)`` carried input history; ``x``: ``(C, B)`` with
    ``B % down == 0``; ``hp``: ``(L, K)`` bank. Returns ``(C, B*L//M)``.
    Each frame of ``M`` inputs (one supercycle, the JAX package's default
    ``group=1``) is one conv channel frame.
    """
    L, M = up, down
    C, B = x.shape
    K = hp.shape[1]
    if B % M:
        raise ValueError(f"resample_apply needs B % {M} == 0, got B={B}")
    dev = x.device

    # W[j, q] = hp[(q*M) % L, K-1 + (q*M)//L - j], zero outside the window
    q = torch.arange(L, device=dev)
    ph = (q * M) % L
    n0 = (q * M) // L
    j = torch.arange(K - 1 + M, device=dev)
    kidx = (K - 1 + n0)[None, :] - j[:, None]  # (K-1+M, L)
    valid = (kidx >= 0) & (kidx < K)
    W = torch.where(valid, hp[ph[None, :], kidx.clamp(0, K - 1)], 0.0)

    # split W rows into M-sized frames -> conv taps (n_blk == 2 unless the
    # history exceeds one supercycle)
    n_blk = -(-(K - 1) // M) + 1
    Wp = W.new_zeros((n_blk * M, L))
    Wp[-(K - 1 + M):, :] = W
    rhs = torch.stack(
        [Wp[jj * M: (jj + 1) * M, :].T for jj in range(n_blk)], dim=-1
    )  # (L, M, n_blk)

    pad = (n_blk - 1) * M
    xp = x.new_zeros((C, pad + B))
    if K > 1:
        xp[:, pad - (K - 1): pad] = hist
    xp[:, pad:] = x
    lhs = xp.reshape(C, n_blk - 1 + B // M, M).transpose(1, 2)  # (C, M, W')
    out = F.conv1d(lhs, rhs)  # (C, L, B // M)
    return out.transpose(1, 2).reshape(C, B * L // M)


def resample_gather(hist, off: int, f: int, xm, hp, up: int, down: int,
                    out_width: int):
    """General path: any frame count ``f``, any phase offset ``off``.
    Returns ``(y (C, out_width), n_out, new_hist, new_off)``."""
    L, M = up, down
    C = xm.shape[0]
    K = hp.shape[1]
    dev = xm.device
    ctx = torch.cat([hist, xm], dim=1)  # (C, K-1+B)
    # outputs with upsampled position u = off + t*M < f*L
    t = torch.arange(out_width, device=dev)
    u = off + t * M
    n_out = max(0, (f * L - off + (M - 1)) // M)
    p = u % L
    n0 = u // L
    ii = torch.arange(K, device=dev)
    gidx = ((K - 1 + n0)[:, None] - ii[None, :]).clamp(0, ctx.shape[1] - 1)
    windows = ctx[:, gidx]  # (C, out_width, K)
    coefs = hp[p]  # (out_width, K)
    y = torch.einsum("cbk,bk->cb", windows, coefs)
    new_hist = ctx[:, f: f + K - 1].contiguous()
    new_off = off + n_out * M - f * L
    return y, n_out, new_hist, new_off


class Resampler:
    """Polyphase resampling processor: input rate * up/down."""

    def __init__(self, up: int, down: int, taps_per_phase: int = 32):
        if up <= 0 or down <= 0:
            raise ValueError("up/down must be positive")
        self.up, self.down = _reduce_ratio(up, down)
        self.taps_per_phase = taps_per_phase
        self._hp = param_tensor(
            polyphase_design(self.up, self.down, taps_per_phase)
        )
        self._component = None
        self._delegate = None  # set by pipe_tpu_torch.optimize.fuse
        self.context = None

    def processor(self):
        L, M = self.up, self.down
        K = self.taps_per_phase
        hp_init = self._hp

        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            C = props.channels
            B = block_size
            B_out = -(-B * L // M)  # ceil: max outputs per full input block
            fast_ok = B % M == 0 and B >= K - 1

            def step(state, params, sig: Signal):
                hist, off, f = state["hist"], state["off"], sig.frames
                xm = zero_past(sig.data, f)
                if fast_ok and off == 0 and f == B:
                    # steady state: full block, zero phase offset
                    y = resample_apply(hist, xm, params["hp"], L, M)
                    new_state = {
                        "hist": xm[:, B - (K - 1):].contiguous(), "off": 0,
                    }
                    return new_state, Signal(y, B * L // M)
                y, n_out, new_hist, new_off = resample_gather(
                    hist, off, f, xm, params["hp"], L, M, B_out
                )
                return {"hist": new_hist, "off": new_off}, Signal(y, n_out)

            self._component = Processor(
                output=dataclasses.replace(
                    props, sample_rate=props.sample_rate * L / M
                ),
                step=step,
                state={
                    "hist": torch.zeros((C, K - 1), dtype=torch.float32,
                                        device=props.device),
                    "off": 0,
                },
                params={"hp": hp_init.to(props.device)},
                out_capacity=B_out,  # downstream ops size to this width
            )
            return self._component

        alloc.fusion_tag = ("resample", self)
        return alloc

    def set_bank(self, hp):
        """Replace the polyphase bank mid-stream (same (L, K) shape)."""
        if self._delegate is not None:  # fused away by optimize.fuse
            return self._delegate.set_bank(hp)

        def fn():
            cur = self._component.get_param("hp")
            self._component.set_param("hp", param_tensor(hp, cur.device))

        return self.context.mutate(fn)

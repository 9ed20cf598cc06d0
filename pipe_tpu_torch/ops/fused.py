"""Fused FIR -> polyphase-resample stage.

The PyTorch counterpart of :mod:`pipe_tpu.ops.fused` (the FIR/resampler
part). A FIR followed by an L/M polyphase resampler is one polyphase bank:
with ``h`` the FIR taps and ``hp[p]`` the resampler's phase-``p`` subfilter,
the combined bank is ``hc[p] = conv(hp[p], h)`` (``K + T - 1`` taps per
phase). The bank is recombined from the live taps and bank every block, so
``set_taps`` / ``set_bank`` mutations need no rebuild hook.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pipe_tpu_torch.components import Processor, param_tensor
from pipe_tpu_torch.signal import Signal, SignalProperties
from pipe_tpu_torch.ops.resample import (
    Resampler,
    _reduce_ratio,
    polyphase_design,
    resample_apply,
)


def combine_bank(taps, hp):
    """Combined polyphase bank ``hc[p] = conv(hp[p], taps)``: ``taps``
    ``(T,)``, ``hp`` ``(L, K)`` -> ``(L, K + T - 1)``."""
    T = taps.shape[-1]
    out = F.conv1d(hp[:, None, :], torch.flip(taps, (0,))[None, None, :],
                   padding=T - 1)
    return out[:, 0, :]


class FIRResampler:
    """Fused FIR + L/M resampler processor: a drop-in for ``FIR(taps)``
    followed by ``Resampler(up, down)`` with identical output (to f32
    rounding) and one fewer stage. Both the FIR taps and the resampler bank
    stay live parameters."""

    def __init__(self, taps, up: int, down: int, taps_per_phase: int = 32):
        self._taps = param_tensor(taps)
        if self._taps.ndim != 1:
            raise ValueError("FIRResampler uses shared (T,) taps")
        if up <= 0 or down <= 0:
            raise ValueError("up/down must be positive")
        self.up, self.down = _reduce_ratio(up, down)
        self.taps_per_phase = taps_per_phase
        self._hp = param_tensor(
            polyphase_design(self.up, self.down, taps_per_phase)
        )
        self._component = None
        self.context = None

    def processor(self):
        L, M = self.up, self.down
        T = self._taps.shape[0]
        Kc = self.taps_per_phase + T - 1

        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            # reuse the Resampler's streaming step with the combined bank,
            # recombined from the live taps/hp params each block
            inner = Resampler.__new__(Resampler)
            inner.up, inner.down = L, M
            inner.taps_per_phase = Kc
            inner._hp = combine_bank(self._taps, self._hp)
            inner._component = None
            inner.context = None
            comp = inner.processor()(mctx, block_size, props)
            base_step = comp.step

            def step(state, params, sig: Signal):
                hc = combine_bank(params["taps"], params["hp_base"])
                return base_step(state, {"hp": hc}, sig)

            self._component = Processor(
                output=comp.output,
                step=step,
                state=comp.state,
                params={
                    "taps": self._taps.to(props.device),
                    "hp_base": self._hp.to(props.device),
                },
                out_capacity=comp.out_capacity,
            )
            return self._component

        return alloc

    def set_taps(self, taps):
        """Replace the FIR taps (same length)."""
        def fn():
            cur = self._component.get_param("taps")
            self._component.set_param("taps", param_tensor(taps, cur.device))

        return self.context.mutate(fn)

    def set_bank(self, hp):
        """Replace the resampler prototype bank (same shape)."""
        def fn():
            cur = self._component.get_param("hp_base")
            self._component.set_param("hp_base", param_tensor(hp, cur.device))

        return self.context.mutate(fn)


def fused_apply(hist, x, taps, hp, up: int, down: int):
    """Functional fused full-block path for chunk runners: ``hist`` is
    ``(C, K+T-2)`` input history; returns ``(C, B*up//down)``."""
    return resample_apply(hist, x, combine_bank(taps, hp), up, down)

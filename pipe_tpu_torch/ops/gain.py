"""Gain — the simplest mutable processor."""

from __future__ import annotations

import torch

from pipe_tpu_torch.components import Processor, param_tensor
from pipe_tpu_torch.signal import Signal


def gain_block(x, g):
    """``x * g`` with ``g`` scalar or per-channel ``(C,)`` / ``(C, 1)``."""
    g = torch.as_tensor(g, dtype=x.dtype, device=x.device)
    if g.ndim == 1:
        g = g[:, None]
    return x * g


class Gain:
    """Gain processor factory. ``gain`` may be a scalar or per-channel
    vector; :meth:`set_gain` returns a mutation for live adjustment."""

    def __init__(self, gain=1.0):
        self._init_gain = gain
        self._component = None
        self._delegate = None  # set by pipe_tpu_torch.optimize.fuse
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props):
            self.context = mctx

            def step(state, params, sig: Signal):
                return state, sig.with_data(gain_block(sig.data, params["gain"]))

            self._component = Processor(
                output=props,
                step=step,
                state={},
                params={"gain": param_tensor(self._init_gain, props.device)},
            )
            return self._component

        alloc.fusion_tag = ("gain", self)
        return alloc

    def set_gain(self, gain):
        if self._delegate is not None:  # folded away by optimize.fuse
            return self._delegate.set_gain(gain)

        def fn():
            cur = self._component.get_param("gain")
            self._component.set_param("gain", param_tensor(gain, cur.device))

        return self.context.mutate(fn)

    @property
    def gain(self):
        if self._component is None:
            return self._init_gain
        return self._component.get_param("gain")

"""Channel mixing — matrix routing/downmix over the channel axis."""

from __future__ import annotations

import dataclasses

import torch

from pipe_tpu_torch.components import Processor, param_tensor
from pipe_tpu_torch.signal import Signal, SignalProperties


def channel_mix_block(x, m):
    """``(C_out, C_in) @ (C_in, B) -> (C_out, B)``, a plain product (FP32
    pinned by :mod:`pipe_tpu_torch.config`)."""
    return torch.matmul(m, x)


class ChannelMix:
    """Matrix mixer processor: ``out = M @ in``. ``matrix`` is a live
    parameter, so routing/levels can be changed mid-stream."""

    def __init__(self, matrix):
        self._init_matrix = param_tensor(matrix)
        if self._init_matrix.ndim != 2:
            raise ValueError("mix matrix must be 2D (out_channels, in_channels)")
        self._component = None
        self._delegate = None  # set by pipe_tpu_torch.optimize.fuse
        self.context = None

    def processor(self):
        out_channels, in_channels = self._init_matrix.shape

        def alloc(mctx, block_size, props: SignalProperties):
            if props.channels != in_channels:
                raise ValueError(
                    f"mix matrix expects {in_channels} input channels, "
                    f"line has {props.channels}"
                )
            self.context = mctx

            def step(state, params, sig: Signal):
                return state, Signal(
                    channel_mix_block(sig.data, params["matrix"]), sig.frames
                )

            self._component = Processor(
                output=dataclasses.replace(props, channels=out_channels),
                step=step,
                state={},
                params={"matrix": self._init_matrix.to(props.device)},
            )
            return self._component

        alloc.fusion_tag = ("mix", self)
        return alloc

    def set_matrix(self, matrix):
        if self._delegate is not None:  # folded away by optimize.fuse
            return self._delegate.set_matrix(matrix)

        def fn():
            cur = self._component.get_param("matrix")
            self._component.set_param("matrix", param_tensor(matrix, cur.device))

        return self.context.mutate(fn)

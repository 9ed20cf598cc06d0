"""The flagship chain: 64-channel FIR(255) -> 44.1k->48k polyphase resample
-> 2-channel mix, as a pure chunk function.

The PyTorch counterpart of :mod:`pipe_tpu.flagship`, built from the same
functional ops as the streaming runtime, so both compute the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from pipe_tpu_torch.components import param_tensor
from pipe_tpu_torch.config import resolve_device
from pipe_tpu_torch.ops.fir import design_lowpass, fir_apply, fir_init_tail
from pipe_tpu_torch.ops.fused import fused_apply
from pipe_tpu_torch.ops.mix import channel_mix_block
from pipe_tpu_torch.ops.resample import polyphase_design, resample_apply

FIR_TAPS = 255
RS_UP, RS_DOWN = 160, 147  # 44.1 kHz -> 48 kHz
RS_K = 32  # taps per polyphase phase
SAMPLE_RATE = 44100.0


def make_flagship(
    channels: int = 64, chunk: int = 147 * 64, mix_out: int = 2,
    fused: bool = True, device=None,
):
    """Build ``(fn, init_state, example_x)`` on ``device`` (``None``:
    :func:`pipe_tpu_torch.config.default_device`, the card unless the CPU
    was asked for).

    ``fn(state, x) -> (state, y)`` processes one ``(channels, chunk)`` input
    chunk into ``(mix_out, chunk*160//147)`` output, carrying filter
    history. ``chunk`` must be a multiple of 147. ``fused=True`` runs
    FIR+resample as one combined polyphase bank; ``fused=False`` keeps the
    two-stage path.
    """
    if chunk % RS_DOWN:
        raise ValueError(f"chunk must be a multiple of {RS_DOWN}")
    device = resolve_device(device)
    h = param_tensor(design_lowpass(FIR_TAPS, 4000.0, SAMPLE_RATE), device)
    hp = param_tensor(polyphase_design(RS_UP, RS_DOWN, RS_K), device)
    mix = param_tensor(np.ones((mix_out, channels)) / channels, device)

    if fused:
        Kc = RS_K + FIR_TAPS - 1

        def fn(state, x):
            (hist,) = state
            z = fused_apply(hist, x, h, hp, RS_UP, RS_DOWN)
            return (x[:, -(Kc - 1):].contiguous(),), channel_mix_block(z, mix)

        init_state = (
            torch.zeros((channels, Kc - 1), dtype=torch.float32, device=device),
        )
    else:
        def fn(state, x):
            fir_tail, rs_hist = state
            y = fir_apply(fir_tail, x, h)
            z = resample_apply(rs_hist, y, hp, RS_UP, RS_DOWN)
            new_state = (
                x[:, -(FIR_TAPS - 1):].contiguous(),
                y[:, -(RS_K - 1):].contiguous(),
            )
            return new_state, channel_mix_block(z, mix)

        init_state = (
            fir_init_tail(channels, FIR_TAPS, device),
            torch.zeros((channels, RS_K - 1), dtype=torch.float32,
                        device=device),
        )
    rng = np.random.default_rng(0)
    example_x = param_tensor(rng.standard_normal((channels, chunk)), device)
    return fn, init_state, example_x

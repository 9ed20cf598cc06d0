"""DSP operators of the port: the slice's FIR, resampler, fused
FIR+resampler, biquad EQ, gain and mix.

Each op comes in two layers, as in :mod:`pipe_tpu.ops`: a plain function
over tensors, and a Processor allocator factory that plugs it into a Line
with its streaming state in the component's ``state`` tree and its tunable
coefficients in ``params``.
"""

from pipe_tpu_torch.ops.gain import Gain, gain_block
from pipe_tpu_torch.ops.mix import ChannelMix, channel_mix_block
from pipe_tpu_torch.ops.fir import FIR, fir_block, fir_init_tail, design_lowpass
from pipe_tpu_torch.ops.resample import Resampler, polyphase_design
from pipe_tpu_torch.ops.biquad import (
    Biquad,
    biquad_block,
    design_peaking_eq,
    design_lowpass_biquad,
    design_highpass_biquad,
    design_bandpass,
    design_notch,
    design_allpass,
    design_lowshelf,
    design_highshelf,
)
from pipe_tpu_torch.ops.fused import FIRResampler, combine_bank, fused_apply

__all__ = [
    "Gain",
    "gain_block",
    "ChannelMix",
    "channel_mix_block",
    "FIR",
    "fir_block",
    "fir_init_tail",
    "design_lowpass",
    "Resampler",
    "polyphase_design",
    "Biquad",
    "biquad_block",
    "design_peaking_eq",
    "design_lowpass_biquad",
    "design_highpass_biquad",
    "design_bandpass",
    "design_notch",
    "design_allpass",
    "design_lowshelf",
    "design_highshelf",
    "FIRResampler",
    "combine_bank",
    "fused_apply",
]

"""DSP operators of the port: the op kit of :mod:`pipe_tpu.ops`.

Each op comes in two layers, as in :mod:`pipe_tpu.ops`: a plain function
over tensors, and a Processor allocator factory that plugs it into a Line
with its streaming state in the component's ``state`` tree and its tunable
coefficients in ``params``.
"""

from pipe_tpu_torch.ops.gain import Gain, gain_block
from pipe_tpu_torch.ops.mix import ChannelMix, channel_mix_block
from pipe_tpu_torch.ops.fir import FIR, fir_block, fir_init_tail, design_lowpass
from pipe_tpu_torch.ops.resample import Resampler, polyphase_design
from pipe_tpu_torch.ops.ols import OLSConvolve, ols_init_state, ols_block
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
from pipe_tpu_torch.ops.demod import (
    Oscillator,
    IQMix,
    EnvelopeDetector,
    FMDiscriminator,
    am_demod_factory,
    fm_demod_factory,
)
from pipe_tpu_torch.ops.fused import (
    BiquadCascade,
    FIRResampler,
    FIRWithGain,
    MixWithGain,
    combine_bank,
    fused_apply,
)
from pipe_tpu_torch.ops.channelizer import (
    Channelizer,
    channelize_block,
    design_prototype,
    split_bins,
)
from pipe_tpu_torch.ops.spectral import (
    SpectralGain,
    SpectralGate,
    design_stft_window,
    spectral_block,
    spectral_init_state,
    stft_frames,
)
from pipe_tpu_torch.ops.dynamics import (
    Delay,
    Compressor,
    NoiseGate,
    envelope_block,
    compressor_gain,
)

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
    "OLSConvolve",
    "ols_init_state",
    "ols_block",
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
    "Oscillator",
    "IQMix",
    "EnvelopeDetector",
    "FMDiscriminator",
    "am_demod_factory",
    "fm_demod_factory",
    "BiquadCascade",
    "FIRResampler",
    "FIRWithGain",
    "MixWithGain",
    "combine_bank",
    "fused_apply",
    "Channelizer",
    "channelize_block",
    "design_prototype",
    "split_bins",
    "SpectralGain",
    "SpectralGate",
    "design_stft_window",
    "spectral_block",
    "spectral_init_state",
    "stft_frames",
    "Delay",
    "Compressor",
    "NoiseGate",
    "envelope_block",
    "compressor_gain",
]

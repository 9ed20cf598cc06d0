"""Oscillators, mixing and demodulation.

The PyTorch counterpart of :mod:`pipe_tpu.ops.demod`, with the same state.
Phase tracking is exact integer arithmetic: the oscillator's state is the
sample index modulo the (rational) period, a host int, so the phase never
loses precision however long the stream runs. Frequencies are rational,
``freq = num/den`` cycles per sample, and the phase angle of sample n is
``2*pi * ((n * num) mod den) / den``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pipe_tpu_torch.components import Processor
from pipe_tpu_torch.ops.fir import FIR
from pipe_tpu_torch.ops.prims import dynamic_slice
from pipe_tpu_torch.signal import Signal, SignalProperties


def _rationalize(freq_hz: float, sample_rate: float, max_den: int = 1 << 20):
    """freq/sample_rate as an exact rational num/den."""
    from fractions import Fraction

    frac = Fraction(freq_hz / sample_rate).limit_denominator(max_den)
    return int(frac.numerator), int(frac.denominator)


def osc_block(n_mod: int, num: int, den: int, block_size: int, device=None):
    """Cos/sin of an exact-phase oscillator for one block.

    ``n_mod``: the current sample index modulo ``den`` (host int). Returns
    (cos, sin), each ``(block_size,)``, and the next ``n_mod``.
    """
    t = torch.arange(block_size, dtype=torch.int64, device=device)
    k = (n_mod + t) % den
    # k < den and num < den with den <= 2^14, so k*num < 2^28: exact; the
    # angle goes to float only after the modulo
    phase_idx = (k * num) % den
    angle = (2.0 * np.pi / den) * phase_idx.to(torch.float32)
    return torch.cos(angle), torch.sin(angle), (n_mod + block_size) % den


class Oscillator:
    """Ring modulator / frequency shifter: multiplies the signal by
    ``cos(2*pi*f*n/sr)`` with exact integer phase."""

    def __init__(self, freq_hz: float):
        self.freq_hz = freq_hz
        self._component = None
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            num, den = _rationalize(self.freq_hz, props.sample_rate, 1 << 14)

            def step(state, params, sig: Signal):
                c, _, n_next = osc_block(state["n"], num, den, sig.block_size,
                                         sig.data.device)
                return {"n": n_next}, sig.with_data(sig.data * c[None, :])

            self._component = Processor(output=props, step=step,
                                        state={"n": 0}, params={})
            return self._component

        return alloc


class IQMix:
    """Quadrature downconverter: (C, B) -> (2C, B) with stacked [I..., Q...]
    channel blocks, the front half of an AM/FM/SSB demodulator. Follow it
    with a lowpass FIR and a detector."""

    def __init__(self, freq_hz: float):
        self.freq_hz = freq_hz
        self._component = None
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            num, den = _rationalize(self.freq_hz, props.sample_rate, 1 << 14)

            def step(state, params, sig: Signal):
                c, s, n_next = osc_block(state["n"], num, den, sig.block_size,
                                         sig.data.device)
                i = sig.data * c[None, :]
                q = sig.data * (-s[None, :])
                return {"n": n_next}, Signal(torch.cat([i, q], dim=0),
                                             sig.frames)

            self._component = Processor(
                output=dataclasses.replace(props, channels=2 * props.channels),
                step=step,
                state={"n": 0},
                params={},
            )
            return self._component

        return alloc


def _paired_half(props: SignalProperties, what: str) -> int:
    if props.channels % 2 != 0:
        raise ValueError(f"{what} expects paired I/Q channels")
    return props.channels // 2


class EnvelopeDetector:
    """Magnitude detector over I/Q channel pairs: (2C, B) -> (C, B),
    ``sqrt(I^2 + Q^2)``. IQMix -> lowpass FIR -> EnvelopeDetector is a
    coherent AM demodulator."""

    def __init__(self):
        self._component = None
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props: SignalProperties):
            half = _paired_half(props, "EnvelopeDetector")
            self.context = mctx

            def step(state, params, sig: Signal):
                i, q = sig.data[:half], sig.data[half:]
                return state, Signal(torch.sqrt(i * i + q * q), sig.frames)

            self._component = Processor(
                output=dataclasses.replace(props, channels=half),
                step=step, state={}, params={},
            )
            return self._component

        return alloc


def am_demod_factory(carrier_hz: float, lowpass_taps) -> list:
    """Processor allocators of a coherent AM demodulator: IQ mix down ->
    lowpass both rails -> envelope. Mixing halves the baseband amplitude,
    so the output is message/2 (plus filter transients)."""
    return [
        IQMix(carrier_hz).processor(),
        FIR(lowpass_taps).processor(),
        EnvelopeDetector().processor(),
    ]


class FMDiscriminator:
    """Quadrature FM discriminator over I/Q channel pairs,
    ``(2C, B) -> (C, B)`` of instantaneous frequency in cycles/sample,

        f[n] = atan2(I[n-1]Q[n] - Q[n-1]I[n], I[n-1]I[n] + Q[n-1]Q[n]) / 2π

    (the angle of ``z[n] * conj(z[n-1])``, exact for any deviation). The
    previous I/Q sample carries across blocks."""

    def __init__(self):
        self._component = None
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props: SignalProperties):
            half = _paired_half(props, "FMDiscriminator")
            self.context = mctx

            def step(state, params, sig: Signal):
                B = sig.block_size
                # one (2C, 1+B) buffer: the carried previous sample, then
                # the block
                buf = torch.cat([state["prev"][:, None], sig.data], dim=1)
                i, q = sig.data[:half], sig.data[half:]
                ip, qp = buf[:half, :B], buf[half:, :B]  # rails shifted by 1
                re = ip * i + qp * q
                im = ip * q - qp * i
                f = torch.atan2(im, re) / (2.0 * np.pi)
                # prev <- buf[:, frames], the last valid sample
                prev = dynamic_slice(buf, sig.frames, 1)[:, 0]
                return {"prev": prev}, Signal(f, sig.frames)

            self._component = Processor(
                output=dataclasses.replace(props, channels=half),
                step=step,
                state={"prev": torch.zeros((2 * half,), dtype=torch.float32,
                                           device=props.device)},
                params={},
            )
            return self._component

        return alloc


def fm_demod_factory(carrier_hz: float, lowpass_taps) -> list:
    """Processor allocators of an FM receiver: IQ mix down -> lowpass both
    rails -> quadrature discriminator. The output is the instantaneous
    frequency deviation from ``carrier_hz`` in cycles/sample."""
    return [
        IQMix(carrier_hz).processor(),
        FIR(lowpass_taps).processor(),
        FMDiscriminator().processor(),
    ]

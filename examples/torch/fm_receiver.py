"""FM receiver by composition, in the PyTorch port: wideband in, the
channelizer splits the band, a mix matrix selects one subband's (re, im)
rails, and the quadrature discriminator recovers the message — four stock
processors, no custom code.

Run on the card: ``python examples/torch/fm_receiver.py``; on the CPU:
``python examples/torch/fm_receiver.py --cpu``. Without ``--cpu`` and
without a card it raises, as the port's entry points do.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

import pipe_tpu_torch
from pipe_tpu_torch import kernels, mock, ops
from pipe_tpu_torch.components import Source
from pipe_tpu_torch.signal import SignalProperties

SR = 48000.0
K = 16               # channelizer bands (band spacing SR/K = 3 kHz)
STATION_BIN = 5      # station carrier at 5/16 * SR = 15 kHz
DEV = 400.0          # Hz deviation
MSG_HZ = 30.0


def main():
    if "--cpu" in sys.argv:
        sys.argv.remove("--cpu")
        pipe_tpu_torch.set_default_device("cpu")
    N = 48000 * 2
    t = np.arange(N) / SR
    msg = np.sin(2 * np.pi * MSG_HZ * t)
    phase = 2 * np.pi * (STATION_BIN / K * SR) * t + (
        2 * np.pi * DEV * np.cumsum(msg) / SR
    )
    # the station, plus an interferer two bins away
    x = np.cos(phase) + 0.8 * np.cos(2 * np.pi * (7 / K) * SR * t + 1.0)
    x = x.astype(np.float32)[None, :]

    pos = [0]

    def feed(block_size):
        if pos[0] >= N:
            return None
        c = x[:, pos[0] : pos[0] + block_size]
        pos[0] += c.shape[1]
        return c

    def src_alloc(mctx, block_size):
        return Source(output=SignalProperties(SR, 1), feed=feed)

    bins = K // 2 + 1
    # select [bin_re, bin_im] out of the channelizer's stacked layout
    sel = np.zeros((2, 2 * bins), np.float32)
    sel[0, 2 * STATION_BIN] = 1.0      # I rail
    sel[1, 2 * STATION_BIN + 1] = 1.0  # Q rail
    sink = mock.Sink()

    line = pipe_tpu_torch.Line(
        source=src_alloc,
        processors=pipe_tpu_torch.Processors(
            ops.Channelizer(K).processor(),
            ops.ChannelMix(sel).processor(),
            ops.FMDiscriminator().processor(),
        ),
        sink=sink.sink(),
    )
    pipe_tpu_torch.run(512, line)  # on the default device: the card

    got_hz = sink.values[0] * (SR / K)  # cycles/subband-sample -> Hz
    sub_sr = SR / K
    m = np.sin(2 * np.pi * MSG_HZ * np.arange(got_hz.size) / sub_sr)
    settle = int(sub_sr * 0.2)
    g = got_hz[settle:-settle]
    # align for the prototype filter's group delay (~taps/2K subband samples)
    corr = max(
        abs(np.corrcoef(g, m[settle + s : settle + s + g.size])[0, 1])
        for s in range(-24, 25)
    )
    print(f"subband rate {sub_sr:.0f} Hz, {got_hz.size} demodulated samples")
    print(f"recovered deviation ~{np.percentile(np.abs(g), 95):.0f} Hz "
          f"(sent {DEV:.0f} Hz), message correlation {corr:.4f}")
    n = kernels.launch_counts()
    print(f"kernel launches: iir_tiles {n['iir_tiles']}, "
          f"biquad_section {n['biquad_section']}")


if __name__ == "__main__":
    main()

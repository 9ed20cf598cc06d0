"""Mastering chain in the PyTorch port: gate -> EQ -> compressor ->
limiter -> echo, with a live threshold push mid-stream — the dynamics op
kit end-to-end through the async runtime.

Run: ``python examples/torch/mastering_chain.py [--cpu]`` (on the card
unless ``--cpu``; with neither a card nor ``--cpu`` it raises).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

import pipe_tpu_torch
from pipe_tpu_torch import kernels, mock, ops
from pipe_tpu_torch.components import Source
from pipe_tpu_torch.signal import SignalProperties

SR = 44100
BLOCK = 512
SECONDS = 2.0


def main():
    if "--cpu" in sys.argv:
        sys.argv.remove("--cpu")
        pipe_tpu_torch.set_default_device("cpu")
    # program material: a 220 Hz tone with a loud burst and a quiet tail
    n = int(SR * SECONDS)
    t = np.arange(n) / SR
    x = 0.25 * np.sin(2 * np.pi * 220 * t)
    x[n // 4 : n // 2] *= 3.2          # loud section to compress/limit
    x[3 * n // 4 :] *= 0.002           # quiet tail for the gate
    x = x.astype(np.float32)[None, :]

    pos = [0]

    def feed(block_size):
        if pos[0] >= n:
            return None
        chunk = x[:, pos[0] : pos[0] + block_size]
        pos[0] += chunk.shape[1]
        return chunk

    def src_alloc(mctx, block_size):
        return Source(output=SignalProperties(SR, 1), feed=feed)

    gate = ops.NoiseGate(threshold_db=-45.0, range_db=60.0)
    # two EQ bands: optimize.fuse collapses adjacent biquads into ONE
    # cascade component (set_sos on either object keeps working)
    eq = ops.Biquad(ops.design_peaking_eq(SR, freq=2000, q=1.0, gain_db=3.0))
    eq_lo = ops.Biquad(ops.design_lowshelf(SR, freq=120, gain_db=1.5))
    comp = ops.Compressor(threshold_db=-14.0, ratio=4.0, attack_ms=3.0,
                          release_ms=120.0, makeup_db=2.0)
    lim = ops.Compressor(threshold_db=-3.0, ratio=np.inf, attack_ms=0.2,
                         release_ms=60.0)
    echo = ops.Delay(delay_frames=SR // 4, feedback=0.35, wet=0.25, dry=1.0)
    sink = mock.Sink()

    line = pipe_tpu_torch.optimize.fuse(pipe_tpu_torch.Line(
        source=src_alloc,
        processors=pipe_tpu_torch.Processors(
            gate.processor(), eq_lo.processor(), eq.processor(),
            comp.processor(), lim.processor(), echo.processor(),
        ),
        sink=sink.sink(),
    ))
    p = pipe_tpu_torch.Pipe(BLOCK, line)
    p.start()
    time.sleep(0.4)
    # ride the compressor threshold live — lands at a block boundary
    p.push(comp.set(threshold_db=-20.0))
    p.wait(120)

    out = sink.values[0]
    peak_db = 20 * np.log10(np.abs(out).max() + 1e-12)
    tail_db = 20 * np.log10(np.abs(out[-SR // 8 :]).max() + 1e-12)
    print(f"processed {out.shape[0]} frames")
    print(f"peak after limiter: {peak_db:6.2f} dBFS (ceiling -3 dBFS + echo sum)")
    print(f"gated tail peak:    {tail_db:6.2f} dBFS")
    n = kernels.launch_counts()
    print(f"kernel launches: iir_tiles {n['iir_tiles']}, "
          f"biquad_section {n['biquad_section']}, "
          f"envelope_block {n['envelope_block']}")


if __name__ == "__main__":
    main()

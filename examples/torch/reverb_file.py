"""Convolution reverb over a WAV file in the PyTorch port — the
file-to-file production path.

Synthesizes a test WAV, then streams it through a 64k-tap convolution
reverb (partitioned overlap-save FFT, cuFFT on the card) + peaking EQ into
an output WAV via the native C++ reader/writer with prefetch.

Run: ``python examples/torch/reverb_file.py [--cpu] [in.wav] [out.wav]``
(the files default to the temporary directory). Without ``--cpu`` it runs
on the card, and raises where there is none.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

import pipe_tpu_torch
from pipe_tpu_torch import kernels, native, ops
from pipe_tpu_torch.io import WavSink, WavSource


def synth_input(path, sr=44100, seconds=2.0):
    t = np.arange(int(sr * seconds)) / sr
    x = 0.5 * np.sin(2 * np.pi * 440.0 * t) * np.exp(-t * 2.0)
    stereo = np.stack([x, x * 0.8]).astype(np.float32)
    w = native.WavWriter(path, 2, sr, 32)
    w.write(np.ascontiguousarray(stereo.T))
    w.close()


def reverb_line(in_path, out_path):
    """The line ``in_path -> 64k-tap reverb -> peaking EQ -> out_path``
    (float32 WAV) and its sink."""
    # Exponentially-decaying noise IR ~1.5 s at 44.1k (65536 taps).
    rng = np.random.default_rng(7)
    n = 65536
    ir = rng.standard_normal(n) * np.exp(-np.arange(n) / 12000.0) * 0.05

    src = WavSource(in_path)
    dst = WavSink(out_path, bits=32)
    reverb = ops.OLSConvolve(ir)
    eq = ops.Biquad(ops.design_peaking_eq(src.sample_rate, 2500, 0.9, -3.0))
    line = pipe_tpu_torch.Line(
        source=src.source(),
        processors=[reverb.processor(), eq.processor()],
        sink=dst.sink(),
    )
    return line, dst


def main():
    if "--cpu" in sys.argv:
        sys.argv.remove("--cpu")
        pipe_tpu_torch.set_default_device("cpu")
    tmp = tempfile.gettempdir()
    in_path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(tmp, "reverb_in.wav")
    out_path = sys.argv[2] if len(sys.argv) > 2 else os.path.join(tmp, "reverb_out.wav")
    if not os.path.exists(in_path):
        synth_input(in_path)

    line, dst = reverb_line(in_path, out_path)
    stats = pipe_tpu_torch.StatsRecorder()
    pipe_tpu_torch.run(4096, line, stats=stats, lookahead=8)
    print(f"wrote {dst.frames_written} frames to {out_path}")
    print(stats.report())
    n = kernels.launch_counts()
    print(f"kernel launches: iir_tiles {n['iir_tiles']}, "
          f"biquad_section {n['biquad_section']}")


if __name__ == "__main__":
    main()

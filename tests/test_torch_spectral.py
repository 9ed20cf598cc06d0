"""The port's STFT/OLA engine and its processors, against the JAX package
and float64 oracles.

- JAX-vs-port: ``spectral_block`` over the same seeded blocks with partial
  frame counts that are not hop multiples (including a block that emits
  nothing), from JAX's state carried with ``convert``: >= 100 dB on the
  output and the float state, ``nres`` equal.
- The twins of ``tests/test_spectral.py``, at the same bars.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipe_tpu_torch
from pipe_tpu import ops as jops
from pipe_tpu.ops import spectral as jsp
from pipe_tpu_torch import mock, ops
from pipe_tpu_torch.ops import spectral as tsp
from pipe_tpu_torch.ops.spectral import (
    SpectralGain,
    SpectralGate,
    design_stft_window,
    spectral_block,
    spectral_init_state,
)
from pipe_tpu_torch.signal import snr_db
from tests.test_torch_ops import assert_twins_agree, step_twins, stream

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

SNR_TARGET = 100.0


def stream_through(procs, x, block, sr=44100.0):
    return stream(pipe_tpu_torch, procs, x, block, sr)


def identity(re, im):
    return re, im


def run_blocks(x, window_size, hop, transform, feed):
    """Drive ``spectral_block`` over ``feed`` = [(block, frames), ...],
    taking ``frames`` fresh samples of ``x`` each; returns the emitted
    (C, M) stream and the count consumed."""
    wa, ws = (torch.from_numpy(w) for w in design_stft_window(window_size, hop))
    C = x.shape[0]
    state = spectral_init_state(C, window_size, hop)
    outs, pos = [], 0
    for block, frames in feed:
        blk = np.zeros((C, block), np.float32)
        blk[:, :frames] = x[:, pos: pos + frames]
        state, (y, out_frames) = spectral_block(
            state, torch.from_numpy(blk), frames, transform, wa, ws, hop)
        assert isinstance(out_frames, int)
        outs.append(y[:, :out_frames].numpy())
        pos += frames
    return np.concatenate(outs, axis=1), pos


def stream_blocks(x, window_size, hop, transform, block):
    """Full blocks (a partial last one) through ``spectral_block``."""
    N = x.shape[1]
    feed = [(block, min(block, N - i)) for i in range(0, N, block)]
    return run_blocks(x, window_size, hop, transform, feed)[0]


def oracle_stft(x, window_size, hop, gain_fn=None):
    """Float64 weighted-OLA oracle; ``gain_fn(spec)`` scales each window's
    spectrum (identity when None)."""
    wa, ws = design_stft_window(window_size, hop)
    wa, ws = wa.astype(np.float64), ws.astype(np.float64)
    C, N = x.shape
    ext = np.concatenate([np.zeros((C, window_size - hop)), x], axis=1)
    y = np.zeros((C, N + window_size))
    for s in range(0, N, hop):
        win = ext[:, s: s + window_size]
        if win.shape[1] < window_size:
            break
        spec = np.fft.rfft(win * wa, axis=-1)
        if gain_fn is not None:
            spec = spec * gain_fn(spec)
        y[:, s: s + window_size] += np.fft.irfft(spec, n=window_size) * ws
    return y[:, :N]


# -- JAX vs port ---------------------------------------------------------------


@pytest.mark.parametrize(
    "make",
    [lambda o: o.SpectralGain(256, 64),
     lambda o: o.SpectralGain(240, 48, gains=np.linspace(0, 1, 121)),
     lambda o: o.SpectralGate(256, 64, threshold=3.0, reduction_db=-40.0)],
    ids=["gain-unit", "gain-curve-odd-hop", "gate"],
)
def test_spectral_processors_match_jax(make):
    """Frame counts 300 and 20 are not hop multiples; 20 completes no
    window, so that block emits 0 frames in both packages."""
    chunks = [300, 300, 20, 300, 131, 300, 300]
    jout, tout, js, ts = step_twins(make(jops), make(ops), 2, 300, chunks,
                                    switch=2)
    assert [a.shape[1] for a in tout][:1] == [0]
    assert_twins_agree(jout, tout, js, ts)


def test_stft_frames_matches_jax(rng):
    wa, _ = design_stft_window(256, 64)
    hist = rng.standard_normal((2, 192)).astype(np.float32)
    x = rng.standard_normal((2, 512)).astype(np.float32)
    jre, jim = jsp.stft_frames(jnp.asarray(hist), jnp.asarray(x),
                               jnp.asarray(wa), 64)
    tre, tim = tsp.stft_frames(torch.from_numpy(hist), torch.from_numpy(x),
                               torch.from_numpy(wa), 64)
    assert tre.shape == jre.shape == (2, 8, 129)
    assert snr_db(np.asarray(jre), tre.numpy()) > 120
    assert snr_db(np.asarray(jim), tim.numpy()) > 120


# -- twins of tests/test_spectral.py -------------------------------------------


def test_window_design_exact_cola():
    for W, H in [(512, 128), (256, 64), (256, 128), (64, 16), (128, 128)]:
        wa, ws = design_stft_window(W, H)
        prod = (wa.astype(np.float64) * ws.astype(np.float64)).reshape(W // H, H)
        np.testing.assert_allclose(prod.sum(axis=0), 1.0, atol=1e-12)


def test_window_design_validates():
    with pytest.raises(ValueError):
        design_stft_window(512, 100)  # not a divisor
    with pytest.raises(ValueError):
        design_stft_window(0, 1)


def test_perfect_reconstruction(rng):
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    y = stream_blocks(x, 512, 128, identity, 512)
    L = 512 - 128
    assert snr_db(x[:, : 4096 - L].astype(np.float64), y[:, L:]) > 110


def test_matches_float64_oracle(rng):
    x = rng.standard_normal((3, 2048)).astype(np.float32)
    y = stream_blocks(x, 256, 64, identity, 256)
    ref = oracle_stft(x.astype(np.float64), 256, 64)
    assert snr_db(ref[:, : 2048 - 256], y[:, : 2048 - 256]) > SNR_TARGET


def test_block_size_invariance(rng):
    x = rng.standard_normal((2, 3072)).astype(np.float32)
    y1 = stream_blocks(x, 256, 64, identity, 256)
    y2 = stream_blocks(x, 256, 64, identity, 1024)
    np.testing.assert_allclose(y1, y2, atol=1e-5)


def test_partial_block_hop_aligned(rng):
    x = rng.standard_normal((2, 2048)).astype(np.float32)
    full = stream_blocks(x, 256, 64, identity, 512)
    feed = [(512, 512), (512, 256), (512, 512), (512, 512), (512, 256)]
    got, pos = run_blocks(x, 256, 64, identity, feed)
    np.testing.assert_allclose(got, full[:, :pos], atol=1e-5)


def test_spectral_gain_processor(rng):
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    sg = SpectralGain(window_size=512, hop=128)
    y = stream_through([sg.processor()], x, 512)
    L = sg.latency
    assert y.shape == (2, 4096)
    assert snr_db(x[:, : 4096 - L].astype(np.float64), y[:, L:]) > 110


def test_spectral_gain_shapes_spectrum():
    sr, n, W, H = 8000.0, 8192, 512, 128
    t = np.arange(n) / sr
    lo = np.sin(2 * np.pi * 200.0 * t)
    x = (lo + np.sin(2 * np.pi * 3000.0 * t)).astype(np.float32)[None, :]
    gains = np.ones(W // 2 + 1, np.float32)
    gains[int(1000.0 / sr * W):] = 0.0
    sg = SpectralGain(W, H, gains)
    y = stream_through([sg.processor()], x, 512, sr=sr)
    L = sg.latency
    steady = y[0, L + W: n - W]
    err = steady - lo[W: n - W - L]
    assert np.sqrt(np.mean(err ** 2)) < 0.02  # the 3 kHz tone is gone
    assert np.sqrt(np.mean(steady ** 2)) > 0.5  # 200 Hz survives


def test_spectral_gain_validates():
    with pytest.raises(ValueError):
        SpectralGain(512, 128, gains=np.ones(5, np.float32))
    sg = SpectralGain(512, 128, gains=np.ones((3, 257), np.float32))
    with pytest.raises(pipe_tpu_torch.AllocationError):
        stream_through([sg.processor()], np.zeros((2, 512), np.float32), 512)


def test_spectral_gate_vs_oracle(rng):
    sr, n, W, H = 8000.0, 4096, 256, 64
    t = np.arange(n) / sr
    x = (np.sin(2 * np.pi * 500.0 * t)
         + 0.01 * rng.standard_normal(n)).astype(np.float32)[None, :]
    thr, red_db, knee = 0.5, -60.0, 6.0

    def gate(re, im):
        mag = torch.sqrt(re * re + im * im) + 1e-30
        frac = torch.clamp(20.0 * torch.log10(mag / thr) / knee + 0.5, 0.0, 1.0)
        floor = 10.0 ** (red_db / 20.0)
        g = floor + (1.0 - floor) * frac
        return re * g, im * g

    def gate64(spec):
        frac = np.clip(20.0 * np.log10((np.abs(spec) + 1e-30) / thr) / knee
                       + 0.5, 0.0, 1.0)
        floor = 10.0 ** (red_db / 20.0)
        return floor + (1.0 - floor) * frac

    y = stream_blocks(x, W, H, gate, 512)
    ref = oracle_stft(x.astype(np.float64), W, H, gate64)
    L = W - H
    assert snr_db(ref[:, L: n - W], y[:, L: n - W]) > SNR_TARGET


def test_spectral_gate_denoises(rng):
    sr, n, W, H = 8000.0, 8192, 512, 128
    tone = np.sin(2 * np.pi * 500.0 * np.arange(n) / sr)
    noise = 0.003 * rng.standard_normal(n)
    x = (tone + noise).astype(np.float32)[None, :]
    gate = SpectralGate(W, H, threshold=1.0, reduction_db=-80.0)
    y = stream_through([gate.processor()], x, 512, sr=sr)
    L = gate.latency
    resid = y[0, L + W: n - W] - tone[W: n - W - L]
    assert np.sqrt(np.mean(resid ** 2)) < 0.5 * np.sqrt(np.mean(noise ** 2))


def test_spectral_gate_live_mutation(rng):
    """Threshold and reduction are live params: a retune between runs, and
    set_threshold through a mutation."""
    x = rng.standard_normal((1, 1024)).astype(np.float32)
    gate = SpectralGate(256, 64, threshold=1e-6, reduction_db=-80.0)
    y_open = stream_through([gate.processor()], x, 256)
    L = gate.latency
    assert snr_db(x[:, : 1024 - L].astype(np.float64), y_open[:, L:]) > 60
    gate.set_threshold(1e9).apply()
    assert gate._component.get_param("threshold").item() == 1e9

    gate2 = SpectralGate(256, 64, threshold=1e9, reduction_db=-80.0)
    y_shut = stream_through([gate2.processor()], x, 256)
    assert np.sqrt(np.mean(y_shut[:, L:] ** 2)) < 1e-3 * np.sqrt(np.mean(x ** 2))


def test_any_block_size_streaming(rng):
    """A block size that is not a hop multiple streams exactly: output
    emits in whole hops, catching up across blocks."""
    x = rng.standard_normal((2, 9000)).astype(np.float32)
    aligned = stream_blocks(x, 256, 64, identity, 512)
    for block in (100, 300, 509):
        got = stream_blocks(x, 256, 64, identity, block)
        n = min(got.shape[1], aligned.shape[1])
        np.testing.assert_allclose(got[:, :n], aligned[:, :n], atol=1e-5,
                                   err_msg=f"block={block}")


def test_any_partial_frames_midstream(rng):
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    full = stream_blocks(x, 256, 64, identity, 512)
    feed = [(512, 512), (512, 301), (512, 512), (512, 77), (512, 512),
            (512, 512), (512, 450)]
    got, pos = run_blocks(x, 256, 64, identity, feed)
    n = got.shape[1]  # emitted whole hops <= pos
    assert pos - n < 64
    np.testing.assert_allclose(got, full[:, :n], atol=1e-5)


def test_spectral_gain_processor_odd_block(rng):
    x = rng.standard_normal((2, 20000)).astype(np.float32)
    W, H = 1024, 256
    y = stream_through([ops.SpectralGain(W, H).processor()], x, 500)
    y2 = stream_through([ops.SpectralGain(W, H).processor()], x, 1024)
    n = min(y.shape[1], y2.shape[1])
    assert snr_db(y2[:, :n].astype(np.float64), y[:, :n]) > 130
    oracle = np.concatenate([np.zeros((2, W - H)), x.astype(np.float64)],
                            axis=1)[:, :n]
    assert snr_db(oracle, y[:, :n]) >= SNR_TARGET


def test_width_changing_chain_composition(rng):
    """Width-changing ops thread their out_capacity to the downstream
    allocators: [SpectralGain -> Delay] at an odd block, and [Resampler ->
    Delay] sized to the resampler's output width."""
    from tests.test_ops import _resample_oracle

    x = rng.standard_normal((2, 20000)).astype(np.float32)
    W, H, D = 1024, 256, 500
    y = stream_through([ops.SpectralGain(W, H).processor(),
                        ops.Delay(D).processor()], x, 500)
    src = np.concatenate([np.zeros((2, W - H + D)), x.astype(np.float64)],
                         axis=1)
    assert snr_db(src[:, : y.shape[1]], y) >= SNR_TARGET

    y2 = stream_through([ops.Resampler(160, 147).processor(),
                         ops.Delay(700).processor()], x[:, : 147 * 100], 588)
    rx = _resample_oracle(x[:, : 147 * 100].astype(np.float64),
                          ops.polyphase_design(160, 147, 32), 160, 147)
    d = np.concatenate([np.zeros((2, 700)), rx], axis=1)[:, : y2.shape[1]]
    assert snr_db(d, y2) >= SNR_TARGET


def test_insert_width_changing_processor_live():
    """Live-inserting an STFT processor whose out capacity differs from the
    block (hop 48 does not divide 512: 528) re-allocates the sink at the
    adoption boundary, and the stream keeps flowing; a width-preserving hop
    inserts with no rebuild."""
    src = mock.Source(channels=1, value=1.0, interval=0.002)
    sink = mock.Sink(discard=True)
    p = pipe_tpu_torch.Pipe(512, pipe_tpu_torch.Line(source=src.source(),
                                                     sink=sink.sink()))
    p.start()
    h = p.insert_processor(0, 0, ops.SpectralGain(240, 48).processor())
    assert h.wait(30) and h.error is None, h.error
    before = sink.samples
    deadline = time.time() + 30
    while sink.samples < before + 4 * 528:
        assert time.time() < deadline, "stream stalled after insert"
        time.sleep(0.005)
    h2 = p.insert_processor(0, 0, ops.SpectralGain(256, 64).processor())
    assert h2.wait(30) and h2.error is None
    p.stop(30)

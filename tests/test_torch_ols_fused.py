"""The port's overlap-save convolution, fused stages and double-f32 biquad,
against the JAX package and float64 oracles.

- JAX-vs-port: the same seeded blocks, with mid-stream partial blocks,
  through each op from JAX's state carried with ``convert``: linear ops
  >= 100 dB on the output and the float state, the OLS ring head ``pos``
  equal; the extended biquad >= 140 dB.
- The twins of the OLS, fused and extended-precision tests of
  ``tests/test_ops.py``.
"""

import numpy as np
import pytest
import scipy.signal
import torch

import pipe_tpu_torch
from pipe_tpu import ops as jops
from pipe_tpu.ops import fused as jfused
from pipe_tpu_torch import mutable, ops, optimize
from pipe_tpu_torch.graph import Line
from pipe_tpu_torch.ops import fused as tfused
from pipe_tpu_torch.ops.biquad import _two_prod, _two_sum
from pipe_tpu_torch.signal import Signal, SignalProperties, snr_db
from tests.test_torch_ops import assert_twins_agree, step_twins, stream

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

SNR_TARGET = 100.0
# the kappa-floor section of tests/test_ops.py and a 1 kHz section
EXT_ROWS = np.stack([
    ops.design_peaking_eq(44100, 20.0, 0.5, 6.0),
    ops.design_peaking_eq(44100, 1000.0, 4.0, -4.0),
])


def stream_through(procs, x, block, sr=44100.0):
    return stream(pipe_tpu_torch, procs, x, block, sr)


def _ir(P, seed=0, decay=300.0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(P) * np.exp(-np.arange(P) / decay)


# -- JAX vs port ---------------------------------------------------------------


def _fused_module(o):
    return jfused if o is jops else tfused


@pytest.mark.parametrize(
    "make, C, B",
    [
        (lambda o: o.OLSConvolve(_ir(1000)), 2, 256),
        (lambda o: o.OLSConvolve(np.stack([_ir(700, 1), _ir(700, 2)])), 2, 256),
        (lambda o: _fused_module(o).OLSWithGain(_ir(600), [0.5, 2.0]), 2, 256),
        (lambda o: _fused_module(o).FIRWithGain(
            o.design_lowpass(63, 4000.0, 44100.0), 0.75), 2, 256),
        (lambda o: _fused_module(o).FIRWithGain(
            o.design_lowpass(63, 4000.0, 44100.0), [0.5, 1.5]), 2, 256),
        (lambda o: _fused_module(o).MixWithGain(
            np.arange(8.0).reshape(2, 4) / 8, [1.0, 0.5, 2.0, 0.25], "in"), 4, 256),
        (lambda o: _fused_module(o).MixWithGain(
            np.arange(8.0).reshape(2, 4) / 8, [3.0, 0.5], "out"), 4, 256),
        (lambda o: _fused_module(o).FIRCascade([
            o.FIR(o.design_lowpass(31, 8000.0, 44100.0)),
            o.FIR(np.stack([o.design_lowpass(15, 3000.0, 44100.0),
                            o.design_lowpass(15, 5000.0, 44100.0)]))]), 2, 256),
        (lambda o: _fused_module(o).BiquadCascade([
            o.Biquad(o.design_peaking_eq(44100, 500, 1.0, 3.0)),
            o.Biquad(np.stack([o.design_highshelf(44100, 8000, -2.0),
                               o.design_peaking_eq(44100, 3000, 1.5, -4.0)]))]),
         2, 256),
    ],
    ids=["ols-shared", "ols-per-channel", "ols-with-gain", "fir-with-gain",
         "fir-with-per-channel-gain", "mix-with-gain-in", "mix-with-gain-out",
         "fir-cascade", "biquad-cascade"],
)
def test_linear_ops_match_jax(make, C, B):
    """The biquad cascade's carried state is 2 values per channel and
    section, from two float32 recurrence evaluations (JAX's associative
    scan, the port's prefix doubling) each ~100 dB from the truth: those
    few values are held at 90 dB, its output at 100 dB."""
    chunks = [B, B, 91, B, B, B, 40]
    top = make(ops)
    jout, tout, js, ts = step_twins(make(jops), top, C, B, chunks, switch=2)
    state_db = 90.0 if isinstance(top, tfused.BiquadCascade) else None
    assert_twins_agree(jout, tout, js, ts, state_db=state_db)


def test_extended_biquad_matches_jax():
    """Both packages form the same error-free transforms and the same
    prefix-doubling tree, so the dd recurrence agrees far past the float32
    output rounding; measured: identical outputs on the CPU."""
    chunks = [512, 512, 200, 512, 512]
    make = lambda o: o.Biquad(EXT_ROWS, precision="extended")  # noqa: E731
    jout, tout, js, ts = step_twins(make(jops), make(ops), 2, 512, chunks,
                                    switch=2)
    assert_twins_agree(jout, tout, js, ts, db=140.0)


# -- twins of tests/test_ops.py: overlap-save ----------------------------------


def test_ols_matches_direct_convolution(rng):
    ir = rng.standard_normal(2048) * np.exp(-np.arange(2048) / 300.0)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    out = stream_through([ops.OLSConvolve(ir).processor()], x, 256)
    oracle = scipy.signal.lfilter(ir, [1.0], x.astype(np.float64), axis=1)
    assert out.shape == x.shape
    assert snr_db(oracle, out) > SNR_TARGET


def test_ols_per_channel_ir(rng):
    ir = rng.standard_normal((2, 500))
    x = rng.standard_normal((2, 1024)).astype(np.float32)
    out = stream_through([ops.OLSConvolve(ir).processor()], x, 128)
    for c in range(2):
        oracle = scipy.signal.lfilter(ir[c], [1.0], x[c].astype(np.float64))
        assert snr_db(oracle, out[c]) > SNR_TARGET


def test_ols_partial_final_block(rng):
    ir = rng.standard_normal(300)
    x = rng.standard_normal((1, 700)).astype(np.float32)
    out = stream_through([ops.OLSConvolve(ir).processor()], x, 128)
    oracle = scipy.signal.lfilter(ir, [1.0], x.astype(np.float64), axis=1)
    assert out.shape == (1, 700)
    assert snr_db(oracle, out) > SNR_TARGET


def test_ols_set_ir_live(rng):
    """``set_ir`` swaps the partition spectra at a block boundary; the ring
    head and FDL carry on."""
    ir1, ir2 = _ir(400, 3), _ir(400, 4)
    conv = ops.OLSConvolve(ir1)
    comp = conv.processor()(mutable.mutable(), 128, SignalProperties(44100.0, 1))
    x = rng.standard_normal((1, 128 * 6)).astype(np.float32)
    st, ys = comp.state, []
    for i in range(6):
        if i == 3:
            conv.set_ir(ir2).apply()
        st, sig = comp.step(st, comp.params,
                            Signal(torch.from_numpy(x[:, i * 128:(i + 1) * 128]), 128))
        ys.append(sig.data.numpy())
    y = np.concatenate(ys, 1)
    o1 = scipy.signal.lfilter(ir1, [1.0], x.astype(np.float64), axis=1)
    o2 = scipy.signal.lfilter(ir2, [1.0], x.astype(np.float64), axis=1)
    assert snr_db(o1[:, :384], y[:, :384]) > SNR_TARGET
    assert snr_db(o2[:, 384:], y[:, 384:]) > SNR_TARGET
    assert st["pos"] == 6 % 4


# -- twins of tests/test_ops.py: extended precision ----------------------------


def test_dd_transforms_exact_under_jit(rng):
    """The error-free transforms capture their rounding errors exactly
    (the JAX package checks this under jit, where XLA may contract into
    FMAs; the port's eager ops round every product, and ``_two_prod``
    takes the exact product in float64)."""
    a = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    s, e = _two_sum(a, b)
    p, f = _two_prod(a, b)
    a64, b64 = a.double().numpy(), b.double().numpy()
    np.testing.assert_array_equal(s.double().numpy() + e.double().numpy(),
                                  a64 + b64)
    np.testing.assert_array_equal(p.double().numpy() + f.double().numpy(),
                                  a64 * b64)
    assert p.dtype == f.dtype == torch.float32


def test_biquad_extended_precision_breaks_kappa_floor(rng):
    """A 20 Hz q=0.5 section at 44.1 kHz has a float32 floor near 72 dB:
    the default engine cannot reach 100 dB there, the double-f32 engine
    must, across 31 block boundaries and a partial final block."""
    x = rng.standard_normal((2, 16000)).astype(np.float32)
    ref = scipy.signal.sosfilt(EXT_ROWS, x.astype(np.float64), axis=1)
    out = stream_through([ops.Biquad(EXT_ROWS, precision="extended")
                          .processor()], x, 512)
    snr = snr_db(ref, out)
    assert snr > 100, f"{snr:.1f} dB"
    out_std = stream_through([ops.Biquad(EXT_ROWS).processor()], x, 512)
    assert snr_db(ref, out_std) < 100


# -- twins of tests/test_ops.py: fused FIR + resampler, optimize on a line -----


def test_fused_fir_resampler_matches_sequential(rng):
    x = rng.standard_normal((2, 147 * 30)).astype(np.float32)
    h = ops.design_lowpass(255, 4000.0, 44100.0)
    y_seq = stream_through([ops.FIR(h).processor(),
                            ops.Resampler(160, 147).processor()], x, 588)
    y_fused = stream_through([ops.FIRResampler(h, 160, 147).processor()], x, 588)
    assert y_fused.shape == y_seq.shape
    assert snr_db(y_seq, y_fused) >= SNR_TARGET


def test_fused_fir_resampler_output_rate():
    fused = ops.FIRResampler(ops.design_lowpass(31, 4000.0, 44100.0), 48000, 44100)
    comp = fused.processor()(mutable.mutable(), 588, SignalProperties(44100.0, 2))
    assert comp.output.sample_rate == pytest.approx(48000.0)


def test_fused_set_taps_mutation_no_retrace(rng):
    """Retuning the fused stage's taps changes its output with the same
    step function (the bank is recombined from the live param)."""
    block = 147 * 4
    x = torch.from_numpy(rng.standard_normal((1, block)).astype(np.float32))
    fused = ops.FIRResampler(ops.design_lowpass(63, 4000.0, 44100.0), 160, 147)
    comp = fused.processor()(mutable.mutable(), block, SignalProperties(44100.0, 1))
    step = comp.step
    st, out1 = step(comp.state, comp.params, Signal(x, block))
    fused.set_taps(ops.design_lowpass(63, 1000.0, 44100.0)).apply()
    assert comp.step is step
    st, out2 = step(comp.state, comp.params, Signal(x, block))
    assert not np.allclose(out1.data.numpy(), out2.data.numpy())


def test_optimize_fuse_line(rng):
    """optimize.fuse collapses FIR+Resampler; output matches the unfused
    line and set_taps on the ORIGINAL object reaches the fused stage."""
    x = rng.standard_normal((1, 147 * 30)).astype(np.float32)
    h = ops.design_lowpass(101, 4000.0, 44100.0)
    y_plain = stream_through([ops.FIR(h).processor(),
                              ops.Resampler(160, 147).processor()], x, 588)
    fir, rs, gain = ops.FIR(h), ops.Resampler(160, 147), ops.Gain(1.0)
    fused_line = optimize.fuse(Line(source=None, sink=None, processors=[
        fir.processor(), rs.processor(), gain.processor()]))
    assert len(fused_line.processors) == 2  # fused + gain
    y_fused = stream_through(fused_line.processors, x, 588)
    assert snr_db(y_plain, y_fused) >= SNR_TARGET
    m = fir.set_taps(ops.design_lowpass(101, 1000.0, 44100.0))
    m.apply()
    np.testing.assert_allclose(
        fir._delegate._component.get_param("taps").numpy(),
        ops.design_lowpass(101, 1000.0, 44100.0).astype(np.float32))

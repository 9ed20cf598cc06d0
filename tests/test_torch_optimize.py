"""The port's fusion optimizer (``optimize.fuse``, ``run``/``Pipe`` with
``optimize=True``) and BASELINE config 4 at a small size, against the JAX
package and float64 oracles.

- The twins of the 14 ``tests/test_optimize.py`` tests that use no mesh,
  and of ``tests/test_block_mutations.py::
  test_insert_width_changer_into_optimized_line_retunes_survive``. Where
  the JAX test counts recompiles, the port (which compiles nothing) checks
  that the retune reaches the fused stage's params through the same step.
- The whole slice: config 4's line (Gain -> 4096-tap OLS -> peaking EQ ->
  high shelf, 2 channels, block 512) through ``run`` and through
  ``Pipe(optimize=True)`` in both packages, >= 100 dB apart, with targeted
  retunes through the ORIGINAL objects landing at the same sample.
"""

import threading
import time

import numpy as np
import pytest
import scipy.signal
import torch

import pipe_tpu
import pipe_tpu.ops
import pipe_tpu_torch
import pipe_tpu_torch.ops
from pipe_tpu_torch import mock, mutable, ops, optimize
from pipe_tpu_torch.components import Source
from pipe_tpu_torch.graph import Line
from pipe_tpu_torch.ops.fused import (
    FIRCascade,
    FIRResampler,
    FIRWithGain,
    MixWithGain,
    OLSWithGain,
)
from pipe_tpu_torch.signal import Signal, SignalProperties, snr_db
from tests.test_ops import _resample_oracle
from tests.test_torch_ops import stream

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU


def stream_through(procs, x, block, sr=44100.0):
    return stream(pipe_tpu_torch, procs, x, block, sr)


def _wait_samples(sink, n, timeout=60.0):
    deadline = time.time() + timeout
    while sink.samples < n:
        assert time.time() < deadline, f"timeout waiting for {n} samples"
        time.sleep(0.005)


def _feed(x, gate=None):
    pos = [0]

    def feed(n):
        if gate is not None and not gate.wait(60):
            raise RuntimeError("feed gate never opened")
        if pos[0] >= x.shape[1]:
            return None
        c = x[:, pos[0]: pos[0] + n]
        pos[0] += c.shape[1]
        return c

    return feed


def _fused(procs):
    return optimize.fuse(Line(source=None, sink=None, processors=procs))


# -- biquad cascade ------------------------------------------------------------


def test_fuse_biquad_run_streaming_parity_and_routing(rng):
    x = rng.standard_normal((2, 8192)).astype(np.float32)
    rows = [ops.design_peaking_eq(44100, freq=f, q=q, gain_db=g)
            for f, q, g in ((500, 1.0, 3.0), (2000, 2.0, -4.0), (7000, 0.7, 2.0))]
    eqs = [ops.Biquad(r) for r in rows]
    fused_line = _fused([e.processor() for e in eqs])
    assert len(fused_line.processors) == 1
    y_fused = stream_through(fused_line.processors, x, 512)
    y_seq = stream_through([ops.Biquad(r).processor() for r in rows], x, 512)
    assert snr_db(y_seq.astype(np.float64), y_fused) > 110

    # the MIDDLE original object's set_sos updates only its row
    new_row = ops.design_peaking_eq(44100, freq=2000, q=2.0, gain_db=0.0)
    eqs[1].set_sos(new_row).apply()
    sos_now = eqs[1]._delegate._component.get_param("sos").numpy()
    assert np.allclose(sos_now[1], (new_row / new_row[3]).astype(np.float32))
    assert np.allclose(sos_now[0], (rows[0] / rows[0][3]).astype(np.float32))


def test_fuse_biquad_cascade_no_retrace(rng):
    """A per-part retune changes the cascade's output through the same
    step function (the params are read every block)."""
    block = 512
    rows = [ops.design_peaking_eq(44100, freq=500, q=1.0, gain_db=3.0),
            ops.design_peaking_eq(44100, freq=3000, q=1.0, gain_db=-3.0)]
    eqs = [ops.Biquad(r) for r in rows]
    line = _fused([e.processor() for e in eqs])
    comp = line.processors[0](mutable.mutable(), block,
                              SignalProperties(44100.0, 1))
    sig = Signal(torch.ones((1, block)), block)
    step = comp.step
    st, y1 = step(comp.state, comp.params, sig)
    eqs[0].set_sos(ops.design_peaking_eq(44100, freq=500, q=1.0,
                                         gain_db=-6.0)).apply()
    assert comp.step is step
    st, y2 = step(st, comp.params, sig)
    assert not np.allclose(y1.data.numpy(), y2.data.numpy())


def test_fuse_biquad_mismatched_precision_not_fused():
    eq1 = ops.Biquad(ops.design_peaking_eq(44100, 500, 1.0, 3.0))
    eq2 = ops.Biquad(ops.design_peaking_eq(44100, 900, 1.0, 3.0),
                     precision="extended")
    assert len(_fused([eq1.processor(), eq2.processor()]).processors) == 2


# -- gain folding --------------------------------------------------------------


def test_fuse_gain_into_fir_both_orders(rng):
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    h = ops.design_lowpass(63, 4000.0, 44100.0)
    oracle = 0.5 * scipy.signal.lfilter(h, [1.0], x.astype(np.float64), axis=1)
    for order in ("gf", "fg"):
        g, f = ops.Gain(0.5), ops.FIR(h)
        procs = ([g.processor(), f.processor()] if order == "gf"
                 else [f.processor(), g.processor()])
        line = _fused(procs)
        assert len(line.processors) == 1
        y = stream_through(line.processors, x, 512)
        assert snr_db(oracle, y) > 120
        assert isinstance(g._delegate, FIRWithGain)
        assert f._delegate is g._delegate


def test_fuse_gain_fir_live_retune_routing():
    """set_gain on the ORIGINAL Gain after fusion lands mid-stream at a
    block boundary."""
    g = ops.Gain(1.0)
    f = ops.FIR(np.asarray([1.0, 0.0, 0.0], np.float32))
    src = mock.Source(channels=1, value=1.0, interval=0.005)
    sink = mock.Sink()
    line = optimize.fuse(pipe_tpu_torch.Line(
        source=src.source(), processors=[g.processor(), f.processor()],
        sink=sink.sink()))
    assert len(line.processors) == 1
    p = pipe_tpu_torch.Pipe(256, line)
    p.start()
    _wait_samples(sink, 256)
    p.push(g.set_gain(2.0))
    _wait_samples(sink, 256 * 8)
    p.stop(60)
    v = sink.values[0]
    sw = np.where(np.diff(v) != 0)[0]
    assert len(sw) == 1 and (sw[0] + 1) % 256 == 0
    assert v[-1] == 2.0


def test_fuse_gain_into_mix_both_sides(rng):
    x = rng.standard_normal((4, 2048)).astype(np.float32)
    m = rng.standard_normal((2, 4)).astype(np.float32)
    gv = np.asarray([0.5, 1.5, 1.0, 2.0], np.float32)
    g, mx = ops.Gain(gv), ops.ChannelMix(m)
    line = _fused([g.processor(), mx.processor()])
    assert len(line.processors) == 1
    y = stream_through(line.processors, x, 256)
    oracle = (m.astype(np.float64) * gv.astype(np.float64)[None, :]) @ x.astype(np.float64)
    assert snr_db(oracle, y) > 120

    g2, mx2 = ops.Gain(0.25), ops.ChannelMix(m)
    line2 = _fused([mx2.processor(), g2.processor()])
    assert len(line2.processors) == 1
    y2 = stream_through(line2.processors, x, 256)
    assert snr_db(0.25 * m.astype(np.float64) @ x.astype(np.float64), y2) > 120
    assert isinstance(g2._delegate, MixWithGain) and mx2._delegate is g2._delegate
    g2.set_gain(1.0).apply()
    mx2.set_matrix(2 * m).apply()
    comp = g2._delegate._component
    assert comp.get_param("gain").item() == 1.0
    np.testing.assert_allclose(comp.get_param("matrix").numpy(), 2 * m)


def test_fuse_gain_fir_does_not_starve_fir_resample(rng):
    """[Gain, FIR, Resampler]: the FIR+Resampler rewrite still fires; the
    gain stays a stage of its own."""
    g, f = ops.Gain(0.5), ops.FIR(ops.design_lowpass(63, 4000.0, 44100.0))
    rs = ops.Resampler(160, 147)
    line = _fused([g.processor(), f.processor(), rs.processor()])
    assert len(line.processors) == 2
    assert isinstance(f._delegate, FIRResampler)
    assert isinstance(rs._delegate, FIRResampler)
    assert g._delegate is None
    x = rng.standard_normal((1, 147 * 20)).astype(np.float32)
    y = stream_through(line.processors, x, 588)
    h64 = np.asarray(ops.design_lowpass(63, 4000.0, 44100.0))
    fx = scipy.signal.lfilter(h64, [1.0], 0.5 * x.astype(np.float64), axis=1)
    oracle = _resample_oracle(fx, ops.polyphase_design(160, 147, 32), 160, 147)
    assert snr_db(oracle, y) > 100


def test_fuse_gain_fir_2d_taps_before_resampler_still_folds(rng):
    """With per-channel taps the FIR+Resampler rule cannot fire, so the
    gain folds into the FIR."""
    taps2d = np.stack([ops.design_lowpass(63, 4000.0, 44100.0),
                       ops.design_lowpass(63, 6000.0, 44100.0)]).astype(np.float32)
    g, f, rs = ops.Gain(0.5), ops.FIR(taps2d), ops.Resampler(160, 147)
    line = _fused([g.processor(), f.processor(), rs.processor()])
    assert len(line.processors) == 2
    assert isinstance(g._delegate, FIRWithGain)
    assert isinstance(f._delegate, FIRWithGain)
    assert rs._delegate is None
    x = rng.standard_normal((2, 147 * 20)).astype(np.float32)
    y = stream_through(line.processors, x, 588)
    fx = np.stack([scipy.signal.lfilter(taps2d[c].astype(np.float64), [1.0],
                                        0.5 * x[c].astype(np.float64))
                   for c in range(2)])
    oracle = _resample_oracle(fx, ops.polyphase_design(160, 147, 32), 160, 147)
    assert snr_db(oracle, y) > 100


def test_fuse_mix_gain_length_mismatch_rejected():
    m = np.ones((2, 4), np.float32)
    with pytest.raises(ValueError, match="cannot fold"):
        MixWithGain(m, np.ones(3, np.float32), side="in")
    with pytest.raises(ValueError, match="cannot fold"):
        MixWithGain(m, np.ones(4, np.float32), side="out")
    MixWithGain(m, np.ones(4, np.float32), side="in")
    fw = FIRWithGain(np.ones(9, np.float32), np.ones(3, np.float32))
    with pytest.raises(ValueError, match="cannot fold"):
        fw.processor()(mutable.mutable(), 256, SignalProperties(44100.0, 2))


def test_fuse_gain_fir_retune_transient_contract(rng):
    """A live set_gain on a folded gain->FIR pair applies to the OUTPUT
    from exactly its landing sample (g * (h*x))."""
    BLOCK, T, SW = 256, 33, 6
    h = ops.design_lowpass(T, 5000.0, 44100.0)
    g, f = ops.Gain(1.0), ops.FIR(h)
    data = rng.standard_normal((1, BLOCK * 12)).astype(np.float32)
    gate = threading.Event()
    sink = mock.Sink()
    line = optimize.fuse(pipe_tpu_torch.Line(
        source=lambda ctx, b: Source(output=SignalProperties(44100.0, 1),
                                     feed=_feed(data, gate)),
        processors=[g.processor(), f.processor()], sink=sink.sink()))
    p = pipe_tpu_torch.Pipe(BLOCK, line)
    p.start()
    p.push(g.set_gain(2.0), at_block=SW)
    _wait_targets(p, [SW])
    gate.set()
    p.wait(60)
    y = scipy.signal.lfilter(h, [1.0], data.astype(np.float64), axis=1)
    gcurve = np.ones(data.shape[1])
    gcurve[SW * BLOCK:] = 2.0
    assert snr_db(y * gcurve, sink.values) > 110


def _wait_targets(p, targets, line=0):
    dest = p._exec_of_route[line].dest
    deadline = time.time() + 60
    while sorted(dest.pending_targets()) != sorted(targets):
        assert time.time() < deadline, "targets never reached the line"
        time.sleep(0.002)


# -- FIR cascade, Gain + OLS, the optimize=True knob -----------------------------


def test_fuse_fir_run_streaming_parity_and_retune(rng):
    h1 = ops.design_lowpass(63, 8000.0, 44100.0)
    h2 = ops.design_lowpass(31, 6000.0, 44100.0)
    h3 = ops.design_lowpass(15, 4000.0, 44100.0)
    f1, f2, f3 = ops.FIR(h1), ops.FIR(h2), ops.FIR(h3)
    line = _fused([f1.processor(), f2.processor(), f3.processor()])
    assert len(line.processors) == 1
    assert isinstance(f2._delegate._cascade, FIRCascade)
    x = rng.standard_normal((2, 8192)).astype(np.float32)

    def oracle(hs):
        o = x.astype(np.float64)
        for h in hs:
            o = scipy.signal.lfilter(np.asarray(h), [1.0], o, axis=1)
        return o

    assert snr_db(oracle((h1, h2, h3)), stream_through(line.processors, x, 512)) > 100
    h2b = ops.design_lowpass(31, 2000.0, 44100.0)
    f2.set_taps(h2b).apply()
    y2 = stream_through(line.processors, x, 512)  # re-allocated: keeps it
    assert snr_db(oracle((h1, h2b, h3)), y2) > 100
    with pytest.raises(ValueError, match="shape"):
        f3.set_taps(np.ones(16, np.float32))


def test_fuse_fir_run_leaves_last_for_resampler(rng):
    h1 = ops.design_lowpass(63, 8000.0, 44100.0)
    h2 = ops.design_lowpass(63, 4000.0, 44100.0)
    f1, f2, rs = ops.FIR(h1), ops.FIR(h2), ops.Resampler(160, 147)
    line = _fused([f1.processor(), f2.processor(), rs.processor()])
    assert len(line.processors) == 2
    assert isinstance(f2._delegate, FIRResampler)
    assert f1._delegate is None
    x = rng.standard_normal((1, 147 * 20)).astype(np.float32)
    y = stream_through(line.processors, x, 588)
    o = x.astype(np.float64)
    for h in (h1, h2):
        o = scipy.signal.lfilter(np.asarray(h), [1.0], o, axis=1)
    oracle = _resample_oracle(o, ops.polyphase_design(160, 147, 32), 160, 147)
    assert snr_db(oracle, y) > 100


def test_fuse_gain_ols_both_orders(rng):
    P = 2000
    ir = rng.standard_normal(P) * np.exp(-np.arange(P) / 300.0)
    x = rng.standard_normal((2, 8192)).astype(np.float32)
    oracle = 0.5 * scipy.signal.lfilter(ir, [1.0], x.astype(np.float64), axis=1)
    for order in ("gain_first", "ols_first"):
        g, conv = ops.Gain(0.5), ops.OLSConvolve(ir)
        procs = ([g.processor(), conv.processor()] if order == "gain_first"
                 else [conv.processor(), g.processor()])
        line = _fused(procs)
        assert len(line.processors) == 1, order
        assert isinstance(g._delegate, OLSWithGain)
        assert isinstance(conv._delegate, OLSWithGain)
        y = stream_through(line.processors, x, 512)
        assert snr_db(oracle, y) > 100, order
        assert g.set_gain(0.25) is not None
        assert conv.set_ir(ir * 0.5) is not None


def test_run_and_pipe_optimize_flag(rng):
    """run(..., optimize=True) and Pipe(..., optimize=True) fuse at build;
    output parity and retunes hold."""
    h1 = ops.design_lowpass(63, 8000.0, 44100.0)
    h2 = ops.design_lowpass(31, 4000.0, 44100.0)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    o = x.astype(np.float64)
    for h in (h1, h2):
        o = scipy.signal.lfilter(np.asarray(h), [1.0], o, axis=1)
    for driver in ("run", "pipe"):
        f1, f2, g = ops.FIR(h1), ops.FIR(h2), ops.Gain(0.5)
        sink = mock.Sink()
        line = pipe_tpu_torch.Line(
            source=lambda ctx, b: Source(output=SignalProperties(44100.0, 2),
                                         feed=_feed(x)),
            processors=[f1.processor(), f2.processor(), g.processor()],
            sink=sink.sink())
        if driver == "run":
            pipe_tpu_torch.run(512, line, optimize=True)
        else:
            p = pipe_tpu_torch.Pipe(512, line, optimize=True)
            assert len(p.routes[0].processors) == 2  # [FIRCascade, Gain]
            p.start()
            p.wait(60)
        # FIR+FIR cascaded; the gain stays standalone
        assert isinstance(f1._delegate._cascade, FIRCascade)
        assert f2._delegate is not None and g._delegate is None
        assert snr_db(0.5 * o, sink.values) > 100


def test_insert_width_changer_into_optimized_line_retunes_survive():
    """An optimize=True line keeps the FUSED allocators on its route, so a
    width-changing insert re-runs the fused stage at the new width, and a
    retune through an ORIGINAL object after the insert still lands."""
    BLOCK = 256
    src = mock.Source(channels=1, value=1.0, interval=0.003)
    h = ops.design_lowpass(63, 4000, 44100)
    f1, f2, g = ops.FIR(h), ops.FIR(h), ops.Gain(1.0)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(BLOCK, pipe_tpu_torch.Line(
        source=src.source(),
        processors=[f1.processor(), f2.processor(), g.processor()],
        sink=sink.sink()), optimize=True)
    p.start()
    _wait_samples(sink, 2 * BLOCK)
    target = p.block_index(0) + 6
    hd = p.insert_processor(0, 0, ops.Resampler(2, 1).processor(),
                            at_block=target)
    assert hd.wait(60) and hd.error is None, hd.error
    _wait_samples(sink, sink.samples + 6 * BLOCK)
    p.push(f2.set_taps(h * 0.5))
    _wait_samples(sink, sink.samples + 6 * BLOCK)
    p.stop(60)
    v = sink.values[0]
    assert np.isfinite(v).all()
    assert np.allclose(v[-2 * BLOCK:], 0.5, atol=1e-2), v[-4:]


# -- BASELINE config 4 at a small size, both packages ---------------------------

C4, B4, N4 = 2, 512, 16 * 512
IR4 = (np.random.default_rng(1).standard_normal(4096)
       * np.exp(-np.arange(4096) / 500.0))
RETUNE_AT, GAIN_AT = 5, 9


def _config4_line(pkg, x, sink, gate=None):
    """Config 4's chain with a gain in front: Gain(0.5) -> OLS -> peaking
    EQ at 1 kHz -> high shelf at 8 kHz."""
    o = pkg.ops
    g = o.Gain(0.5)
    peq = o.Biquad(o.design_peaking_eq(44100, 1000, 1.0, 3.0))
    line = pkg.Line(
        source=lambda ctx, b: pkg.Source(
            output=pkg.SignalProperties(44100.0, C4), feed=_feed(x, gate)),
        processors=[g.processor(), o.OLSConvolve(IR4).processor(),
                    peq.processor(),
                    o.Biquad(o.design_highshelf(44100, 8000, -2.0)).processor()],
        sink=sink.sink())
    return line, g, peq


def _config4_pipe(pkg, x, retunes=()):
    """``Pipe(optimize=True)`` of the config-4 line. ``retunes`` may hold
    "eq" (the EQ retuned through the original Biquad at block 5) and
    "gain" (the gain through the original Gain at block 9); the feed is
    held until the targets reached the line."""
    gate, sink = threading.Event(), pkg.mock.Sink()
    line, g, peq = _config4_line(pkg, x, sink, gate)
    p = pkg.Pipe(B4, line, optimize=True)
    p.start()
    targets = []
    if "eq" in retunes:
        p.push(peq.set_sos(pkg.ops.design_peaking_eq(44100, 1000, 1.0, -3.0)),
               at_block=RETUNE_AT)
        targets.append(RETUNE_AT)
    if "gain" in retunes:
        p.push(g.set_gain(0.25), at_block=GAIN_AT)
        targets.append(GAIN_AT)
    _wait_targets(p, targets)
    gate.set()
    p.wait(120)
    return sink.values, g, peq, p


def _first_change(a, b):
    assert a.shape == b.shape == (C4, N4)
    return int(np.flatnonzero(np.any(a != b, axis=0))[0])


@pytest.fixture(scope="module")
def config4_data():
    return np.random.default_rng(4).standard_normal((C4, N4)).astype(np.float32)


def test_config4_small_run_matches_jax_and_float64(config4_data):
    x = config4_data
    outs = {}
    for name, pkg, opt in (("jax", pipe_tpu, False), ("port", pipe_tpu_torch, False),
                           ("port-optimized", pipe_tpu_torch, True)):
        sink = pkg.mock.Sink()
        pkg.run(B4, _config4_line(pkg, x, sink)[0], optimize=opt)
        outs[name] = sink.values
        assert outs[name].shape == (C4, N4)
    y = 0.5 * scipy.signal.fftconvolve(x.astype(np.float64), IR4[None, :],
                                       axes=1)[:, :N4]
    sos = np.stack([ops.design_peaking_eq(44100, 1000, 1.0, 3.0),
                    ops.design_highshelf(44100, 8000, -2.0)])
    y = scipy.signal.sosfilt(sos, y, axis=1)
    for name in ("port", "port-optimized"):
        assert snr_db(outs["jax"], outs[name]) >= 100, name
        assert snr_db(y, outs[name]) >= 100, name


def test_config4_small_optimized_pipe_retunes_land_like_jax(config4_data):
    """Through Pipe(optimize=True) the line fuses to [OLSWithGain,
    BiquadCascade] in both packages; retunes through the original objects
    land at samples 5*512 (EQ) and 9*512 (gain) in both, and the outputs
    agree at >= 100 dB."""
    x = config4_data
    got = {}
    for name, pkg in (("jax", pipe_tpu), ("port", pipe_tpu_torch)):
        y, g, peq, p = _config4_pipe(pkg, x, ("eq", "gain"))
        kinds = [type(g._delegate).__name__, type(peq._delegate).__name__]
        assert kinds == ["OLSWithGain", "BiquadCascade"], (name, kinds)
        assert len(p.routes[0].processors) == 2
        y_eq, *_ = _config4_pipe(pkg, x, ("eq",))
        y_none, *_ = _config4_pipe(pkg, x)
        assert _first_change(y_eq, y_none) == RETUNE_AT * B4, name
        assert _first_change(y, y_eq) == GAIN_AT * B4, name
        got[name] = y
    assert snr_db(got["jax"], got["port"]) >= 100

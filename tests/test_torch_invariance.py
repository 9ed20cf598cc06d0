"""The mesh-free invariance, fuzz, determinism and documentation tests of the
JAX suite, written against ``pipe_tpu_torch``: the twins of
``tests/test_fuzz.py``, ``tests/test_invariance.py``, three tests of
``tests/test_aux.py`` and ``tests/test_doc_examples.py``, with the same
seeds, sizes and bars (>= 100 dB against float64 oracles, 80/120 dB between
two blockings, ``atol`` 1e-6 between knob settings and across a checkpoint).
"""

import threading
import time

import numpy as np
import pytest
import scipy.signal
import torch

import pipe_tpu_torch
from pipe_tpu_torch import checkpoint, mock, mutable, ops
from pipe_tpu_torch.components import Source
from pipe_tpu_torch.graph import make_route
from pipe_tpu_torch.ops.resample import polyphase_design
from pipe_tpu_torch.runtime.executor import EOF, LineExecutor
from pipe_tpu_torch.signal import SignalProperties, snr_db
from tests.test_torch_ops import stream

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU


def stream_through(procs, x, block, sr=44100.0):
    return stream(pipe_tpu_torch, procs, x, block, sr)


def _array_source(x, channels=None, sr=44100.0):
    """A host-feed source streaming ``x`` (channels, N), then EOF."""
    pos = [0]

    def feed(n):
        if pos[0] >= x.shape[1]:
            return None
        c = x[:, pos[0]: pos[0] + n]
        pos[0] += c.shape[1]
        return c

    return lambda ctx, b: Source(
        output=SignalProperties(sr, x.shape[0] if channels is None else channels),
        feed=feed)


# -- tests/test_fuzz.py --------------------------------------------------------


def test_fuzz_fir_random_taps_blocks(rng):
    for case in range(6):
        T = int(rng.integers(1, 258))
        C = int(rng.integers(1, 5))
        N = int(rng.integers(900, 5000))
        block = int(rng.integers(64, 1025))
        per_channel = bool(rng.integers(0, 2))
        shape = (C, T) if per_channel else (T,)
        h = rng.standard_normal(shape) / max(T, 4)
        x = rng.standard_normal((C, N)).astype(np.float32)
        out = stream_through([ops.FIR(h).processor()], x, block=block)
        x64 = x.astype(np.float64)
        if per_channel:
            oracle = np.stack(
                [scipy.signal.lfilter(h[c], [1.0], x64[c]) for c in range(C)])
        else:
            oracle = scipy.signal.lfilter(h, [1.0], x64, axis=1)
        s = snr_db(oracle, out)
        assert s > 100, f"case {case}: T={T} C={C} block={block}: {s:.1f}"


def test_fuzz_biquad_random_stable_sections(rng):
    for case in range(6):
        S = int(rng.integers(1, 4))
        rows = []
        for _ in range(S):
            rp = rng.uniform(0.1, 0.98)
            th = rng.uniform(0.05, np.pi - 0.05)
            a1, a2 = -2 * rp * np.cos(th), rp * rp
            rz = rng.uniform(0.0, 1.2)
            tz = rng.uniform(0.0, np.pi)
            b = np.array([1.0, -2 * rz * np.cos(tz), rz * rz])
            b = b * rng.uniform(0.2, 1.5)
            rows.append([b[0], b[1], b[2], 1.0, a1, a2])
        sos = np.asarray(rows)
        C = int(rng.integers(1, 4))
        N = int(rng.integers(1500, 6000))
        block = int(rng.integers(96, 769))
        x = rng.standard_normal((C, N)).astype(np.float32)
        out = stream_through([ops.Biquad(sos).processor()], x, block=block)
        oracle = scipy.signal.sosfilt(sos, x.astype(np.float64), axis=1)
        s = snr_db(oracle, out)
        assert s > 100, f"case {case}: S={S} block={block}: {s:.1f}"


def test_fuzz_delay_echo(rng):
    for case in range(7):
        block = int(rng.integers(64, 513))
        if case < 3:
            D = int(rng.integers(1, block))
        else:
            D = int(block * rng.integers(1, 4))
        fb = float(rng.uniform(-0.6, 0.6))
        wet = float(rng.uniform(0.2, 1.0))
        dry = float(rng.uniform(0.0, 1.0))
        C = int(rng.integers(1, 3))
        N = int(rng.integers(2000, 6000))
        x = rng.standard_normal((C, N)).astype(np.float32)
        out = stream_through(
            [ops.Delay(D, feedback=fb, wet=wet, dry=dry).processor()],
            x, block=block)
        x64 = x.astype(np.float64)
        s = np.zeros((C, N + D))
        for n in range(N):
            s[:, n + D] = x64[:, n] + fb * s[:, n]
        oracle = dry * x64 + wet * s[:, :N]
        sn = snr_db(oracle, out)
        assert sn > 100, f"case {case}: D={D} fb={fb:.2f}: {sn:.1f}"


_POOL = [
    lambda r: ops.FIR(r.standard_normal(int(r.integers(3, 130))) / 16),
    lambda r: ops.Biquad(
        ops.design_peaking_eq(
            44100, float(r.uniform(1000, 8000)), float(r.uniform(0.5, 4.0)),
            float(r.uniform(-9, 9)))),
    lambda r: ops.Gain(float(r.uniform(0.2, 2.0))),
    lambda r: ops.Compressor(
        threshold_db=float(r.uniform(-30, -6)),
        ratio=float(r.uniform(1.5, 8.0)),
        attack_ms=float(r.uniform(0.5, 10.0)),
        release_ms=float(r.uniform(20, 200))),
    lambda r: ops.NoiseGate(
        threshold_db=float(r.uniform(-70, -30)),
        range_db=float(r.uniform(20, 60))),
]


def test_fuzz_random_chain_blocking_invariance(rng):
    for case in range(5):
        chain_ops = [
            _POOL[int(rng.integers(0, len(_POOL)))](rng)
            for _ in range(int(rng.integers(2, 5)))
        ]
        C = int(rng.integers(1, 3))
        N = int(rng.integers(3000, 7000))
        b1, b2 = (int(rng.integers(64, 1025)) for _ in range(2))
        x = rng.standard_normal((C, N)).astype(np.float32)
        outs = []
        for b in (b1, b2):
            procs = [op.processor() for op in chain_ops]
            outs.append(stream_through(procs, x, block=b))
        s = snr_db(outs[0].astype(np.float64), outs[1])
        assert s > 100, f"case {case}: blocks {b1}/{b2}: {s:.1f}"


def test_iir_noise_gain_floor_documented(rng):
    x = rng.standard_normal((2, 8192)).astype(np.float32)
    for f, q in [(100, 0.5), (150, 2.0), (400, 2.0)]:
        sos = ops.design_peaking_eq(44100, f, q, 6.0)
        imp = np.zeros(200_000)
        imp[0] = 1.0
        hinv = scipy.signal.lfilter([1.0], [1.0, sos[4], sos[5]], imp)
        noise_gain = float(np.sqrt(np.sum(hinv**2)))
        floor_db = -20 * np.log10(noise_gain * 2.0**-24)
        out = stream_through([ops.Biquad(sos).processor()], x, block=512)
        oracle = scipy.signal.sosfilt(sos[None], x.astype(np.float64), axis=1)
        s = snr_db(oracle, out)
        assert s > floor_db - 8, f"f={f}: {s:.1f} vs floor {floor_db:.1f}"


def _gated_feed(data, block, open_after=2):
    """A feed that waits for ``gate`` once ``open_after`` blocks are out."""
    fpos = [0]
    gate = threading.Event()

    def feed(n):
        if fpos[0] >= open_after * block:
            gate.wait(60)
        if fpos[0] >= data.shape[1]:
            return None
        c = data[:, fpos[0]: fpos[0] + n]
        fpos[0] += n
        return c

    return feed, gate


def _await_target(le, target):
    deadline = time.time() + 60
    while le._next_target(0) != target:
        assert time.time() < deadline, "target never delivered"
        time.sleep(0.002)


def test_fuzz_live_width_insert_knob_invariance(rng):
    BLOCK = 256
    h = ops.design_lowpass(63, 5000, 44100)
    sos = ops.design_peaking_eq(44100, freq=800, q=1.0, gain_db=2.0)
    bases = [
        lambda: [ops.FIR(h).processor()],
        lambda: [ops.Gain(0.8).processor(), ops.FIR(h).processor()],
        lambda: [ops.Biquad(sos).processor(), ops.Gain(1.1).processor()],
    ]
    inserts = [
        lambda: ops.Resampler(2, 1),
        lambda: ops.Resampler(160, 147),
        lambda: ops.SpectralGain(240, 48),
    ]
    for case in range(3):
        C = int(rng.integers(1, 3))
        data = rng.standard_normal((C, BLOCK * 24 + 77)).astype(np.float32)
        base = bases[int(rng.integers(0, len(bases)))]
        mk_ins = inserts[int(rng.integers(0, len(inserts)))]
        n_procs = len(base())
        pos = int(rng.integers(0, n_procs + 1))
        target = 5

        def run(lookahead, batch_blocks):
            feed, gate = _gated_feed(data, BLOCK)
            sink = mock.Sink()
            p = pipe_tpu_torch.Pipe(
                BLOCK,
                pipe_tpu_torch.Line(
                    source=lambda ctx, b: Source(
                        output=SignalProperties(44100.0, C), feed=feed),
                    processors=base(),
                    sink=sink.sink()),
                lookahead=lookahead,
                batch_blocks=batch_blocks)
            p.start()
            hd = p.insert_processor(
                0, pos, mk_ins().processor(), at_block=target)
            _await_target(p._exec_of_route[0], target)
            gate.set()
            assert hd.wait(60) and hd.error is None, hd.error
            p.wait(120)
            return sink.values

        ya = run(1, 1)
        yb = run(8, 8)
        assert ya.shape == yb.shape, (
            f"case {case}: pos {pos}: {ya.shape} vs {yb.shape}")
        np.testing.assert_allclose(
            ya, yb, atol=1e-6,
            err_msg=f"case {case}: pos {pos} knobs (1,1) vs (8,8)")


def test_fuzz_mixed_width_chain_block_invariance(rng):
    chains = [
        lambda D: [ops.SpectralGain(512, 128).processor(),
                   ops.Delay(D).processor(), ops.Gain(0.5).processor()],
        lambda D: [ops.Resampler(160, 147).processor(),
                   ops.Delay(D).processor()],
        lambda D: [ops.FIR(ops.design_lowpass(63, 5000, 44100)).processor(),
                   ops.SpectralGain(256, 64).processor()],
        lambda D: [ops.Resampler(48000, 32000).processor(),
                   ops.SpectralGate(256, 64, threshold=1e-4).processor()],
    ]
    for case in range(4):
        C = int(rng.integers(1, 4))
        x = rng.standard_normal((C, 16000)).astype(np.float32)
        b1, b2 = (int(rng.integers(90, 1300)) for _ in range(2))
        D = int(rng.integers(1, 3000))
        mk = chains[case]
        ya = stream_through(mk(D), x, b1)
        yb = stream_through(mk(D), x, b2)
        n = min(ya.shape[1], yb.shape[1])
        sn = snr_db(yb[:, :n].astype(np.float64), ya[:, :n])
        assert sn > 110, (
            f"case {case}: blocks {b1}/{b2} C={C} D={D}: {sn:.1f} dB")


# -- tests/test_invariance.py --------------------------------------------------


def _chain(kind):
    if kind == "fir":
        return [ops.FIR(ops.design_lowpass(97, 3000.0, 44100.0)).processor()]
    if kind == "biquad":
        return [ops.Biquad(
            ops.design_peaking_eq(44100, freq=800, q=2.0, gain_db=6.0)
        ).processor()]
    if kind == "dynamics":
        return [
            ops.Compressor(threshold_db=-15.0, ratio=3.0, attack_ms=2.0,
                           release_ms=40.0).processor(),
            ops.Delay(64, wet=0.5, dry=0.5).processor(),
        ]
    if kind == "resample":
        return [ops.Resampler(48000, 44100, taps_per_phase=16).processor()]
    if kind == "mixed":
        return [
            ops.FIR(ops.design_lowpass(33, 5000.0, 44100.0)).processor(),
            ops.Gain(0.8).processor(),
            ops.NoiseGate(threshold_db=-60.0, range_db=40.0).processor(),
        ]
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["fir", "biquad", "dynamics", "resample", "mixed"])
@pytest.mark.parametrize("blocks", [(512, 128), (512, 379)])
def test_block_size_invariance(kind, blocks, rng):
    C = 2
    N = 7321  # deliberately not a multiple of anything
    x = rng.standard_normal((C, N)).astype(np.float32)
    a, b = (stream_through(_chain(kind), x, bs) for bs in blocks)
    m = min(a.shape[1], b.shape[1])
    if kind == "resample":
        assert abs(a.shape[1] - b.shape[1]) <= 2
    else:
        assert a.shape == b.shape
    bound = 80 if kind == "biquad" else 120
    assert snr_db(a[:, :m].astype(np.float64), b[:, :m]) >= bound


def test_single_block_equals_streamed(rng):
    C, N = 1, 4096
    x = rng.standard_normal((C, N)).astype(np.float32)
    chain = lambda: [  # noqa: E731
        ops.FIR(ops.design_lowpass(65, 4000.0, 44100.0)).processor(),
        ops.Compressor(threshold_db=-12.0, ratio=4.0).processor(),
    ]
    whole = stream_through(chain(), x, 4096)
    parts = stream_through(chain(), x, 100)  # 40 blocks + a 96-frame partial
    assert whole.shape == parts.shape
    assert snr_db(whole.astype(np.float64), parts) >= 120


# -- tests/test_aux.py ---------------------------------------------------------


def test_checkpoint_after_width_changing_surgery(rng):
    """A pipe grown by a width-changing live insert snapshots into a
    checkpoint that restores into a pipe built with the final graph."""
    B = 256
    h = ops.design_lowpass(63, cutoff=4000, sample_rate=44100)
    x = rng.standard_normal((2, B * 16)).astype(np.float32)
    half = B * 8

    feed_a, gate = _gated_feed(x[:, :half], B)
    sink_a = mock.Sink()
    pa = pipe_tpu_torch.Pipe(
        B,
        pipe_tpu_torch.Line(
            source=lambda ctx, b: Source(
                output=SignalProperties(44100.0, 2), feed=feed_a),
            processors=[ops.FIR(h).processor()],
            sink=sink_a.sink()))
    pa.start()
    hd = pa.insert_processor(0, 0, ops.Resampler(2, 1).processor(), at_block=4)
    _await_target(pa._exec_of_route[0], 4)
    gate.set()
    assert hd.wait(60) and hd.error is None, hd.error
    pa.wait(60)
    ck = checkpoint.snapshot(pa)

    sink_b = mock.Sink()
    pb = pipe_tpu_torch.Pipe(
        B,
        pipe_tpu_torch.Line(
            source=_array_source(x[:, half:]),
            processors=[ops.Resampler(2, 1).processor(),
                        ops.FIR(h).processor()],
            sink=sink_b.sink()))
    checkpoint.restore(pb, ck)
    pb.start()
    pb.wait(60)

    got = np.concatenate([sink_a.values, sink_b.values], axis=1)
    cut = 4 * B
    hp64 = polyphase_design(2, 1, 32)
    K = hp64.shape[1]
    tail = x.astype(np.float64)[:, cut:]
    n_out = 2 * tail.shape[1]
    j = np.arange(n_out)
    ph, n0 = j % 2, j // 2
    nidx = n0[:, None] - np.arange(K)[None, :]
    valid = (nidx >= 0) & (nidx < tail.shape[1])
    xg = np.where(valid[None], tail[:, np.clip(nidx, 0, tail.shape[1] - 1)], 0.0)
    res = np.einsum("cok,ok->co", xg, hp64[ph])
    stream_ = np.concatenate([x.astype(np.float64)[:, :cut], res], axis=1)
    oracle = scipy.signal.lfilter(np.asarray(h), [1.0], stream_, axis=1)
    assert got.shape == oracle.shape, (got.shape, oracle.shape)
    assert snr_db(oracle, got) > 100


def test_determinism_same_seed_same_output(rng):
    """Two async runs of the same graph produce bit-identical output."""
    h = ops.design_lowpass(63, cutoff=4000, sample_rate=44100)
    x = rng.standard_normal((2, 4096)).astype(np.float32)

    def run_once():
        sink = mock.Sink()
        p = pipe_tpu_torch.Pipe(
            256,
            pipe_tpu_torch.Line(
                source=_array_source(x), sink=sink.sink(),
                processors=[ops.FIR(h).processor()]))
        p.start()
        p.wait(60)
        return sink.values

    a, b = run_once(), run_once()
    np.testing.assert_array_equal(a, b)


def test_checkpoint_roundtrip_dynamics_chain(rng):
    """The states of a delay line and a compressor, taken from a line
    executor stopped mid-stream, continue a fresh graph: resumed output ==
    unbroken."""
    C, block, n_blocks = 1, 512, 12
    x = rng.standard_normal((C, block * n_blocks)).astype(np.float32)
    half = block * n_blocks // 2

    def build(part):
        sink = mock.Sink()
        procs = [
            ops.Delay(700, feedback=0.4, wet=0.5, dry=1.0).processor(),
            ops.Compressor(threshold_db=-10.0, ratio=3.0).processor(),
        ]
        return pipe_tpu_torch.Line(source=_array_source(part), processors=procs,
                                   sink=sink.sink()), sink

    line, sink = build(x)
    pipe_tpu_torch.run(block, line)
    whole = sink.values

    line2, sink2 = build(x)
    route = make_route(line2, block)
    le = LineExecutor(route, block)
    le.start_hook()
    for _ in range(n_blocks // 2):
        le.execute()
    le.drain()

    states = [c.state for c in route.components()]
    line3, sink3 = build(x[:, half:])
    route3 = make_route(line3, block)
    for comp, st in zip(route3.components(), states):
        comp.state = pipe_tpu_torch.tree.tree_map(
            lambda l: l.clone() if isinstance(l, torch.Tensor) else l, st)
    le3 = LineExecutor(route3, block)
    le3.start_hook()
    while le3.execute() is not EOF:
        pass
    le3.flush_hook()

    resumed = np.concatenate([sink2.values, sink3.values], axis=1)
    assert resumed.shape == whole.shape
    np.testing.assert_allclose(resumed, whole, atol=1e-6)


# -- tests/test_doc_examples.py ------------------------------------------------


def test_example_mutation():
    """Creating a mutation does not apply it; ``apply`` does."""

    class Component:
        def __init__(self):
            self.context = mutable.mutable()
            self.parameter = 0

        def set_parameter(self, value):
            def fn():
                self.parameter = value

            return self.context.mutate(fn)

    component = Component()
    outputs = [component.parameter]
    mutation = component.set_parameter(10)
    outputs.append(component.parameter)  # still 0: not applied yet
    mutation.apply()
    outputs.append(component.parameter)
    assert outputs == [0, 0, 10]


def test_example_doc_walkthrough():
    """The docs walkthrough: define a Line, bind with Pipe, start, wait."""
    src = mock.Source(channels=2, value=0.5, limit=512 * 10)
    sink = mock.Sink()
    g = ops.Gain(2.0)
    l1 = pipe_tpu_torch.Line(
        source=src.source(),
        processors=pipe_tpu_torch.Processors(g.processor()),
        sink=sink.sink())
    p = pipe_tpu_torch.Pipe(512, l1)  # binds: allocators run here
    p.start()
    p.wait(60)
    out = sink.values
    assert out.shape == (2, 512 * 10)
    assert np.allclose(out, 1.0)  # 0.5 * gain 2.0


def test_example_readme_quickstart():
    """README quick start: source -> FIR -> gain -> sink, one-shot run."""
    src = mock.Source(channels=1, value=1.0, limit=2048)
    fir = ops.FIR(ops.design_lowpass(101, 4000.0, 44100.0))
    g = ops.Gain(0.5)
    sink = mock.Sink()
    line = pipe_tpu_torch.Line(
        source=src.source(),
        processors=pipe_tpu_torch.Processors(fir.processor(), g.processor()),
        sink=sink.sink())
    pipe_tpu_torch.run(512, line)
    out = sink.values
    assert out.shape == (1, 2048)
    # DC gain of the normalized lowpass is 1.0; steady state = 1.0 * 0.5
    assert np.allclose(out[0, 200:], 0.5, atol=1e-3)

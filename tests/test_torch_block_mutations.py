"""Block-indexed mutations and live surgery on the port's Pipe — twins of
``tests/test_block_mutations.py``: a push or insert tagged with a target
block lands exactly there under every ``(lookahead, batch_blocks)`` pair,
the executor splitting its dispatch batch at the boundary (reference
``pipe.go:381-413``). Gain lines match the JAX package to ``rtol=1e-6``;
the width-changing resampler insert matches it to >= 100 dB."""

import threading
import time

import numpy as np
import pytest
import scipy.signal

import pipe_tpu
import pipe_tpu.mock
import pipe_tpu.ops
import pipe_tpu_torch
from pipe_tpu_torch import mock, mutable, ops
from pipe_tpu_torch.components import Source
from pipe_tpu_torch.signal import SignalProperties, snr_db

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

BLOCK = 256
KNOBS = [(1, 1), (4, 1), (1, 4), (4, 4)]
KNOB_IDS = [f"la{a}-bb{b}" for a, b in KNOBS]


def _wait_samples(sink, n, timeout=60.0):
    deadline = time.time() + timeout
    while sink.samples < n:
        if time.time() > deadline:
            raise AssertionError(f"timeout waiting for {n} samples")
        time.sleep(0.005)


def _switches(v):
    return np.where(np.diff(v) != 0)[0]


@pytest.mark.parametrize("lookahead,batch_blocks", KNOBS, ids=KNOB_IDS)
def test_targeted_push_lands_at_exact_block(lookahead, batch_blocks):
    """A gain step targeted at block N switches the output at sample
    N*block_size exactly, even mid-batch."""
    gain = ops.Gain(1.0)
    src = mock.Source(channels=1, value=1.0, interval=0.01)  # unbounded
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(
        BLOCK, pipe_tpu_torch.Line(source=src.source(),
                                   processors=[gain.processor()],
                                   sink=sink.sink()),
        lookahead=lookahead, batch_blocks=batch_blocks)
    p.start()
    _wait_samples(sink, BLOCK)  # stream is live
    # far enough ahead that the push cannot race the frontier, and not on
    # a batch boundary so the batch must split
    target = p.block_index(0) + 3 * max(batch_blocks, 4) + 1
    p.push(gain.set_gain(2.0), at_block=target)
    _wait_samples(sink, (target + 2 * batch_blocks + 2) * BLOCK)
    p.stop(60)
    sw = _switches(sink.values[0])
    assert len(sw) == 1, f"expected one switch, got {len(sw)}"
    assert sw[0] + 1 == target * BLOCK  # exact landing sample


def test_untargeted_push_lands_at_next_dispatch():
    """The default push lands at a dispatch boundary (a multiple of
    batch_blocks blocks)."""
    k = 8
    gain = ops.Gain(1.0)
    src = mock.Source(channels=1, value=1.0, interval=0.01)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(
        BLOCK, pipe_tpu_torch.Line(source=src.source(),
                                   processors=[gain.processor()],
                                   sink=sink.sink()),
        batch_blocks=k)
    p.start()
    _wait_samples(sink, BLOCK)
    p.push(gain.set_gain(0.5))
    _wait_samples(sink, sink.samples + 3 * k * BLOCK)
    p.stop(60)
    sw = _switches(sink.values[0])
    assert len(sw) == 1
    assert (sw[0] + 1) % (k * BLOCK) == 0  # a dispatch boundary


def test_targeted_push_in_the_past_applies_at_next_block():
    gain = ops.Gain(1.0)
    src = mock.Source(channels=1, value=1.0, interval=0.005)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(BLOCK, pipe_tpu_torch.Line(
        source=src.source(), processors=[gain.processor()], sink=sink.sink()))
    p.start()
    _wait_samples(sink, 4 * BLOCK)
    p.push(gain.set_gain(3.0), at_block=0)  # long gone
    _wait_samples(sink, sink.samples + 4 * BLOCK)
    p.stop(60)
    v = sink.values[0]
    sw = _switches(v)
    assert len(sw) == 1 and v[-1] == 3.0
    assert (sw[0] + 1) % BLOCK == 0


def _array_feed(data, gate=None):
    pos = [0]

    def feed(n):
        if gate is not None:
            gate.wait(60)
        if pos[0] >= data.shape[1]:
            return None
        c = data[:, pos[0]: pos[0] + n]
        pos[0] += n
        return c

    return feed


def test_feed_line_batch_blocks_matches_unbatched(rng):
    """Host-fed lines batch too: identical output with and without."""
    C, k = 2, 8
    data = rng.standard_normal((C, BLOCK * 27 + 111)).astype(np.float32)
    h = np.asarray(ops.design_lowpass(63, 4000, 44100))
    outs = {}
    for bb in (1, k):
        feed = _array_feed(data)
        sink = mock.Sink()
        p = pipe_tpu_torch.Pipe(
            BLOCK, pipe_tpu_torch.Line(
                source=lambda ctx, b, f=feed: Source(
                    output=SignalProperties(44100.0, C), feed=f),
                processors=[ops.FIR(h).processor()], sink=sink.sink()),
            batch_blocks=bb)
        p.start()
        p.wait(60)
        outs[bb] = sink.values
    assert outs[1].shape == outs[k].shape == data.shape
    np.testing.assert_array_equal(outs[1], outs[k])


def test_strict_late_target_raise_preserves_pending():
    ctx = mutable.mutable()
    dest = mutable.Destination()
    log = []
    dest.put(mutable.Mutations().put(ctx.mutate(lambda: log.append("u"))))
    dest.put(mutable.Mutations().put(ctx.mutate(lambda: log.append("late"))),
             at_block=3)
    with pytest.raises(mutable.LateTargetError):
        dest.take_due(10, strict=True)
    assert dest.pending_targets() == [3]
    dest.take_due(10).apply_to(ctx)
    assert log == ["u", "late"]


def test_destination_block_indexed_delivery():
    ctx = mutable.mutable()
    dest = mutable.Destination()
    log = []

    def m(tag):
        return mutable.Mutations().put(ctx.mutate(lambda: log.append(tag)))

    dest.put(m("now"))
    dest.put(m("b5"), at_block=5)
    dest.put(m("b3"), at_block=3)
    assert dest.next_target(0) == 3
    dest.take_due(0).apply_to(ctx)
    assert log == ["now"]
    assert dest.next_target(3) == 5
    dest.take_due(4).apply_to(ctx)
    assert log == ["now", "b3"]
    dest.put(m("b9"), at_block=9)
    dest.take().apply_to(ctx)
    assert log == ["now", "b3", "b5", "b9"]
    assert dest.next_target(0) is None
    assert dest.take_due(100) is None


@pytest.mark.parametrize("lookahead,batch_blocks", KNOBS, ids=KNOB_IDS)
def test_insert_processor_at_block_exact(lookahead, batch_blocks):
    """insert_processor(at_block=N) takes effect at sample N*block_size
    exactly."""
    src = mock.Source(channels=1, value=1.0, interval=0.01)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(
        BLOCK, pipe_tpu_torch.Line(source=src.source(), processors=[],
                                   sink=sink.sink()),
        lookahead=lookahead, batch_blocks=batch_blocks)
    p.start()
    _wait_samples(sink, BLOCK)
    target = p.block_index(0) + 3 * max(batch_blocks, 4) + 1
    h = p.insert_processor(0, 0, ops.Gain(2.0).processor(), at_block=target)
    assert h.wait(60) and h.error is None
    _wait_samples(sink, (target + 2 * batch_blocks + 2) * BLOCK)
    p.stop(60)
    v = sink.values[0]
    sw = _switches(v)
    assert len(sw) == 1, f"expected one switch, got {len(sw)}"
    assert sw[0] + 1 == target * BLOCK
    assert v[-1] == 2.0


def _gated_schedule(pkg, data, lookahead=1, batch_blocks=1):
    """A gated host feed through two gains; targeted pushes at blocks 3 and
    11, a gain inserted at block 7; the gate opens once the targets reached
    the line's destination. Returns the sink's output."""
    gate = threading.Event()
    C = data.shape[0]
    g1, g2 = pkg.ops.Gain(1.0), pkg.ops.Gain(1.0)
    sink = pkg.mock.Sink()
    p = pkg.Pipe(
        BLOCK, pkg.Line(
            source=lambda ctx, b: pkg.Source(
                output=pkg.SignalProperties(44100.0, C),
                feed=_array_feed(data, gate)),
            processors=[g1.processor(), g2.processor()], sink=sink.sink()),
        lookahead=lookahead, batch_blocks=batch_blocks)
    p.start()
    p.push(g1.set_gain(0.75), at_block=3)
    p.push(g2.set_gain(1.5), g1.set_gain(1.25), at_block=11)
    h = p.insert_processor(0, 1, pkg.ops.Gain(-0.5).processor(), at_block=7)
    dest = p._exec_of_route[0].dest
    deadline = time.time() + 60
    while sorted(dest.pending_targets()) != [3, 7, 11]:
        assert time.time() < deadline, "targets never delivered"
        time.sleep(0.002)
    gate.set()
    assert h.wait(60) and h.error is None, h.error
    p.wait(60)
    return sink.values


@pytest.fixture(scope="module")
def schedule_data():
    data = np.random.default_rng(7).standard_normal(
        (2, 16 * BLOCK + 77)).astype(np.float32)
    return data, _gated_schedule(pipe_tpu, data)


@pytest.mark.parametrize("lookahead,batch_blocks", KNOBS, ids=KNOB_IDS)
def test_targeted_schedule_matches_jax(schedule_data, lookahead, batch_blocks):
    """Pushes and an insert at fixed blocks give the JAX package's output
    under every knob pair (gain lines: rtol 1e-6), landing exactly."""
    data, ref = schedule_data
    got = _gated_schedule(pipe_tpu_torch, data, lookahead, batch_blocks)
    assert got.shape == ref.shape == data.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    g = np.ones(data.shape[1])
    g[3 * BLOCK:] = 0.75
    g[7 * BLOCK:] *= -0.5
    g[11 * BLOCK:] = 1.25 * -0.5 * 1.5
    np.testing.assert_allclose(got, data * g, rtol=1e-6)


def test_streaming_at_block_counts_source_buffers_under_short_reads():
    """Every feed result is one dispatched block, so ``at_block=k`` is the
    k-th source-buffer boundary even when buffers are short."""
    B = 384
    r = np.random.default_rng(99)
    reads = [int(r.integers(1, B + 1)) for _ in range(40)]
    gate = threading.Event()
    i = [0]

    def feed(n):
        gate.wait(30)
        if i[0] >= len(reads):
            return None
        k = reads[i[0]]
        i[0] += 1
        return np.ones((1, k), np.float32)

    gain = ops.Gain(1.0)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(B, pipe_tpu_torch.Line(
        source=lambda ctx, b: Source(output=SignalProperties(44100.0, 1),
                                     feed=feed),
        processors=[gain.processor()], sink=sink.sink()))
    p.start()
    p.push(gain.set_gain(0.5), at_block=5)
    time.sleep(0.3)  # the control thread delivers while the gate pins block 0
    gate.set()
    p.wait(60)
    v = sink.values[0]
    sw = _switches(v)
    assert v.shape[0] == sum(reads)
    assert len(sw) == 1 and sw[0] + 1 == sum(reads[:5])


EQ_SOS = np.stack([pipe_tpu_torch.ops.design_peaking_eq(44100, 1000, 1.0, 3.0),
                   pipe_tpu_torch.ops.design_highshelf(44100, 8000, -2.0)])


def _resampler_insert(pkg, data, target=6):
    """A gated FIR -> biquad EQ line; a 160/147 resampler inserted before
    the FIR at ``target`` (the FIR, the EQ and the sink re-allocate at the
    new width)."""
    C, N = data.shape
    pos = [0]
    target_queued = threading.Event()

    def feed(n):
        if pos[0] >= 2 * BLOCK:
            target_queued.wait(60)
        if pos[0] >= N:
            return None
        c = data[:, pos[0]: pos[0] + n]
        pos[0] += n
        return c

    h = np.asarray(pkg.ops.design_lowpass(63, 4000, 44100))
    sink = pkg.mock.Sink()
    p = pkg.Pipe(BLOCK, pkg.Line(
        source=lambda ctx, b: pkg.Source(
            output=pkg.SignalProperties(44100.0, C), feed=feed),
        processors=[pkg.ops.FIR(h).processor(),
                    pkg.ops.Biquad(EQ_SOS).processor()],
        sink=sink.sink()))
    p.start()
    hd = p.insert_processor(0, 0, pkg.ops.Resampler(160, 147).processor(),
                            at_block=target)
    le = p._exec_of_route[0]
    deadline = time.time() + 60
    while le._next_target(0) != target:
        assert time.time() < deadline, "surgery target never delivered"
        time.sleep(0.002)
    target_queued.set()
    assert hd.wait(60) and hd.error is None, hd.error
    p.wait(60)
    return sink.values, h


def test_insert_width_changing_resampler_exact(rng):
    """Live insert of a resampler: the downstream FIR's (C, T-1) tail and
    the EQ's (C, 2) states are width-independent, so they continue exactly
    across the re-allocation; >= 100 dB against a float64 oracle and
    against the JAX package."""
    C, N = 2, 40 * BLOCK
    data = rng.standard_normal((C, N)).astype(np.float32)
    got, h = _resampler_insert(pipe_tpu_torch, data)
    ref, _ = _resampler_insert(pipe_tpu, data)

    target = 6
    cut = target * BLOCK
    r = ops.Resampler(160, 147)
    hp64 = ops.polyphase_design(r.up, r.down, r.taps_per_phase)
    x64 = data.astype(np.float64)
    tail = x64[:, cut:]
    L, M, K = r.up, r.down, hp64.shape[1]
    n_out = -(-tail.shape[1] * L // M)
    j = np.arange(n_out)
    p_, n0 = (j * M) % L, (j * M) // L
    nidx = n0[:, None] - np.arange(K)[None, :]
    valid = (nidx >= 0) & (nidx < tail.shape[1])
    xg = np.where(valid[None], tail[:, np.clip(nidx, 0, tail.shape[1] - 1)], 0.0)
    res = np.einsum("cok,ok->co", xg, hp64[p_])
    oracle = scipy.signal.sosfilt(EQ_SOS, scipy.signal.lfilter(
        h, [1.0], np.concatenate([x64[:, :cut], res], axis=1), axis=1), axis=1)

    assert got.shape == ref.shape == oracle.shape
    assert snr_db(oracle, got) > 100
    assert snr_db(ref, got) > 100


def test_insert_width_changer_upstream_of_width_changer():
    """A width-changing insert upstream of another width-changing stage
    (a 3/2 resampler): the rebuild threads out_capacity through the
    re-allocated chain. Stream integrity and a settled constant tail."""
    src = mock.Source(channels=1, value=1.0, interval=0.004)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(BLOCK, pipe_tpu_torch.Line(
        source=src.source(), processors=[ops.Resampler(3, 2).processor()],
        sink=sink.sink()))
    p.start()
    _wait_samples(sink, 2 * BLOCK)
    target = p.block_index(0) + 6
    hd = p.insert_processor(0, 0, ops.Resampler(2, 1).processor(),
                            at_block=target)
    assert hd.wait(60) and hd.error is None, hd.error
    before = sink.samples
    _wait_samples(sink, before + 8 * BLOCK)
    p.stop(60)
    v = sink.values
    assert np.isfinite(v).all()
    assert p.routes[0].processors[1].out_capacity == 2 * BLOCK * 3 // 2
    assert np.allclose(v[0, -2 * BLOCK:], v[0, -1], atol=1e-2)


def test_insert_two_width_changers_queued_back_to_back():
    """Two width-changing inserts queued without waiting for each other:
    the downstream rebuild runs at each adoption against the live route,
    so both land."""
    src = mock.Source(channels=1, value=1.0, interval=0.002)
    h = np.asarray(ops.design_lowpass(63, 4000, 44100))
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(BLOCK, pipe_tpu_torch.Line(
        source=src.source(), processors=[ops.FIR(h).processor()],
        sink=sink.sink()))
    p.start()
    _wait_samples(sink, BLOCK)
    base = p.block_index(0)
    h1 = p.insert_processor(0, 0, ops.Resampler(2, 1).processor(),
                            at_block=base + 4)
    h2 = p.insert_processor(0, 0, ops.Resampler(2, 1).processor(),
                            at_block=base + 8)
    assert h1.wait(60) and h1.error is None, h1.error
    assert h2.wait(60) and h2.error is None, h2.error
    before = sink.samples
    _wait_samples(sink, before + 8 * BLOCK)
    p.stop(60)
    v = sink.values[0]
    assert np.isfinite(v).all()
    assert np.allclose(v[-2 * BLOCK:], v[-1], atol=1e-2)


def test_insert_raced_by_width_change_refuses_cleanly():
    """An insert allocated for a slot whose width an earlier surgery then
    changed refuses at adoption via the handle; the run survives."""
    src = mock.Source(channels=1, value=1.0, interval=0.002)
    h = np.asarray(ops.design_lowpass(63, 4000, 44100))
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(BLOCK, pipe_tpu_torch.Line(
        source=src.source(), processors=[ops.FIR(h).processor()],
        sink=sink.sink()))
    p.start()
    _wait_samples(sink, BLOCK)
    base = p.block_index(0)
    h1 = p.insert_processor(0, 0, ops.Resampler(2, 1).processor(),
                            at_block=base + 4)
    h2 = p.insert_processor(0, 1, ops.FIR(h).processor(), at_block=base + 8)
    assert h1.wait(60) and h1.error is None, h1.error
    assert h2.wait(60)
    assert h2.error is not None and "raced" in str(h2.error), h2.error
    before = sink.samples
    _wait_samples(sink, before + 4 * BLOCK)
    p.stop(60)
    assert np.isfinite(sink.values).all()


def test_insert_width_changing_carries_downstream_params():
    """A live retune pushed before a width-changing insert survives the
    downstream re-allocation."""
    src = mock.Source(channels=1, value=1.0, interval=0.005)
    gain = ops.Gain(1.0)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(BLOCK, pipe_tpu_torch.Line(
        source=src.source(), processors=[gain.processor()], sink=sink.sink()))
    p.start()
    _wait_samples(sink, BLOCK)
    p.push(gain.set_gain(0.5))
    _wait_samples(sink, sink.samples + 4 * BLOCK)
    target = p.block_index(0) + 6
    hd = p.insert_processor(0, 0, ops.Resampler(2, 1).processor(),
                            at_block=target)
    assert hd.wait(60) and hd.error is None, hd.error
    _wait_samples(sink, (target + 8) * BLOCK)
    p.stop(60)
    v = sink.values[0]
    assert np.allclose(v[-4 * BLOCK:], 0.5, atol=1e-3), v[-8:]


def test_stale_target_does_not_fire_into_next_stream():
    """A restarted pipe is a new stream: an at_block push the previous
    stream never reached must not fire in the next one."""
    gain = ops.Gain(1.0)
    src = mock.Source(channels=1, value=1.0, interval=0.001)  # unbounded
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(BLOCK, pipe_tpu_torch.Line(
        source=src.source(), processors=[gain.processor()], sink=sink.sink()))
    p.start()
    _wait_samples(sink, BLOCK)
    target = p.block_index(0) + 300
    p.push(gain.set_gain(7.0), at_block=target)
    p.stop(60)
    assert np.all(sink.values == 1.0)
    p.start(src.reset())
    _wait_samples(sink, sink.samples + (target + 20) * BLOCK)
    p.stop(60)
    assert np.all(sink.values == 1.0), "stale at_block fired into new stream"


def test_pending_window_bounded_under_split_dispatches():
    """Recurring targets split k-block dispatches into singles; the
    in-flight queue stays bounded by lookahead."""
    gain = ops.Gain(1.0)
    src = mock.Source(channels=1, value=1.0, interval=0.001)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(
        64, pipe_tpu_torch.Line(source=src.source(),
                                processors=[gain.processor()],
                                sink=sink.sink()),
        lookahead=2, batch_blocks=4)
    p.start()
    _wait_samples(sink, 64)
    le = p._exec_of_route[0]
    for _ in range(30):  # a target every 2 blocks keeps every dispatch split
        p.push(gain.set_gain(1.0), at_block=le.blocks_dispatched + 2)
        time.sleep(0.004)
        assert len(le._pending) <= le.lookahead + le.batch_blocks
    _wait_samples(sink, sink.samples + 64 * 8)
    assert len(le._pending) <= le.lookahead + le.batch_blocks
    p.stop(60)


def _gated_ones_line(feed):
    gain = ops.Gain(1.0)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(
        64, pipe_tpu_torch.Line(
            source=lambda ctx, b: Source(output=SignalProperties(44100.0, 1),
                                         feed=feed),
            processors=[gain.processor()], sink=sink.sink()),
        batch_blocks=32)
    return p, gain, sink


def test_target_arriving_during_blocked_feed_splits_batch():
    """A target pushed while a feed call blocks mid-collection still splits
    the batch (the budget computed at execute() entry is stale)."""
    TARGET = 5
    data = np.ones((1, 64 * 64), np.float32)
    gate = threading.Event()
    p, gain, sink = _gated_ones_line(_array_feed(data, gate))
    p.start()
    p.push(gain.set_gain(2.0), at_block=TARGET)
    time.sleep(0.3)  # the control thread delivers while feed is gated
    gate.set()
    p.wait(60)
    v = sink.values[0]
    s = TARGET * 64
    assert np.all(v[:s] == 1.0) and np.all(v[s:] == 2.0)


def test_target_inside_already_collected_batch_holds_blocks():
    """A target pushed while the feed blocks after some blocks were already
    collected lands exactly: dispatch up to it, hold the rest."""
    TARGET = 5
    data = np.ones((1, 64 * 64), np.float32)
    gate = threading.Event()
    calls = [0]
    inner = _array_feed(data)

    def feed(n):
        calls[0] += 1
        if calls[0] == 11:  # the block after 10 were collected
            gate.wait(60)
        return inner(n)

    p, gain, sink = _gated_ones_line(feed)
    p.start()
    deadline = time.time() + 60
    while calls[0] < 11:
        assert time.time() < deadline
        time.sleep(0.005)
    p.push(gain.set_gain(2.0), at_block=TARGET)  # inside collected range
    time.sleep(0.3)
    gate.set()
    p.wait(60)
    v = sink.values[0]
    s = TARGET * 64
    assert np.all(v[:s] == 1.0) and np.all(v[s:] == 2.0)

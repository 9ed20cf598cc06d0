"""Soak tests of the port's Pipe — twins of the non-mesh cases of
``tests/test_soak.py`` (seeded random targeted mutations, neutral live
surgery, an EOF partial tail and a restart, against an exact float64
oracle, under every ``(lookahead, batch_blocks)`` pair) and of the
latency-budget tests of ``tests/test_latency.py``: a sample fed at block
``i`` reaches the sink within ``(lookahead + 1) * batch_blocks`` blocks."""

import threading
import time

import numpy as np
import pytest

import pipe_tpu_torch
from pipe_tpu_torch import mock, ops
from pipe_tpu_torch.components import Sink, Source
from pipe_tpu_torch.errors import RunError
from pipe_tpu_torch.signal import SignalProperties, snr_db

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU


def test_soak_mutations_and_surgery():
    """~200 blocks under a barrage of pushes, two live inserts and a live
    line: no sample lost."""
    block = 256
    total = block * 200
    gain = ops.Gain(1.0)
    src = mock.Source(channels=1, value=1.0, limit=total, interval=0.004)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(block, pipe_tpu_torch.Line(
        source=src.source(), processors=[gain.processor()], sink=sink.sink()))
    p.start()
    for i in range(25):
        p.push(gain.set_gain(1.0 + (i % 5) * 0.25))
        time.sleep(0.005)
    g2 = ops.Gain(2.0)
    h1 = p.insert_processor(0, 1, g2.processor())
    assert h1.wait(60) and h1.error is None
    bq = ops.Biquad(ops.design_peaking_eq(44100, freq=500, q=0.7, gain_db=0.0))
    h2 = p.insert_processor(0, 0, bq.processor())
    assert h2.wait(60) and h2.error is None
    src2 = mock.Source(channels=1, value=-1.0, limit=block * 40)
    sink2 = mock.Sink()
    h3 = p.add_line(pipe_tpu_torch.Line(source=src2.source(),
                                        sink=sink2.sink()))
    assert h3.wait(60) and h3.error is None
    for i in range(10):
        p.push(g2.set_gain(1.0 + i * 0.1))
        time.sleep(0.003)
    p.wait(120)
    assert sink.values.shape == (1, total)
    assert np.isfinite(sink.values).all()
    assert sink2.values.shape == (1, block * 40)
    assert np.allclose(sink2.values, -1.0)


def _step_gains(schedule, n_samples, block):
    """Per-sample float64 gain curve from a (block_idx -> value) schedule."""
    g = np.ones(n_samples, np.float64)
    for b, v in schedule:
        g[b * block:] = np.float64(np.float32(v))
    return g


def _randomized_soak(lookahead, batch_blocks, n_blocks=256, block=256):
    seed = 1000 + lookahead * 100 + batch_blocks + block
    r = np.random.default_rng(seed)
    tail, C = 73, 2
    total = block * n_blocks + tail
    data = r.standard_normal((C, total)).astype(np.float32)
    gate = threading.Event()
    pos = [0]

    def feed(n):
        gate.wait(60)
        if pos[0] >= total:
            return None
        c = data[:, pos[0]: pos[0] + n]
        pos[0] += n
        return c

    g1, g2 = ops.Gain(1.0), ops.Gain(1.0)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(
        block, pipe_tpu_torch.Line(
            source=lambda ctx, b: Source(output=SignalProperties(44100.0, C),
                                         feed=feed),
            processors=[g1.processor(), g2.processor()], sink=sink.sink()),
        lookahead=lookahead, batch_blocks=batch_blocks)
    p.start()
    # random schedules, queued while the gated feed pins the frontier at 0
    grid = np.arange(9, n_blocks)

    def schedule(gain, k):
        blocks = np.sort(r.choice(grid, k, replace=False))
        vals = r.uniform(0.25, 2.0, blocks.size)
        for b, v in zip(blocks, vals):
            p.push(gain.set_gain(float(v)), at_block=int(b))
        return list(zip(blocks.tolist(), vals.tolist()))

    sched1, sched2 = schedule(g1, 20), schedule(g2, 20)
    # neutral surgery mid-flight (oracle-invariant, structurally real),
    # targeted so that it lands inside the stream however fast it runs
    g3 = ops.Gain(1.0)
    h1 = p.insert_processor(0, int(r.integers(0, 3)), g3.processor(),
                            at_block=int(r.integers(n_blocks // 4,
                                                    n_blocks // 2)))
    dest = p._exec_of_route[0].dest
    deadline = time.time() + 60
    while len(dest.pending_targets()) < 41:
        assert time.time() < deadline, "targets never delivered"
        time.sleep(0.002)
    gate.set()
    assert h1.wait(60) and h1.error is None
    side_src = mock.Source(channels=1, value=0.5, limit=10 * block)
    side_sink = mock.Sink()
    h2 = p.add_line(pipe_tpu_torch.Line(source=side_src.source(),
                                        sink=side_sink.sink()))
    assert h2.wait(60) and h2.error is None
    for _ in range(5):  # untargeted but neutral: stresses routing only
        p.push(g3.set_gain(1.0))
    p.wait(120)

    out = sink.values
    assert out.shape == (C, total)  # the EOF partial tail is delivered
    oracle = (data.astype(np.float64) * _step_gains(sched1, total, block)
              * _step_gains(sched2, total, block))
    assert snr_db(oracle, out) > 100
    assert side_sink.values.shape == (1, 10 * block)
    assert np.allclose(side_sink.values, 0.5)

    # restart: initializers reset the params; the feed rewinds
    pos[0] = 0
    gate.clear()
    p.start(g1.set_gain(1.0), g2.set_gain(1.0), g3.set_gain(1.0))
    blocks = np.sort(r.choice(grid, 10, replace=False))
    vals = r.uniform(0.5, 1.5, blocks.size)
    for b, v in zip(blocks, vals):
        p.push(g1.set_gain(float(v)), at_block=int(b))
    deadline = time.time() + 60
    while len(dest.pending_targets()) < 10:
        assert time.time() < deadline, "targets never delivered"
        time.sleep(0.002)
    gate.set()
    p.wait(120)
    out2 = sink.values[:, total:]
    assert out2.shape == (C, total)
    oracle2 = data.astype(np.float64) * _step_gains(
        list(zip(blocks.tolist(), vals.tolist())), total, block)
    assert snr_db(oracle2, out2) > 100


@pytest.mark.parametrize("lookahead,batch_blocks",
                         [(1, 1), (4, 1), (1, 4), (4, 4)])
def test_soak_randomized_mutations_surgery_eof_restart(lookahead, batch_blocks):
    _randomized_soak(lookahead, batch_blocks)


@pytest.mark.parametrize("batch_blocks", [1, 32])
def test_soak_stop_midstream_under_load(batch_blocks):
    """stop() while mutations are in flight on an unbounded stream: a clean
    exit at a block boundary, flush hooks run, no error raised."""
    gain = ops.Gain(1.0)
    src = mock.Source(channels=1, value=1.0, interval=0.002)  # unbounded
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(
        256, pipe_tpu_torch.Line(source=src.source(),
                                 processors=[gain.processor()],
                                 sink=sink.sink()),
        lookahead=8, batch_blocks=batch_blocks)
    p.start()
    deadline = time.time() + 60
    while sink.samples < 256 and time.time() < deadline:
        time.sleep(0.005)
    for i in range(10):
        p.push(gain.set_gain(1.0 + 0.1 * i))
    p.stop(120)
    assert sink.flushed
    n = sink.values.shape[1]
    assert n >= 256 and n % 256 == 0
    assert np.isfinite(sink.values).all()


def test_soak_failure_midstream_under_batching():
    """A feed failure deep in a batched stream with pending targeted
    mutations: first error wins, wait() raises, flush still runs."""
    fed = [0]

    def feed(n):
        if fed[0] >= 200 * 256:
            raise IOError("injected failure at block 200")
        fed[0] += n
        return np.ones((1, n), np.float32)

    gain = ops.Gain(1.0)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(
        256, pipe_tpu_torch.Line(
            source=lambda ctx, b: Source(output=SignalProperties(44100.0, 1),
                                         feed=feed),
            processors=[gain.processor()], sink=sink.sink()),
        lookahead=8, batch_blocks=32)
    p.start()
    p.push(gain.set_gain(2.0), at_block=100)
    p.push(gain.set_gain(0.5), at_block=3000)
    with pytest.raises(RunError, match="injected failure"):
        p.wait(120)
    assert sink.flushed


# -- latency budget (tests/test_latency.py) -----------------------------------


def _measure_lag(lookahead: int, batch_blocks: int, n_blocks: int = 64,
                 block: int = 128):
    """Max (blocks fed) - (blocks received) observed at any sink receive."""
    data = np.arange(n_blocks * block, dtype=np.float32).reshape(1, -1)
    fed, received, max_lag, pos = [0], [0], [0], [0]

    def feed(n):
        if pos[0] >= data.shape[1]:
            return None
        c = data[:, pos[0]: pos[0] + n]
        pos[0] += n
        fed[0] += -(-c.shape[1] // block)
        return c

    def receive(arr):
        received[0] += arr.shape[1] / block
        max_lag[0] = max(max_lag[0], fed[0] - received[0])

    out = []
    pipe_tpu_torch.run(
        block,
        pipe_tpu_torch.Line(
            source=lambda ctx, bs: Source(output=SignalProperties(44100.0, 1),
                                          feed=feed),
            sink=lambda ctx, bs, props: Sink(
                receive=lambda a: (out.append(a), receive(a)))),
        lookahead=lookahead, batch_blocks=batch_blocks)
    assert received[0] == n_blocks  # nothing lost
    np.testing.assert_array_equal(np.concatenate(out, 1), data)
    return max_lag[0]


@pytest.mark.parametrize("lookahead", [1, 8, 32])
def test_latency_budget_lookahead(lookahead):
    lag = _measure_lag(lookahead, 1)
    assert lag <= (lookahead + 1) * 1, (
        f"lookahead={lookahead}: worst feed->sink lag {lag} blocks")
    if lookahead == 1:
        assert lag <= 2  # the reference's 1-buffer skid


def test_latency_budget_batched():
    lag = _measure_lag(lookahead=2, batch_blocks=8)
    assert lag <= (2 + 1) * 8, f"worst lag {lag} blocks"

"""The port's streaming runtime: the slice's line (FIR -> resampler ->
biquad EQ -> mix) through ``pipe_tpu_torch.run`` against ``pipe_tpu.run``
(also with ``lookahead``, ``batch_blocks`` and ``stats``), ``process``
against ``pipe_tpu.process``, and the lifecycle contracts of the
reference's test matrix (``pipe_test.go:191-459``) on the port's
executor."""

import threading

import numpy as np
import pytest
import scipy.signal
import torch

import pipe_tpu
import pipe_tpu_torch
from pipe_tpu import ops as jops
from pipe_tpu_torch import kernels, mutable, ops as tops
from pipe_tpu_torch.errors import ErrorRun, StartError
from pipe_tpu_torch.graph import Line, make_route
from pipe_tpu_torch.ops import biquad as tbq
from pipe_tpu_torch.ops.fused import FIRWithGain
from pipe_tpu_torch.runtime import (
    LineExecutor,
    MultiLineExecutor,
    run_executor,
)
from pipe_tpu_torch.signal import Signal, SignalProperties, snr_db
from test_torch_ops import stream

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

C, BLOCK = 8, 2352  # the resampler emits 2560 = 10 * 256 frames per block


def slice_processors(ops, channels):
    return [
        ops.FIR(ops.design_lowpass(255, 4000, 44100)).processor(),
        ops.Resampler(48000, 44100).processor(),
        ops.Biquad(np.stack([
            ops.design_peaking_eq(48000, 1000, 1.0, 3.0),
            ops.design_highshelf(48000, 8000, -2.0),
        ])).processor(),
        ops.ChannelMix(np.ones((2, channels)) / channels).processor(),
    ]


def test_slice_line_matches_jax(monkeypatch):
    """5 full blocks plus a partial one; the biquad takes the tiled path."""
    tiled = []
    ref_tiles = tbq._iir_tiles_ref
    monkeypatch.setattr(tbq, "_iir_tiles_ref",
                        lambda *a: tiled.append(1) or ref_tiles(*a))
    x = np.random.default_rng(30).standard_normal(
        (C, 5 * BLOCK + 1000)).astype(np.float32)
    ref = stream(pipe_tpu, slice_processors(jops, C), x, BLOCK)
    got = stream(pipe_tpu_torch, slice_processors(tops, C), x, BLOCK)
    assert got.shape == ref.shape == (2, -(-(5 * BLOCK + 1000) * 160 // 147))
    assert snr_db(ref, got) > 100
    assert len(tiled) == 4 * 6  # 2 sections x (forward + refine) x 6 blocks


# -- lifecycle ----------------------------------------------------------------


class Boom(Exception):
    pass


class Hooks:
    """A component's start/flush spies with optional injected failures."""

    def __init__(self, fail_start=False):
        self.fail_start = fail_start
        self.started = self.flushed = False

    def start(self):
        self.started = True
        if self.fail_start:
            raise Boom("start")

    def flush(self):
        self.flushed = True


def counting_line(n_frames, hooks, sink_fail_at=None, values=None):
    """Host-fed line of ones through a Gain(2) into a receiving sink."""
    fed = [0]
    received = [] if values is None else values

    def feed(block_size):
        if fed[0] >= n_frames:
            return None
        n = min(block_size, n_frames - fed[0])
        fed[0] += n
        return np.ones((1, n), np.float32)

    def receive(a):
        if sink_fail_at is not None and len(received) == sink_fail_at:
            raise Boom("sink")
        received.append(a)

    def src(mctx, b):
        return pipe_tpu_torch.Source(
            output=SignalProperties(sample_rate=100.0, channels=1),
            feed=feed, start=hooks[0].start, flush=hooks[0].flush)

    def sink(mctx, b, props):
        return pipe_tpu_torch.Sink(receive=receive, start=hooks[2].start,
                                   flush=hooks[2].flush)

    def proc(mctx, b, props):
        p = tops.Gain(2.0).processor()(mctx, b, props)
        p.start, p.flush = hooks[1].start, hooks[1].flush
        return p

    return Line(source=src, processors=[proc], sink=sink)


def test_run_values_and_partial_block():
    hooks = [Hooks(), Hooks(), Hooks()]
    got = []
    pipe_tpu_torch.run(512, counting_line(1040, hooks, values=got))
    assert [a.shape[1] for a in got] == [512, 512, 16]
    np.testing.assert_array_equal(np.concatenate(got, 1), 2.0)
    assert all(h.started and h.flushed for h in hooks)


def test_sink_error_gives_error_run_and_flushes_everything():
    hooks = [Hooks(), Hooks(), Hooks()]
    with pytest.raises(ErrorRun) as exc_info:
        pipe_tpu_torch.run(512, counting_line(4096, hooks, sink_fail_at=2))
    assert exc_info.value.is_(Boom)
    assert all(h.flushed for h in hooks)


def test_start_error_rolls_back_started_components():
    """The failing component and everything after it are not flushed
    (``pipe_test.go:307-329``)."""
    hooks = [Hooks(), Hooks(fail_start=True), Hooks()]
    with pytest.raises(StartError):
        pipe_tpu_torch.run(512, counting_line(1040, hooks))
    assert hooks[0].flushed
    assert hooks[1].started and not hooks[1].flushed
    assert not hooks[2].started and not hooks[2].flushed


@pytest.mark.parametrize(
    "knob", [{"mesh": object()}, {"optimize": True}],
    ids=["mesh", "optimize"],
)
def test_unported_knobs_raise(knob):
    """No knob of the JAX ``run`` is left unported. ``mesh`` takes a
    :func:`pipe_tpu_torch.parallel.make_mesh` mesh: anything else fails at
    build, before anything starts, and on a 1x1 mesh the line streams what
    it streams without one. ``optimize=True``: ``run`` fuses the line (the
    gain after the FIR folds into its taps) and streams what the unfused
    line streams."""
    hooks = [Hooks(), Hooks(), Hooks()]
    if "mesh" in knob:
        from pipe_tpu_torch import parallel

        with pytest.raises(AttributeError):
            pipe_tpu_torch.run(512, counting_line(1040, hooks), **knob)
        assert not any(h.started for h in hooks)
        pipe_tpu_torch.run(512, counting_line(1040, hooks),
                           mesh=parallel.make_mesh(1, 1))
        assert all(h.started and h.flushed for h in hooks)
        return
    x = np.random.default_rng(5).standard_normal((2, 1040)).astype(np.float32)
    h = tops.design_lowpass(31, 4000.0, 44100.0)
    fir, gain, out = tops.FIR(h), tops.Gain(0.5), []
    pos = [0]

    def feed(n):
        if pos[0] >= x.shape[1]:
            return None
        pos[0] += n
        return x[:, pos[0] - n: pos[0]]

    pipe_tpu_torch.run(512, pipe_tpu_torch.Line(
        source=lambda m, b: pipe_tpu_torch.Source(
            output=SignalProperties(sample_rate=44100.0, channels=2), feed=feed),
        processors=[fir.processor(), gain.processor()],
        sink=lambda m, b, p: pipe_tpu_torch.Sink(receive=out.append)), **knob)
    assert isinstance(fir._delegate, FIRWithGain) and gain._delegate is fir._delegate
    oracle = 0.5 * scipy.signal.lfilter(h, [1.0], x.astype(np.float64), axis=1)
    assert snr_db(oracle, np.concatenate(out, axis=1)) > 110


def test_device_source_eof_commits_no_state():
    """A device source counting blocks in its state: the EOF step's state
    is not committed and nothing reaches the sink after it; the partial
    final block carries its frame count."""
    limit, block = 1000, 256
    got = []

    def src(mctx, b):
        def step(state, params):
            n = state["sent"]
            frames = min(b, limit - n)
            data = torch.full((2, b), float(n // b))
            return {"sent": n + b}, Signal(data, torch.tensor(frames)), \
                torch.tensor(frames <= 0)

        return pipe_tpu_torch.Source(
            output=SignalProperties(sample_rate=1.0, channels=2), step=step,
            state={"sent": 0})

    def sink(mctx, b, props):
        return pipe_tpu_torch.Sink(receive=lambda a: got.append(a))

    route = make_route(Line(source=src, sink=sink), block)
    mle = MultiLineExecutor(executors=[LineExecutor(route, block)])
    run_executor(mle)
    assert [a.shape[1] for a in got] == [256, 256, 256, 232]
    assert route.source.state == {"sent": 1024}  # the EOF step's 1280 dropped
    assert [a[0, 0] for a in got] == [0.0, 1.0, 2.0, 3.0]


def test_device_sink_state_advances_by_valid_frames():
    """A device sink (step over tensors, no ``receive``) accumulating the
    valid frames of a host-fed stream with a partial final block."""

    def sink(mctx, b, props):
        def step(state, params, sig):
            return {"sum": state["sum"] + sig.data[:, : sig.frames].sum(1),
                    "frames": state["frames"] + sig.frames}

        return pipe_tpu_torch.Sink(
            step=step, state={"sum": torch.zeros(props.channels),
                              "frames": 0})

    x = np.random.default_rng(32).standard_normal((2, 1000)).astype(np.float32)
    pos = [0]

    def feed(n):
        if pos[0] >= x.shape[1]:
            return None
        pos[0] += n
        return x[:, pos[0] - n: pos[0]]

    line = Line(
        source=lambda m, b: pipe_tpu_torch.Source(
            output=SignalProperties(sample_rate=1.0, channels=2), feed=feed),
        processors=[tops.Gain(2.0).processor()],
        sink=sink,
    )
    route = make_route(line, 256)
    run_executor(MultiLineExecutor(executors=[LineExecutor(route, 256)]))
    assert route.sink.state["frames"] == 1000
    np.testing.assert_allclose(route.sink.state["sum"].numpy(),
                               2.0 * x.sum(1), rtol=1e-5)


def test_targeted_mutation_lands_at_its_block():
    """A gain change pushed for block 2 through the executor's mutation
    destination lands exactly at that block boundary."""
    gain = tops.Gain(1.0)
    got = []
    ctx = mutable.mutable()
    line = Line(
        source=lambda m, b: pipe_tpu_torch.Source(
            output=SignalProperties(sample_rate=1.0, channels=1),
            feed=lambda n: np.ones((1, n), np.float32)
            if sum(a.shape[1] for a in got) < 4 * n else None),
        processors=[gain.processor()],
        sink=lambda m, b, p: pipe_tpu_torch.Sink(receive=got.append),
        context=ctx,
    )
    dest = mutable.Destination()
    mle = MultiLineExecutor(context=ctx, dest=dest,
                            executors=[LineExecutor(make_route(line, 64), 64)])
    pusher = mutable.Pusher()
    pusher.add_destination(ctx, dest)
    pusher.put(gain.set_gain(3.0), at_block=2)
    pusher.push()
    run_executor(mle)
    assert [float(a[0, 0]) for a in got] == [1.0, 1.0, 3.0, 3.0]


def test_cancel_stops_at_a_block_boundary_and_flushes():
    hooks = [Hooks(), Hooks(), Hooks()]
    cancel = threading.Event()
    cancel.set()
    pipe_tpu_torch.run(512, counting_line(10**9, hooks), cancel=cancel)
    assert all(h.flushed for h in hooks)


def test_cpu_run_launches_no_kernel():
    before = kernels.launch_counts()["iir_tiles"]
    x = np.random.default_rng(31).standard_normal((C, BLOCK)).astype(np.float32)
    stream(pipe_tpu_torch, slice_processors(tops, C), x, BLOCK)
    assert kernels.launch_counts()["iir_tiles"] == before


@pytest.mark.parametrize("lookahead,batch_blocks", [(4, 1), (1, 4), (4, 4)])
def test_slice_line_knobs_match_jax(lookahead, batch_blocks):
    """The slice under the dispatch knobs: the same output as the JAX
    package's default run (>= 100 dB), and exactly the port's own
    one-block-per-dispatch output."""
    x = np.random.default_rng(33).standard_normal(
        (C, 6 * BLOCK + 700)).astype(np.float32)
    ref = stream(pipe_tpu, slice_processors(jops, C), x, BLOCK)
    base = stream(pipe_tpu_torch, slice_processors(tops, C), x, BLOCK)
    got = []
    pos = [0]

    def feed(n):
        if pos[0] >= x.shape[1]:
            return None
        pos[0] += n
        return x[:, pos[0] - n: pos[0]]

    stats = pipe_tpu_torch.StatsRecorder()
    pipe_tpu_torch.run(BLOCK, Line(
        source=lambda m, b: pipe_tpu_torch.Source(
            output=SignalProperties(44100.0, C), feed=feed),
        processors=slice_processors(tops, C),
        sink=lambda m, b, p: pipe_tpu_torch.Sink(receive=got.append)),
        lookahead=lookahead, batch_blocks=batch_blocks, stats=stats)
    got = np.concatenate(got, 1)
    assert got.shape == ref.shape
    assert snr_db(ref, got) > 100
    np.testing.assert_array_equal(got, base)
    ls = stats.lines["line0"]
    # 6 full blocks + 1 partial + the call that finds the feed's EOF, as
    # the JAX package counts them
    assert ls.blocks == 8 and ls.wall_s > 0
    assert "line0: 8 blocks" in stats.report()


def test_stats_count_blocks_not_dispatches():
    """One dispatch of a 4-block batch counts 4 blocks. The mock source's
    EOF is a host bool, so the count stops at the last block (the JAX
    package scans whole batches past EOF and counts 12)."""
    stats = pipe_tpu_torch.StatsRecorder()
    src = pipe_tpu_torch.mock.Source(channels=2, limit=10 * 64)
    pipe_tpu_torch.run(64, Line(source=src.source(),
                                sink=pipe_tpu_torch.mock.Sink().sink()),
                       batch_blocks=4, stats=stats)
    assert stats.total_blocks == 10
    assert stats.lines["line0"].frames == 10 * 64


@pytest.mark.parametrize("block_size", [2352, 1000])
def test_process_matches_jax(block_size):
    """``process`` (device source over the whole array, lookahead 8) gives
    ``pipe_tpu.process``'s output: the slice at the tiled block and at a
    block off every fast path."""
    x = np.random.default_rng(34).standard_normal((C, 9000)).astype(np.float32)
    ref = pipe_tpu.process(x, slice_processors(jops, C), block_size=block_size)
    got = pipe_tpu_torch.process(x, slice_processors(tops, C),
                                 block_size=block_size)
    assert got.shape == ref.shape == (2, -(-9000 * 160 // 147))
    assert snr_db(ref, got) > 100


def test_process_empty_and_mono():
    y = pipe_tpu_torch.process(np.zeros(0, np.float32),
                               [tops.Gain(2.0).processor()])
    assert y.shape == (1, 0)
    y = pipe_tpu_torch.process(np.arange(10.0), [tops.Gain(2.0).processor()],
                               block_size=4)
    np.testing.assert_array_equal(y, 2.0 * np.arange(10.0)[None, :])


def test_device_source_with_device_eof_flag_gates_state(monkeypatch):
    """A device source whose ``eof`` is a 0-d bool tensor on the card: the
    block runs, its states are gated with ``torch.where`` and the flag is
    resolved with the output. Simulated on the CPU by routing the flag
    through the card path: the EOF step's state is not committed and
    nothing after it reaches the sink."""
    from pipe_tpu_torch.runtime import executor as ex

    limit, block = 1000, 256
    got = []
    gated = []
    monkeypatch.setattr(ex, "_gate", lambda eof, new, old: gated.append(1)
                        or (old if bool(eof) else new))

    class CardFlag(torch.Tensor):
        is_cuda = True

    def src(mctx, b):
        def step(state, params):
            n = state["sent"]
            frames = max(0, min(b, limit - n))
            eof = torch.tensor(frames <= 0).as_subclass(CardFlag)
            return {"sent": n + b}, Signal(torch.full((1, b), float(n)),
                                           frames), eof

        return pipe_tpu_torch.Source(
            output=SignalProperties(sample_rate=1.0, channels=1), step=step,
            state={"sent": 0})

    route = make_route(Line(source=src, sink=lambda m, b, p:
                            pipe_tpu_torch.Sink(receive=got.append)), block)
    le = LineExecutor(route, block, lookahead=3)
    monkeypatch.setattr(le, "_stage", lambda sig, eof: _cpu_stage(le, sig, eof))
    run_executor(MultiLineExecutor(executors=[le]))
    assert [a.shape[1] for a in got] == [256, 256, 256, 232]
    assert route.source.state == {"sent": 1024}  # EOF blocks gated out
    # 4 blocks + 3 dispatched past EOF before the flag resolved (lookahead
    # 3), each gating the source's and the sink's state
    assert len(gated) == 2 * 7


def _cpu_stage(le, sig, eof):
    """``LineExecutor._stage`` with the EOF flag copied to a host tensor (the
    card path copies it into pinned memory)."""
    from pipe_tpu_torch.runtime.executor import _Block

    blk = _Block(sig.frames)
    if sig.frames > 0:
        blk.out = sig.data
    if eof is not None:
        blk.eof = torch.tensor(bool(eof))
    return blk


def test_gate_selects_leafwise():
    """``_gate`` keeps the old tree where the flag is set: tensor leaves by
    ``torch.where``, host leaves by the flag's value."""
    from pipe_tpu_torch.runtime.executor import _gate

    old = {"a": torch.zeros(2), "n": 3, "k": 1, "none": None}
    new = {"a": torch.ones(2), "n": 3, "k": 2, "none": None}
    kept = _gate(torch.tensor(True), new, old)
    assert torch.equal(kept["a"], old["a"]) and kept["k"] == 1
    moved = _gate(torch.tensor(False), new, old)
    assert torch.equal(moved["a"], new["a"]) and moved["k"] == 2
    assert kept["none"] is None and moved["n"] == 3
    with pytest.raises(ValueError, match="structure"):
        _gate(torch.tensor(False), {"a": 1}, {"b": 1})

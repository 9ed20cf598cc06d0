"""The port's async Pipe: the lifecycle matrix of ``tests/test_pipe.py``
(start/wait, restart with initializers, sync groups, mutation push, live
surgery; reference ``pipe_test.go:82-189,461-639``) on ``pipe_tpu_torch``
with its mock kit, and the ``examples/live_mixing_desk.py`` scenario run
through both packages with one push and surgery schedule."""

import inspect
import threading
import time

import numpy as np
import pytest

import pipe_tpu
import pipe_tpu_torch
from pipe_tpu_torch import mock, mutable
from pipe_tpu_torch.components import Source
from pipe_tpu_torch.errors import PipeError, RunError
from pipe_tpu_torch.signal import SignalProperties, snr_db

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

BLOCK = 512
N_BLOCKS = 862  # pipe_test.go:84 — 862 x 512-frame buffers


def wait_pipe(p, timeout, *inits):
    """The reference's waitPipe harness (pipe_test.go:641-653): start, wait
    with a deadline, fail on timeout or error."""
    p.start(*inits)
    err = []
    done = threading.Event()

    def waiter():
        try:
            p.wait()
        except BaseException as e:  # noqa: BLE001
            err.append(e)
        done.set()

    threading.Thread(target=waiter, daemon=True).start()
    if not done.wait(timeout):
        raise AssertionError("pipe timeout reached")
    if err:
        raise err[0]


def test_simple_pipe(pipe_timeout):
    """pipe_test.go:82-106: 862 x 512 x 2ch, exact counts."""
    source = mock.Source(limit=N_BLOCKS * BLOCK, channels=2)
    proc = mock.Processor()
    sink = mock.Sink(discard=True)
    p = pipe_tpu_torch.Pipe(BLOCK, pipe_tpu_torch.Line(
        source=source.source(),
        processors=pipe_tpu_torch.Processors(proc.processor()),
        sink=sink.sink()))
    wait_pipe(p, pipe_timeout)
    assert source.messages == N_BLOCKS
    assert source.samples == N_BLOCKS * BLOCK
    assert proc.messages == N_BLOCKS and proc.samples == N_BLOCKS * BLOCK
    assert sink.messages == N_BLOCKS
    assert sink.samples == N_BLOCKS * BLOCK


def test_no_lines_raises():
    with pytest.raises(ValueError):
        pipe_tpu_torch.Pipe(BLOCK)


@pytest.mark.parametrize("knob", [{"mesh": object()}, {"optimize": True}],
                         ids=["mesh", "optimize"])
def test_unported_knobs_raise(knob):
    """No knob of the JAX ``Pipe`` is left unported. ``mesh`` takes a
    :func:`pipe_tpu_torch.parallel.make_mesh` mesh (anything else fails at
    build, before a thread starts), and live surgery works on a 1x1 mesh in
    the form without ``at_block``: an inserted gain and an added line
    stream. ``optimize=True``: the Pipe fuses its line at build (two
    biquads into one cascade, a gain into the mix) and streams what the
    unfused line streams."""
    from pipe_tpu_torch import ops, parallel
    from pipe_tpu_torch.ops.fused import BiquadCascade, MixWithGain

    if "mesh" in knob:
        def line(sink):
            return pipe_tpu_torch.Line(
                source=mock.Source(limit=4 * BLOCK, value=1.0).source(),
                processors=[parallel.sharded.Gain(3.0).processor()],
                sink=sink.sink())

        with pytest.raises(AttributeError):
            pipe_tpu_torch.Pipe(BLOCK, line(mock.Sink()), **knob)
        sink, sink2 = mock.Sink(), mock.Sink()
        p = pipe_tpu_torch.Pipe(BLOCK, pipe_tpu_torch.Line(
            source=mock.Source(limit=64 * BLOCK, value=1.0,
                               interval=0.002).source(),
            processors=[parallel.sharded.Gain(3.0).processor()],
            sink=sink.sink()), mesh=parallel.make_mesh(1, 1))
        p.start()
        h1 = p.insert_processor(0, 0, parallel.sharded.Gain(2.0).processor())
        h2 = p.add_line(line(sink2))
        for h in (h1, h2):
            assert h.wait(60) and h.error is None, h.error
        p.wait(60)
        v = sink.values[0]
        assert v.shape == (64 * BLOCK,) and v[-1] == 6.0
        switch = np.flatnonzero(np.diff(v))
        assert set(np.unique(v)) <= {3.0, 6.0} and len(switch) <= 1
        assert all((i + 1) % BLOCK == 0 for i in switch)  # a block boundary
        assert sink2.values.shape == (1, 4 * BLOCK) and np.all(sink2.values == 3.0)
        return
    rows = [ops.design_peaking_eq(44100, 1000, 1.0, 3.0),
            ops.design_highshelf(44100, 8000, -2.0)]

    def run(optimize):
        eqs = [ops.Biquad(r) for r in rows]
        g, mx = ops.Gain(0.5), ops.ChannelMix(np.ones((1, 2)) / 2)
        sink = mock.Sink()
        p = pipe_tpu_torch.Pipe(BLOCK, pipe_tpu_torch.Line(
            source=mock.Source(value=1.0, channels=2, limit=8 * BLOCK).source(),
            processors=[e.processor() for e in eqs] + [g.processor(),
                                                       mx.processor()],
            sink=sink.sink()), optimize=optimize)
        p.start()
        p.wait(60)
        return p, eqs, g, sink.values

    p, eqs, g, fused = run(True)
    assert len(p.routes[0].processors) == 2
    assert all(isinstance(e._delegate, BiquadCascade) for e in eqs)
    assert isinstance(g._delegate, MixWithGain)
    _, _, _, plain = run(False)
    assert fused.shape == plain.shape == (1, 8 * BLOCK)
    assert snr_db(plain, fused) > 110


def test_host_sync_every_is_accepted_and_stored(pipe_timeout):
    """The JAX package's ``host_sync_every`` (default 16) is a knob of the
    port's ``Pipe`` too, stored as given. It paces the health rounds of a
    mesh larger than 1x1 (``tests/test_torch_hostsync.py`` counts them
    against the period on four ranks); without a mesh and on a 1x1 mesh
    there are no rounds, and the stream is the same whatever the period."""
    def line(sink):
        return pipe_tpu_torch.Line(
            source=mock.Source(limit=8 * BLOCK, channels=2).source(),
            sink=sink.sink())

    assert pipe_tpu_torch.Pipe(BLOCK, line(mock.Sink())).host_sync_every == 16
    for cls in (pipe_tpu.Pipe, pipe_tpu_torch.Pipe):  # the same default
        assert inspect.signature(cls).parameters["host_sync_every"].default == 16
    sink = mock.Sink(discard=True)
    p = pipe_tpu_torch.Pipe(BLOCK, line(sink), host_sync_every=3)
    assert p.host_sync_every == 3
    wait_pipe(p, pipe_timeout)
    assert sink.messages == 8 and sink.samples == 8 * BLOCK
    from pipe_tpu_torch import parallel

    mesh = parallel.make_mesh(1, 1)
    mesh.reset_stats()
    sink = mock.Sink(discard=True)
    p = pipe_tpu_torch.Pipe(BLOCK, line(sink), mesh=mesh, host_sync_every=3)
    assert p.host_sync_every == 3
    wait_pipe(p, pipe_timeout)
    assert sink.messages == 8 and sink.samples == 8 * BLOCK
    assert "health" not in mesh.stats and p.block_index() == 8


def test_reset_restart(pipe_timeout):
    """pipe_test.go:108-131: a completed pipe restarts; an initializer
    mutation resets the source so it produces again."""
    source = mock.Source(limit=100 * BLOCK, channels=2)
    sink = mock.Sink(discard=True)
    p = pipe_tpu_torch.Pipe(BLOCK, pipe_tpu_torch.Line(
        source=source.source(), sink=sink.sink()))
    wait_pipe(p, pipe_timeout)
    assert source.messages == 100
    assert source.samples == 100 * BLOCK

    wait_pipe(p, pipe_timeout, source.reset())
    assert sink.messages == 2 * 100
    assert sink.samples == 2 * 100 * BLOCK


def test_sync_line(pipe_timeout):
    """pipe_test.go:133-155: a line with a mutable context runs in sync
    mode."""
    source = mock.Source(limit=100 * BLOCK, channels=2)
    sink = mock.Sink(discard=True)
    p = pipe_tpu_torch.Pipe(BLOCK, pipe_tpu_torch.Line(
        source=source.source(), sink=sink.sink(), context=mutable.mutable()))
    wait_pipe(p, pipe_timeout)
    assert source.messages == 100
    assert source.samples == 100 * BLOCK


def test_a_sync_group_restarts_every_line(pipe_timeout):
    """A restart is a new stream for every line of a sync group, those that
    ended in the previous run included: the two lines stream again from
    their reset sources. (``pipe_tpu``'s group drops its lines as they end,
    so its restart runs no line and ``wait`` times out; the mesh soak's
    restart needs the port's behaviour.)"""
    ctx = mutable.mutable()
    src_a = mock.Source(limit=10 * BLOCK, channels=2)
    src_b = mock.Source(limit=4 * BLOCK, channels=2)
    sink_a, sink_b = mock.Sink(discard=True), mock.Sink(discard=True)
    p = pipe_tpu_torch.Pipe(
        BLOCK,
        pipe_tpu_torch.Line(source=src_a.source(), sink=sink_a.sink(), context=ctx),
        pipe_tpu_torch.Line(source=src_b.source(), sink=sink_b.sink(), context=ctx))
    wait_pipe(p, pipe_timeout)
    assert (sink_a.samples, sink_b.samples) == (10 * BLOCK, 4 * BLOCK)
    wait_pipe(p, pipe_timeout, src_a.reset(), src_b.reset())
    assert (sink_a.samples, sink_b.samples) == (20 * BLOCK, 8 * BLOCK)


def test_multiple_lines_shared_context(pipe_timeout):
    """pipe_test.go:156-189: two lines share one mutable context (one sync
    group)."""
    source1 = mock.Source(limit=100 * BLOCK, channels=2)
    source2 = mock.Source(limit=100 * BLOCK, channels=2)
    mctx = mutable.mutable()
    p = pipe_tpu_torch.Pipe(
        BLOCK,
        pipe_tpu_torch.Line(source=source1.source(),
                            sink=mock.Sink(discard=True).sink(), context=mctx),
        pipe_tpu_torch.Line(source=source2.source(),
                            sink=mock.Sink(discard=True).sink(), context=mctx),
    )
    wait_pipe(p, pipe_timeout)
    for s in (source1, source2):
        assert s.messages == 100
        assert s.samples == 100 * BLOCK


def test_push_mutation_mid_stream(pipe_timeout):
    """A parameter push lands mid-stream at a block boundary and changes the
    produced values."""
    total = 400
    source = mock.Source(value=1.0, channels=1, limit=total, interval=0.002)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(4, pipe_tpu_torch.Line(source=source.source(),
                                                   sink=sink.sink()))
    p.start()
    time.sleep(0.1)
    p.push(source.set_value(2.0))
    p.wait(pipe_timeout)
    vals = sink.values
    assert vals.shape == (1, total)
    assert vals[0, 0] == 1.0 and vals[0, -1] == 2.0
    assert len(np.flatnonzero(np.diff(vals[0]))) == 1  # one clean boundary


def test_mock_mutation_spy_via_push(pipe_timeout):
    source = mock.Source(value=1.0, channels=1, limit=2000, interval=0.001)
    p = pipe_tpu_torch.Pipe(4, pipe_tpu_torch.Line(
        source=source.source(), sink=mock.Sink(discard=True).sink()))
    p.start()
    p.push(source.mock_mutation())
    p.wait(pipe_timeout)
    assert source.mutated


def test_start_error_async(pipe_timeout):
    source = mock.Source(limit=100, channels=1,
                         error_on_start=RuntimeError("boom"))
    p = pipe_tpu_torch.Pipe(4, pipe_tpu_torch.Line(
        source=source.source(), sink=mock.Sink(discard=True).sink()))
    with pytest.raises(PipeError):
        wait_pipe(p, pipe_timeout)


def test_runtime_error_async_flushes(pipe_timeout):
    source = mock.Source(limit=100, channels=1)
    proc = mock.Processor(error_on_call=RuntimeError("boom"))
    sink = mock.Sink(discard=True)
    p = pipe_tpu_torch.Pipe(4, pipe_tpu_torch.Line(
        source=source.source(),
        processors=pipe_tpu_torch.Processors(proc.processor()),
        sink=sink.sink()))
    with pytest.raises(PipeError):
        wait_pipe(p, pipe_timeout)
    assert source.flushed and proc.flushed and sink.flushed


# -- live surgery (pipe_test.go:461-639) ---------------------------------------


@pytest.mark.parametrize("is_async", [True, False], ids=["async", "sync"])
def test_add_line(is_async, pipe_timeout):
    """pipe_test.go:461-508."""
    n = 100
    sink1, sink2 = mock.Sink(discard=True), mock.Sink(discard=True)
    line1 = pipe_tpu_torch.Line(
        source=mock.Source(limit=n * BLOCK, channels=2).source(),
        sink=sink1.sink())
    ctx = mutable.IMMUTABLE if is_async else mutable.mutable()
    line2 = pipe_tpu_torch.Line(
        source=mock.Source(limit=n * BLOCK, channels=2, value=2).source(),
        sink=sink2.sink(), context=ctx)
    p = pipe_tpu_torch.Pipe(BLOCK, line1)
    p.start()
    handle = p.add_line(line2)
    assert handle.wait(pipe_timeout)
    assert handle.error is None
    p.wait(pipe_timeout)
    for s in (sink1, sink2):
        assert s.messages == n
        assert s.samples == n * BLOCK


def test_add_line_into_running_group(pipe_timeout):
    """pipe_test.go:510-569: add two lines into a live sync group."""
    n = 100
    mctx = mutable.mutable()
    sinks = [mock.Sink(discard=True) for _ in range(4)]
    p = pipe_tpu_torch.Pipe(
        BLOCK,
        pipe_tpu_torch.Line(
            source=mock.Source(limit=n * BLOCK, channels=2).source(),
            sink=sinks[0].sink()),
        pipe_tpu_torch.Line(
            source=mock.Source(limit=n * BLOCK, channels=2, value=2).source(),
            sink=sinks[1].sink(), context=mctx),
    )
    p.start()
    for i in (2, 3):
        handle = p.add_line(pipe_tpu_torch.Line(
            source=mock.Source(limit=n * BLOCK, channels=2, value=2).source(),
            sink=sinks[i].sink(), context=mctx))
        assert handle.wait(pipe_timeout)
        assert handle.error is None
    p.wait(pipe_timeout)
    for s in sinks:
        assert s.messages == n
        assert s.samples == n * BLOCK


@pytest.mark.parametrize("pos", [0, 1], ids=["before_processor", "before_sink"])
def test_insert_processor(pos, pipe_timeout):
    """pipe_test.go:571-598."""
    p = pipe_tpu_torch.Pipe(2, pipe_tpu_torch.Line(
        source=mock.Source(limit=500, channels=2, interval=0.001).source(),
        processors=pipe_tpu_torch.Processors(mock.Processor().processor()),
        sink=mock.Sink(discard=True).sink()))
    p.start()
    proc = mock.Processor()
    handle = p.insert_processor(0, pos, proc.processor())
    assert handle.wait(pipe_timeout)
    assert handle.error is None
    p.wait(pipe_timeout)
    assert proc.messages > 0


@pytest.mark.parametrize(
    "pos,is_async", [(0, True), (1, True), (0, False), (1, False)],
    ids=["async_before_processor", "async_before_sink",
         "sync_before_processor", "sync_before_sink"],
)
def test_insert_multiple(pos, is_async, pipe_timeout):
    """pipe_test.go:600-639: double insert, async & sync; the sink still
    receives every sample."""
    samples = 500
    ctx = mutable.IMMUTABLE if is_async else mutable.mutable()
    sink = mock.Sink(discard=True)
    p = pipe_tpu_torch.Pipe(2, pipe_tpu_torch.Line(
        source=mock.Source(limit=samples, channels=2, interval=0.001).source(),
        processors=pipe_tpu_torch.Processors(mock.Processor().processor()),
        sink=sink.sink(), context=ctx))
    p.start()
    proc1, proc2 = mock.Processor(), mock.Processor()
    h1 = p.insert_processor(0, pos, proc1.processor())
    assert h1.wait(pipe_timeout)
    h2 = p.insert_processor(0, pos, proc2.processor())
    assert h2.wait(pipe_timeout)
    p.wait(pipe_timeout)
    assert sink.samples == samples
    assert proc1.messages > 0
    assert proc2.messages > 0


def test_mixed_sync_and_async_lines(pipe_timeout):
    """One pipe mixing a sync group with an async line (reference
    doc.go:23-28)."""
    mctx = mutable.mutable()
    s1 = mock.Source(channels=1, value=1.0, limit=512 * 6)
    s2 = mock.Source(channels=1, value=2.0, limit=512 * 6)
    s3 = mock.Source(channels=1, value=3.0, limit=512 * 9)
    k1, k2, k3 = mock.Sink(), mock.Sink(), mock.Sink()
    p = pipe_tpu_torch.Pipe(
        512,
        pipe_tpu_torch.Line(source=s1.source(), sink=k1.sink(), context=mctx),
        pipe_tpu_torch.Line(source=s2.source(), sink=k2.sink(), context=mctx),
        pipe_tpu_torch.Line(source=s3.source(), sink=k3.sink()),  # async
    )
    p.start()
    p.wait(pipe_timeout)
    assert k1.values.shape == (1, 512 * 6) and np.allclose(k1.values, 1.0)
    assert k2.values.shape == (1, 512 * 6) and np.allclose(k2.values, 2.0)
    assert k3.values.shape == (1, 512 * 9) and np.allclose(k3.values, 3.0)


def test_stop_unbounded_pipe(pipe_timeout):
    """An unlimited source runs until stop(), which cancels at a block
    boundary with flush hooks run."""
    src = mock.Source(channels=1, value=1.0, interval=0.002)  # no limit
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(512, pipe_tpu_torch.Line(source=src.source(),
                                                     sink=sink.sink()))
    p.start()
    time.sleep(0.3)
    p.stop(pipe_timeout)
    out = sink.values
    assert out.shape[1] > 0 and out.shape[1] % 512 == 0  # block-aligned
    assert src.hooks.flushed and sink.hooks.flushed
    p.stop()  # idempotent no-op


def test_run_with_cancel_event():
    cancel = threading.Event()
    src = mock.Source(channels=1, value=1.0, interval=0.002)  # unbounded
    sink = mock.Sink()
    t = threading.Timer(0.3, cancel.set)
    t.start()
    pipe_tpu_torch.run(512, pipe_tpu_torch.Line(source=src.source(),
                                                sink=sink.sink()),
                       cancel=cancel)
    t.join(10)
    assert sink.values.shape[1] > 0
    assert src.hooks.flushed


def test_failing_pipe_mutation_fails_wait(pipe_timeout):
    """A pipe-context mutation that raises joins the error fan-in."""
    src = mock.Source(channels=1, value=1.0, interval=0.002)  # unbounded
    sink = mock.Sink(discard=True)
    p = pipe_tpu_torch.Pipe(512, pipe_tpu_torch.Line(source=src.source(),
                                                     sink=sink.sink()))
    p.start()

    def boom():
        raise RuntimeError("registered mutation failed")

    p.push(p.mctx.mutate(boom))
    with pytest.raises(Exception, match="registered mutation failed"):
        p.wait(pipe_timeout)
    assert src.hooks.flushed and sink.hooks.flushed


def test_pipe_context_manager(pipe_timeout):
    """with-block sugar: a bounded stream completes inside the block via
    wait(); an unbounded one is stopped cleanly at exit."""
    src = mock.Source(channels=1, value=1.0, limit=1024)
    sink = mock.Sink()
    with pipe_tpu_torch.Pipe(256, pipe_tpu_torch.Line(
            source=src.source(), sink=sink.sink())).start() as p:
        p.wait(pipe_timeout)
    assert sink.values.shape == (1, 1024)

    src2 = mock.Source(channels=1, value=2.0, interval=0.002)  # unbounded
    sink2 = mock.Sink()
    with pipe_tpu_torch.Pipe(256, pipe_tpu_torch.Line(
            source=src2.source(), sink=sink2.sink())).start():
        deadline = time.time() + pipe_timeout
        while sink2.samples < 256 and time.time() < deadline:
            time.sleep(0.005)
    assert sink2.flushed and sink2.samples >= 256


def test_pipe_context_manager_error_propagates(pipe_timeout):
    src = mock.Source(channels=1, value=1.0, limit=4096,
                      error_on_call=IOError("boom"))
    with pytest.raises(RunError):
        with pipe_tpu_torch.Pipe(256, pipe_tpu_torch.Line(
                source=src.source(), sink=mock.Sink().sink())).start() as p:
            p.wait(pipe_timeout)


def _stuck_line(release):
    def feed(n):
        release.wait(60)
        return None

    return pipe_tpu_torch.Line(
        source=lambda ctx, block: Source(output=SignalProperties(44100.0, 1),
                                         feed=feed),
        sink=mock.Sink().sink())


def test_wait_timeout_bounds_stuck_executor():
    """wait(timeout) must not hang on a wedged executor thread."""
    release = threading.Event()
    p = pipe_tpu_torch.Pipe(256, _stuck_line(release))
    p.start()
    t0 = time.time()
    with pytest.raises(RunError, match="timeout"):
        p.wait(1.0)
    assert time.time() - t0 < 10
    release.set()
    p.wait(10.0)


def test_wait_timeout_cancels_run_and_guards_restart():
    """A timed-out wait() cancels the run, start() refuses while the old
    threads are still alive, and once a second wait() re-joins them a
    restart runs cleanly (``pipe.go:249-257``)."""
    release = threading.Event()
    p = pipe_tpu_torch.Pipe(256, _stuck_line(release))
    p.start()
    with pytest.raises(RunError, match="timeout"):
        p.wait(0.5)
    with pytest.raises(RuntimeError, match="winding down"):
        p.start()
    release.set()
    p.wait(10.0)
    p.start()
    p.wait(10.0)
    assert p.block_index() == 0  # EOF on the first feed of the new stream


# -- the live mixing desk, both packages ---------------------------------------


def _desk(pkg, block=512, n_blocks=24):
    """``examples/live_mixing_desk.py`` with a deterministic schedule: two
    gated tone lines with gains (lookahead 4, stats on), three gain pushes
    and a peaking-EQ insert into line 0 at fixed blocks, and a third line
    added live. Returns the three sinks' outputs."""
    C, sr = 2, 44100
    gate = threading.Event()
    n = n_blocks * block + 100  # a partial final block

    def tone(value):
        pos = [0]

        def feed(m):
            gate.wait(60)
            if pos[0] >= n:
                return None
            k = min(m, n - pos[0])
            pos[0] += k
            return np.full((C, k), value, np.float32)

        return lambda ctx, b: pkg.Source(
            output=pkg.SignalProperties(sample_rate=float(sr), channels=C),
            feed=feed)

    gain_a, gain_b = pkg.ops.Gain(1.0), pkg.ops.Gain(1.0)
    out_a, out_b, out_c = pkg.mock.Sink(), pkg.mock.Sink(), pkg.mock.Sink()
    stats = pkg.StatsRecorder()
    p = pkg.Pipe(
        block,
        pkg.Line(source=tone(0.30), sink=out_a.sink(),
                 processors=[gain_a.processor()]),
        pkg.Line(source=tone(0.20), sink=out_b.sink(),
                 processors=[gain_b.processor()]),
        stats=stats, lookahead=4,
    )
    p.start()
    for at, g in ((3, 0.8), (7, 0.5), (11, 0.25)):
        p.push(gain_a.set_gain(g), at_block=at)
    eq = pkg.ops.Biquad(pkg.ops.design_peaking_eq(sr, freq=1000, q=1.0,
                                                  gain_db=6.0))
    h = p.insert_processor(0, 1, eq.processor(), at_block=9)
    dest = p._exec_of_route[0].dest
    deadline = time.time() + 60
    while sorted(dest.pending_targets()) != [3, 7, 9, 11]:
        assert time.time() < deadline, "targets never delivered"
        time.sleep(0.002)
    gate.set()
    assert h.wait(60) and h.error is None, h.error
    bed = pkg.mock.Source(value=0.05, channels=2, limit=8 * block + 7)
    h2 = p.add_line(pkg.Line(source=bed.source(), sink=out_c.sink()))
    assert h2.wait(60) and h2.error is None
    p.wait(120)
    assert stats.total_blocks > 0
    return out_a.values, out_b.values, out_c.values


def test_live_mixing_desk_matches_jax():
    import pipe_tpu.mock  # noqa: F401  (pipe_tpu exports no `mock` name)
    import pipe_tpu.ops  # noqa: F401
    import pipe_tpu_torch.ops  # noqa: F401

    ref = _desk(pipe_tpu)
    got = _desk(pipe_tpu_torch)
    for r, g in zip(ref, got):
        assert g.shape == r.shape
        assert snr_db(r, g) >= 100
    a = got[0][0]
    assert a[0] == np.float32(0.30)
    assert a[3 * 512] == np.float32(0.30) * np.float32(0.8)  # exact landing
    assert a[3 * 512 - 1] == np.float32(0.30)

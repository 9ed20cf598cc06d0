"""Jobs for the rank pool of ``tests/torch_mesh_worker.py`` that drive the
health rounds of the port's mesh ``Pipe`` (``pipe_tpu_torch.parallel.hostsync``):
the scenarios of ``tests/dcn_stream_worker.py`` (one process per shard, so
a "host" of the JAX tests is a rank here), live surgery on mesh lines, the
randomized soak on a mesh, and a few probes of the rounds themselves.

Every job runs in every rank with the same arguments and returns plain
values (outputs, the error each rank saw, counts); the test process holds
them to the float64 oracles and to each other. A pool runs a job of this
module by the name ``"tests.torch_hostsync_jobs:<function>"``.
"""

import threading
import time

import numpy as np

C, CHUNK = 2, 512  # the streaming scenarios' channels and block


def lowpass():
    from pipe_tpu_torch import ops

    return np.asarray(ops.design_lowpass(63, 4000, 44100))


def stream_data(n_chunks, seed=7, channels=C, block=CHUNK, tail=0):
    """The stream every rank is fed: the same seeded samples everywhere."""
    return np.random.default_rng(seed).standard_normal(
        (channels, block * n_chunks + tail)).astype(np.float32)


class Feed:
    """A host feed over ``data``: ``chunky`` (a seed) returns random-length
    reads, ``holds`` maps a frame position to an ``Event`` the feed waits
    for before reading past it, ``fail_at`` raises there."""

    def __init__(self, data, chunky=None, holds=None, fail_at=None, rank=0):
        self.data, self.pos = data, 0
        self.r = None if chunky is None else np.random.default_rng(chunky)
        self.holds = dict(holds or {})
        self.fail_at, self.rank = fail_at, rank

    def __call__(self, n):
        for at, ev in list(self.holds.items()):
            if self.pos >= at:
                ev.wait(60)
                del self.holds[at]
        if self.fail_at is not None and self.pos >= self.fail_at:
            raise IOError(f"injected failure on rank {self.rank}")
        if self.pos >= self.data.shape[1]:
            return None
        take = n
        if self.r is not None:
            take = min(int(self.r.integers(1, n + 1)), self.data.shape[1] - self.pos)
        c = self.data[:, self.pos:self.pos + take]
        self.pos += c.shape[1]
        return c


def feed_line(pt, feed, channels, processors, sink, context=None, sr=44100.0):
    kw = {} if context is None else {"context": context}
    return pt.Line(
        source=lambda ctx, b: pt.Source(
            output=pt.SignalProperties(sr, channels), feed=feed),
        processors=processors, sink=sink.sink(), **kw)


def wait_for(cond, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)


def finish(p, res, timeout=60.0):
    """``p.wait`` with the error (type, message, cause type) recorded and
    the seconds it took."""
    t0 = time.monotonic()
    try:
        p.wait(timeout)
        res["error"] = None
    except Exception as e:  # noqa: BLE001 - reported to the test
        cause = e.__cause__
        res["error"] = (type(e).__name__, str(e),
                        type(cause).__name__ if cause is not None else None)
        try:
            p.wait(timeout)
        except Exception:  # noqa: BLE001
            pass
    res["wait_s"] = time.monotonic() - t0
    res["blocks"] = p.block_index()
    return res


def health(m):
    return list(m.stats.get("health", [0, 0]))


# ---------------------------------------------------------------------------
# the scenarios of tests/dcn_stream_worker.py
# ---------------------------------------------------------------------------


def stream_job(rank, mesh, n_chunks, every=16, batch_blocks=1, switch=None,
               splice=None, chunky=None, tail=0, seed=7, lookahead=1):
    """FIR(h1) on the mesh; a ``set_taps(h1 / 2)`` targeted at ``switch``
    and a ``Gain(0.5)`` inserted after the FIR at ``splice`` on every rank,
    both delivered before the stream reaches them (a gate in the feed)."""
    import pipe_tpu_torch as pt
    from pipe_tpu_torch import mock, parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    h1 = lowpass()
    gate = threading.Event()
    data = stream_data(n_chunks, seed, tail=tail)
    fir, sink = parallel.sharded.FIR(h1), mock.Sink()
    p = pt.Pipe(CHUNK, feed_line(pt, Feed(data, chunky, {0: gate}), C,
                                 [fir.processor()], sink),
                mesh=m, host_sync_every=every, batch_blocks=batch_blocks,
                lookahead=lookahead)
    m.reset_stats()
    p.start()
    targets, hdl = [], None
    if switch is not None:
        p.push(fir.set_taps(h1 * 0.5), at_block=switch)
        targets.append(switch)
    if splice is not None:
        hdl = p.insert_processor(0, 1, parallel.sharded.Gain(0.5).processor(),
                                 at_block=splice)
        targets.append(splice)
    dest = p._executors[0].dest
    wait_for(lambda: sorted(dest.pending_targets()) == sorted(targets),
             "targets never delivered")
    gate.set()
    res = finish(p, {})
    res["out"] = sink.values
    res["handle"] = None if hdl is None else (hdl.done(), repr(hdl.error))
    res["health"] = health(m)
    return res


def untargeted_job(rank, mesh, n_chunks, every=16, push_after=32, stagger=0.0,
                   hold_at=40, pushers=None, stale_rounds=None, seed=7):
    """FIR(h1); once the stream passed ``push_after`` blocks, every rank of
    ``pushers`` (all when None) waits ``stagger * rank`` seconds and pushes
    ``set_taps(h1 / 2)`` without ``at_block``. A pushing rank's feed holds
    at block ``hold_at`` until its push is queued, so the push is never
    later than that block."""
    import pipe_tpu_torch as pt
    from pipe_tpu_torch import mock, parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    h1 = lowpass()
    pushes = pushers is None or rank in pushers
    queued = threading.Event()
    holds = {hold_at * CHUNK: queued} if pushes else {}
    fir, sink = parallel.sharded.FIR(h1), mock.Sink()
    p = pt.Pipe(CHUNK, feed_line(pt, Feed(stream_data(n_chunks, seed), None,
                                          holds), C, [fir.processor()], sink),
                mesh=m, host_sync_every=every)
    if stale_rounds is not None:
        p.UNTARGETED_STALE_ROUNDS = stale_rounds
    m.reset_stats()
    p.start()
    if pushes:
        wait_for(lambda: p.block_index() >= push_after, "stream never started")
        time.sleep(stagger * rank)
        p.push(fir.set_taps(h1 * 0.5))
        queued.set()
    res = finish(p, {})
    res["out"] = sink.values
    res["health"] = health(m)
    return res


def abort_job(rank, mesh, n_chunks, fail_rank, fail_at, every=16,
              batch_blocks=1, where="feed", seed=7, group=False):
    """FIR(h1); on ``fail_rank`` the feed raises at block ``fail_at``
    (``where="feed"``), the sink at its ``fail_at``-th block (``"sink"``),
    the main thread stops the pipe once it dispatched ``fail_at`` blocks
    (``"stop"``), or a processor's start hook raises (``"start"``). With
    ``group`` the line runs in a sync group (a mutable context) of its own.
    Returns every rank's error and how long ``wait`` took."""
    import pipe_tpu_torch as pt
    from pipe_tpu_torch import mock, parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    fails = rank == fail_rank
    feed = Feed(stream_data(n_chunks, seed),
                fail_at=fail_at * CHUNK if fails and where == "feed" else None,
                rank=rank)
    sink = mock.Sink()
    if fails and where == "sink":
        inner = sink.sink()

        def alloc(ctx, b, props):
            comp = inner(ctx, b, props)
            receive = comp.receive

            def failing(block):
                if sink.messages >= fail_at:
                    raise IOError(f"sink failed on rank {rank}")
                receive(block)
            comp.receive = failing
            return comp
        line = pt.Line(source=lambda ctx, b: pt.Source(
            output=pt.SignalProperties(44100.0, C), feed=feed),
            processors=[parallel.sharded.FIR(lowpass()).processor()], sink=alloc)
    else:
        procs = [parallel.sharded.FIR(lowpass()).processor()]
        if fails and where == "start":
            inner_proc = parallel.sharded.Gain(1.0).processor()

            def failing_start(ctx, b, props):
                comp = inner_proc(ctx, b, props)

                def start():
                    raise IOError(f"start failed on rank {rank}")
                comp.start = start
                return comp
            procs.append(failing_start)
        else:
            procs.append(parallel.sharded.Gain(1.0).processor())
        line = feed_line(pt, feed, C, procs, sink,
                         pt.mutable.mutable() if group else None)
    p = pt.Pipe(CHUNK, line, mesh=m, host_sync_every=every,
                batch_blocks=batch_blocks)
    m.reset_stats()
    t0 = time.monotonic()
    p.start()
    if fails and where == "stop":
        wait_for(lambda: p.block_index() >= fail_at, "stream never started")
        try:
            p.stop(60)
        except Exception:  # noqa: BLE001 - recorded by finish below
            pass
    res = finish(p, {})
    res["wall_s"] = time.monotonic() - t0
    res["frames"] = sink.samples
    res["health"] = health(m)
    return res


def ols_delay_job(rank, mesh, n_chunks, every=16):
    """The heavy collectives: a bin-sharded OLS (IR of 300 taps, more than a
    rank's block), a feedback delay and a unity STFT stage."""
    import pipe_tpu_torch as pt
    from pipe_tpu_torch import mock, parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    rng2 = np.random.default_rng(13)
    ir = rng2.standard_normal(300) * np.exp(-np.arange(300) / 60.0)
    d2 = rng2.standard_normal((C, CHUNK * n_chunks)).astype(np.float32)
    sh, sink = parallel.sharded, mock.Sink()
    p = pt.Pipe(CHUNK, feed_line(pt, Feed(d2), C, [
        sh.OLS(ir).processor(),
        sh.Delay(100, feedback=0.4, wet=0.3, dry=1.0).processor(),
        sh.SpectralGain(64, 16).processor()], sink),
        mesh=m, host_sync_every=every)
    m.reset_stats()
    p.start()
    res = finish(p, {})
    res["out"], res["health"] = sink.values, health(m)
    return res


def mix_psum_job(rank, mesh, n_chunks, every=16):
    """FIR then the merged mixer: the channel axis spans the ranks, so the
    mix's reduction crosses between processes every block."""
    import pipe_tpu_torch as pt
    from pipe_tpu_torch import mock, parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    rng4 = np.random.default_rng(17)
    d4 = rng4.standard_normal((4, CHUNK * n_chunks)).astype(np.float32)
    mixm = rng4.standard_normal((2, 4)).astype(np.float32)
    sh, sink = parallel.sharded, mock.Sink()
    p = pt.Pipe(CHUNK, feed_line(pt, Feed(d4), 4, [
        sh.FIR(lowpass()).processor(), sh.Mix(mixm).processor()], sink),
        mesh=m, host_sync_every=every)
    p.start()
    res = finish(p, {})
    res["out"] = sink.values
    return res


def late_target_job(rank, mesh, n_chunks, target, every=16):
    """A target past the end of the stream: every rank must fail."""
    import pipe_tpu_torch as pt
    from pipe_tpu_torch import mock, parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    fir, sink = parallel.sharded.FIR(lowpass()), mock.Sink(discard=True)
    gate = threading.Event()
    p = pt.Pipe(CHUNK, feed_line(pt, Feed(np.zeros((C, CHUNK * n_chunks),
                                                   np.float32), None, {0: gate}),
                                 C, [fir.processor()], sink),
                mesh=m, host_sync_every=every)
    p.start()
    p.push(fir.set_taps(lowpass() * 0.5), at_block=target)
    wait_for(lambda: p._executors[0].dest.pending_targets() == [target],
             "target never delivered")
    gate.set()
    return finish(p, {})


def multiline_job(rank, mesh, n_chunks, splice, every=16):
    """Two lines in one sync group, line A half as long as line B; a
    ``Gain(0.5)`` inserted into line A at ``splice`` on every rank."""
    import pipe_tpu_torch as pt
    from pipe_tpu_torch import mock, parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    h1 = lowpass()
    ctx = pt.mutable.mutable()
    gate = threading.Event()
    da = stream_data(n_chunks // 2, 7)
    db = stream_data(n_chunks, 8)
    sa, sb = mock.Sink(), mock.Sink()
    p = pt.Pipe(CHUNK,
                feed_line(pt, Feed(da, None, {0: gate}), C,
                          [parallel.sharded.FIR(h1).processor()], sa, ctx),
                feed_line(pt, Feed(db), C,
                          [parallel.sharded.FIR(h1 * 0.5).processor()], sb, ctx),
                mesh=m, host_sync_every=every)
    p.start()
    hdl = p.insert_processor(0, 1, parallel.sharded.Gain(0.5).processor(),
                             at_block=splice)
    wait_for(lambda: p._executors[0].dest.pending_targets() == [splice],
             "the insert never delivered")
    gate.set()
    res = finish(p, {})
    res["out"] = [sa.values, sb.values]
    res["handle"] = (hdl.done(), repr(hdl.error))
    return res


def ckpt_job(rank, mesh, n_chunks, every=16):
    """FIR -> bin-sharded OLS -> Biquad over the first half, a snapshot, a
    fresh pipe restored from it over the second half."""
    import pipe_tpu_torch as pt
    from pipe_tpu_torch import checkpoint, mock, ops, parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    sos = ops.design_peaking_eq(44100, freq=600, q=1.5, gain_db=3.0)
    rng3 = np.random.default_rng(9)
    ir = rng3.standard_normal(300) * np.exp(-np.arange(300) / 60.0)
    d = rng3.standard_normal((C, CHUNK * n_chunks)).astype(np.float32)
    sh = parallel.sharded

    def make(part):
        s = mock.Sink()
        return s, pt.Pipe(CHUNK, feed_line(pt, Feed(part), C, [
            sh.FIR(lowpass()).processor(), sh.OLS(ir).processor(),
            sh.Biquad(sos).processor()], s), mesh=m, host_sync_every=every)

    half = CHUNK * (n_chunks // 2)
    sa, pa = make(d[:, :half])
    pa.start()
    res = finish(pa, {})
    if res["error"] is not None:
        return res
    ck = checkpoint.snapshot(pa)
    sb, pb = make(d[:, half:])
    checkpoint.restore(pb, ck)
    pb.start()
    res = finish(pb, res)
    res["out"] = np.concatenate([sa.values, sb.values], axis=1)
    return res


def width_insert_job(rank, mesh, n_chunks, at, every=8, block=1176,
                     violate=False):
    """A 44.1k -> 48k ``Resample`` inserted before the FIR at ``at`` on every
    rank (none when ``at`` is None); downstream is re-allocated at the new
    width. ``violate`` puts a
    ``SpectralGain(147, 49)`` downstream instead, whose grid the new width
    breaks: the handle must refuse and the stream run on unchanged."""
    import pipe_tpu_torch as pt
    from pipe_tpu_torch import mock, parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    sh = parallel.sharded
    data = stream_data(n_chunks, 23, block=block)
    gate = threading.Event()
    sink = mock.Sink()
    down = sh.SpectralGain(147, 49) if violate else sh.FIR(lowpass())
    p = pt.Pipe(block, feed_line(pt, Feed(data, None, {2 * block: gate}), C,
                                 [down.processor()], sink),
                mesh=m, host_sync_every=every)
    p.start()
    res = {"handle": None}
    if at is not None:
        hdl = p.insert_processor(0, 0, sh.Resample(48000, 44100).processor(),
                                 at_block=at)
        wait_for(lambda: p._executors[0].dest.pending_targets() == [at],
                 "the insert never delivered")
    gate.set()
    res = finish(p, res)
    if at is not None:
        hdl.wait(10)
        res["handle"] = (hdl.done(),
                         type(hdl.error).__name__ if hdl.error else None,
                         str(hdl.error))
    res["out"] = sink.values
    return res


# ---------------------------------------------------------------------------
# live surgery on mesh lines (tests/test_mesh_pipe.py)
# ---------------------------------------------------------------------------


def insert_at_boundary_job(rank, mesh, block, n_blocks, at):
    """A mock source of ones; a ``Gain(2)`` inserted at ``at`` on every
    rank."""
    import pipe_tpu_torch as pt
    from pipe_tpu_torch import mock, parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    gate = threading.Event()
    src = mock.Source(channels=2, value=1.0, limit=n_blocks * block)
    inner = src.source()

    def alloc(ctx, b):
        comp = inner(ctx, b)
        comp.host_pre = lambda: gate.wait(60)
        return comp

    sink = mock.Sink()
    p = pt.Pipe(block, pt.Line(source=alloc, sink=sink.sink()), mesh=m)
    p.start()
    hdl = p.insert_processor(0, 0, parallel.sharded.Gain(2.0).processor(),
                             at_block=at)
    wait_for(lambda: p._executors[0].dest.pending_targets() == [at],
             "the insert never delivered")
    gate.set()
    res = finish(p, {})
    res["out"] = sink.values
    res["handle"] = (hdl.wait(10), repr(hdl.error))
    return res


def add_line_job(rank, mesh, block, at, join=True, second_blocks=3, every=16):
    """A running line of ones (8 blocks) in a sync group; a second line
    (twos, ``second_blocks`` blocks) added at ``at`` on every rank, joining
    the group (``join``) or not. Also returns the health rounds and the
    group's final block index."""
    import pipe_tpu_torch as pt
    from pipe_tpu_torch import mock, parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    ctx = pt.mutable.mutable()
    gate = threading.Event()
    src1 = mock.Source(channels=2, value=1.0, limit=8 * block)
    inner = src1.source()

    def alloc(c, b):
        comp = inner(c, b)
        comp.host_pre = lambda: gate.wait(60)
        return comp

    sink1, sink2 = mock.Sink(), mock.Sink()
    p = pt.Pipe(block, pt.Line(source=alloc, sink=sink1.sink(), context=ctx),
                mesh=m, host_sync_every=every)
    m.reset_stats()
    p.start()
    src2 = mock.Source(channels=2, value=2.0, limit=second_blocks * block)
    kw = {"context": ctx} if join else {}
    hdl = p.add_line(pt.Line(source=src2.source(), sink=sink2.sink(), **kw),
                     at_block=at)
    if join:
        wait_for(lambda: p._executors[0].dest.pending_targets() == [at],
                 "the adoption never delivered")
    else:
        hdl.wait(30)
    gate.set()
    res = finish(p, {})
    res["out"] = [sink1.values, sink2.values]
    res["handle"] = (hdl.wait(10), type(hdl.error).__name__ if hdl.error else None,
                     str(hdl.error))
    res["health"] = health(m)
    return res


def soak_job(rank, mesh, lookahead, batch_blocks, block=256, chunky=False,
             n_blocks=256):
    """The randomized scenario of ``tests/test_soak.py`` on a mesh: seeded
    targeted retunes of two gains, a neutral ``Gain(1)`` inserted and a
    side line added (joining the group) at seeded blocks, five untargeted
    neutral pushes (agreed at a health round), an EOF partial tail, and a
    restart with initializers and ten more targeted retunes. Every rank
    draws the same schedule. Returns both runs' outputs and the schedules."""
    import pipe_tpu_torch as pt
    from pipe_tpu_torch import mock, parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    seed = (1000 + lookahead * 100 + batch_blocks + 7 + block
            + (13 if chunky else 0))
    r = np.random.default_rng(seed)
    tail = 73 if chunky else 0
    total = block * n_blocks + tail
    data = r.standard_normal((C, total)).astype(np.float32)
    ctx = pt.mutable.mutable()
    gate, queued = threading.Event(), threading.Event()
    feed = Feed(data, seed + 1 if chunky else None,
                {0: gate, (n_blocks // 2) * block: queued})
    sh = parallel.sharded
    g1, g2 = sh.Gain(1.0), sh.Gain(1.0)
    sink = mock.Sink()
    p = pt.Pipe(block, feed_line(pt, feed, C, [g1.processor(), g2.processor()],
                                 sink, ctx),
                mesh=m, lookahead=lookahead, batch_blocks=batch_blocks,
                host_sync_every=4)
    agg = p._agg
    grid = np.arange((8 // agg) + 1, n_blocks // agg) * agg
    p.start()

    def schedule(gain, k):
        blocks = np.sort(r.choice(grid, k, replace=False))
        vals = r.uniform(0.25, 2.0, blocks.size)
        for b, v in zip(blocks, vals):
            p.push(gain.set_gain(float(v)), at_block=int(b))
        return list(zip(blocks.tolist(), vals.tolist()))

    sched1, sched2 = schedule(g1, 20), schedule(g2, 20)
    g3 = sh.Gain(1.0)
    at_insert = int(r.integers(n_blocks // 8, n_blocks // 4)) // agg * agg
    h1 = p.insert_processor(0, int(r.integers(0, 3)), g3.processor(),
                            at_block=at_insert)
    side_total = 10 * block
    side_n = [0]

    def side_feed(n):
        if side_n[0] >= side_total:
            return None
        k = min(n, side_total - side_n[0])
        side_n[0] += k
        return np.full((C, k), 0.5, np.float32)

    side_sink = mock.Sink()
    at_add = int(r.integers(n_blocks // 4, n_blocks // 3)) // agg * agg
    h2 = p.add_line(feed_line(pt, side_feed, C, [], side_sink, ctx),
                    at_block=at_add)
    dest = p._executors[0].dest
    want = {b // agg for b, _ in sched1 + sched2} | {at_insert // agg,
                                                       at_add // agg}
    wait_for(lambda: set(dest.pending_targets()) == want,
             "targets never delivered")
    gate.set()
    for _ in range(5):  # untargeted but neutral: agreed at a health round
        p.push(g3.set_gain(1.0))
    queued.set()
    res = finish(p, {}, 120)
    res["out1"], res["side"] = sink.values, side_sink.values
    res["sched"] = (sched1, sched2)
    res["handles"] = [(h.wait(10), repr(h.error)) for h in (h1, h2)]
    res["agg"] = agg
    if res["error"] is not None:
        return res

    feed.pos, feed.holds = 0, {0: gate}
    if chunky:
        feed.r = np.random.default_rng(seed + 1)
    gate.clear()
    p.start(g1.set_gain(1.0), g2.set_gain(1.0), g3.set_gain(1.0))
    blocks = np.sort(r.choice(grid, 10, replace=False))
    vals = r.uniform(0.5, 1.5, blocks.size)
    for b, v in zip(blocks, vals):
        p.push(g1.set_gain(float(v)), at_block=int(b))
    wait_for(lambda: len(dest.pending_targets()) == 10, "targets never delivered")
    gate.set()
    res = finish(p, res, 120)
    res["out2"] = sink.values[:, total:]
    res["sched2"] = list(zip(blocks.tolist(), vals.tolist()))
    res["total"] = total
    return res


def latency_job(rank, mesh, block, n_blocks):
    """Feed -> sink lag in user blocks on an aggregated mesh pipe."""
    import pipe_tpu_torch as pt
    from pipe_tpu_torch import parallel

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    data = np.arange(n_blocks * block, dtype=np.float32).reshape(1, -1)
    fed, received, max_lag, pos, out = [0.0], [0.0], [0.0], [0], []

    def feed(n):
        if pos[0] >= data.shape[1]:
            return None
        c = data[:, pos[0]:pos[0] + n]
        pos[0] += n
        fed[0] += c.shape[1] / block
        return c

    def receive(arr):
        out.append(arr)
        received[0] += arr.shape[1] / block
        max_lag[0] = max(max_lag[0], fed[0] - received[0])

    p = pt.Pipe(block, pt.Line(
        source=lambda ctx, b: pt.Source(output=pt.SignalProperties(44100.0, 1),
                                        feed=feed),
        sink=lambda ctx, b, props: pt.Sink(receive=receive)),
        mesh=m, lookahead=1)
    p.start()
    res = finish(p, {})
    res.update(agg=p._agg, received=received[0], max_lag=max_lag[0],
               out=np.concatenate(out, axis=1))
    return res


# ---------------------------------------------------------------------------
# probes of the rounds
# ---------------------------------------------------------------------------


def health_round_job(rank, mesh, rows):
    """One ``health_allgather`` of this rank's row of ``rows``, and one
    ``HostSync.check`` of the same row: what came back, or the error."""
    import torch.distributed as dist

    from pipe_tpu_torch import parallel
    from pipe_tpu_torch.parallel.hostsync import HostSync, PeerAbortError

    m = parallel.make_mesh(*mesh)
    if not m.member:
        return None
    m.reset_stats()
    got = m.health_allgather(np.asarray(rows[rank], np.int32))
    sync = HostSync(m, every=4)
    try:
        res = ("ok", sync.check(flag=rows[rank][0], pending=rows[rank][1]))
    except PeerAbortError as e:
        res = ("PeerAbortError", str(e))
    return {"rows": got, "check": res, "next_round": sync.next_round,
            "stats": {k: list(v) for k, v in m.stats.items()},
            "backend": dist.get_backend(m._health)}

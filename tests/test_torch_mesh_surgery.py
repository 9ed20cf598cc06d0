"""Live surgery, soak, latency and fuzz on the port's mesh ``Pipe``: the
twins of the four surgery tests of ``tests/test_mesh_pipe.py``, of the four
mesh cases of ``tests/test_soak.py``, of the mesh case of
``tests/test_latency.py`` and of the three mesh fuzz tests of
``tests/test_fuzz.py``.

One process per shard: a mesh larger than 1x1 runs in a pool of 8 gloo
ranks (``tests/torch_mesh_worker.py``, every job with its own time limit;
the jobs are in ``tests/torch_hostsync_jobs.py``), and there every rank
passes the same ``at_block`` to its surgery, which is the JAX package's
multi-process rule. On a 1x1 mesh (this process) the surgery tests use the
form without ``at_block``, as the originals do. Every twin asserts that the
ranks' outputs are equal bit for bit, and holds the output to the
original's oracle and bar (>= 100 dB, 95 dB for the sharded delay).
"""

import time

import numpy as np
import pytest
import scipy.signal

import pipe_tpu_torch
from pipe_tpu_torch import mock, ops, parallel
from pipe_tpu_torch.ops.resample import polyphase_design
from pipe_tpu_torch.signal import snr_db
from tests.torch_mesh_worker import Pool

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")

JOB_LIMIT = 90.0  # seconds a job may take before the pool is killed
JOBS = "tests.torch_hostsync_jobs:"


@pytest.fixture(scope="module")
def pool():
    p = Pool(world=8)
    yield p
    p.close()


def ranks(pool, job, mesh, **kw):
    """The mesh's ranks' results (every rank's outputs equal bit for bit)."""
    res = pool.run(JOBS + job, timeout=JOB_LIMIT, mesh=mesh, **kw)
    members = [r for r in res if r is not None]
    assert len(members) == mesh[0] * mesh[1]
    for key in ("out", "out1", "out2"):
        for i, r in enumerate(members[1:], 1):
            if key in r:
                a, b = members[0][key], r[key]
                for x, y in (zip(a, b) if isinstance(a, list) else [(a, b)]):
                    np.testing.assert_array_equal(x, y, err_msg=f"rank {i}")
    return members


# -- twins of tests/test_mesh_pipe.py -----------------------------------------


def test_mesh_insert_processor_at_chunk_boundary_one_rank():
    """On a 1x1 mesh, without ``at_block``: the gain is adopted at a block
    boundary of a running stream, no sample lost."""
    C, BLOCK = 2, 1024
    src = mock.Source(channels=C, value=1.0, interval=0.002)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(BLOCK, pipe_tpu_torch.Line(
        source=src.source(), sink=sink.sink()), mesh=parallel.make_mesh(1, 1))
    p.start()
    while sink.messages < 3:
        time.sleep(0.01)
    handle = p.insert_processor(0, 0, parallel.sharded.Gain(2.0).processor())
    assert handle.wait(60) and handle.error is None
    seen = sink.messages
    while sink.messages < seen + 3:
        time.sleep(0.01)
    p.stop(60)
    v = sink.values[0]
    assert v[0] == 1.0 and v[-1] == 2.0
    assert set(np.unique(v)) == {1.0, 2.0}
    sw = np.where(np.diff(v) != 0)[0]
    assert len(sw) == 1 and (sw[0] + 1) % BLOCK == 0
    assert v.shape[0] % BLOCK == 0


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_mesh_insert_processor_at_chunk_boundary(pool, mesh):
    """Every rank inserts the gain at block 3: it switches at sample 3 *
    BLOCK exactly, on every rank, no sample lost."""
    BLOCK, N, AT = 1024, 8, 3
    for r in ranks(pool, "insert_at_boundary_job", mesh, block=BLOCK,
                   n_blocks=N, at=AT):
        assert r["error"] is None and r["handle"] == (True, "None")
        v = r["out"]
        assert v.shape == (2, N * BLOCK)
        np.testing.assert_array_equal(v[:, :AT * BLOCK], 1.0)
        np.testing.assert_array_equal(v[:, AT * BLOCK:], 2.0)


def test_mesh_add_line_live_one_rank():
    """On a 1x1 mesh, without ``at_block``: a second line streams while the
    first keeps running."""
    C, BLOCK = 2, 1024
    src1 = mock.Source(channels=C, value=1.0, interval=0.002)
    p = pipe_tpu_torch.Pipe(BLOCK, pipe_tpu_torch.Line(
        source=src1.source(), sink=mock.Sink(discard=True).sink()),
        mesh=parallel.make_mesh(1, 1))
    p.start()
    time.sleep(0.02)
    sink2 = mock.Sink()
    handle = p.add_line(pipe_tpu_torch.Line(
        source=mock.Source(limit=BLOCK * 3, channels=C, value=2.0).source(),
        sink=sink2.sink()))
    assert handle.wait(60) and handle.error is None
    while sink2.messages < 3:
        time.sleep(0.01)
    p.stop(60)
    assert sink2.values.shape == (C, BLOCK * 3)
    assert np.all(sink2.values == 2.0)


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2)])
def test_mesh_add_line_live(pool, mesh):
    """Every rank adds the same line at block 2, joining the running sync
    group: it streams its three blocks of twos while the first line runs
    on; a line that does not join the group is refused through its
    handle, and the stream runs on."""
    BLOCK = 1024
    for r in ranks(pool, "add_line_job", mesh, block=BLOCK, at=2):
        assert r["error"] is None and r["handle"][:2] == (True, None)
        first, second = r["out"]
        assert first.shape == (2, 8 * BLOCK) and np.all(first == 1.0)
        assert second.shape == (2, 3 * BLOCK) and np.all(second == 2.0)
    for r in ranks(pool, "add_line_job", mesh, block=BLOCK, at=2, join=False):
        assert r["error"] is None
        assert r["handle"][1] == "ValueError"
        assert "join the existing sync group" in r["handle"][2]
        assert r["out"][0].shape == (2, 8 * BLOCK) and r["out"][1].size == 0
    # an added line that outlives the first keeps counting in the group's
    # sweeps: with a round every sweep, one round for each of the 14
    # sweeps, then one after the no-op sweep that pads the end
    for r in ranks(pool, "add_line_job", mesh, block=BLOCK, at=2,
                   second_blocks=12, every=1):
        assert r["error"] is None and r["handle"][:2] == (True, None)
        first, second = r["out"]
        assert first.shape == (2, 8 * BLOCK) and np.all(first == 1.0)
        assert second.shape == (2, 12 * BLOCK) and np.all(second == 2.0)
        assert r["health"][0] == 15 and r["blocks"] == 15


def _width_insert_oracle(data, at, block, h):
    """Raw to the cut, polyphase-resampled after (fresh resampler state at
    adoption), one continuous FIR (the halo tail carries across the
    downstream re-allocation)."""
    cut = at * block
    L, M = 160, 147
    hp64 = polyphase_design(L, M, 32)
    K = hp64.shape[1]
    tail = data.astype(np.float64)[:, cut:]
    n_out = -(-tail.shape[1] * L // M)
    j = np.arange(n_out)
    p_, n0 = (j * M) % L, (j * M) // L
    nidx = n0[:, None] - np.arange(K)[None, :]
    valid = (nidx >= 0) & (nidx < tail.shape[1])
    xg = np.where(valid[None], tail[:, np.clip(nidx, 0, tail.shape[1] - 1)], 0.0)
    res = np.einsum("cok,ok->co", xg, hp64[p_])
    s = np.concatenate([data.astype(np.float64)[:, :cut], res], axis=1)
    return scipy.signal.lfilter(h, [1.0], s, axis=1)


def test_mesh_insert_width_changing_resampler_exact(pool):
    """A resampler inserted at block 4 of a 1x4 mesh line (block 588, a
    rank's 147 frames meet the resampler's phase rule): the FIR downstream
    is re-allocated at 640 frames with its tail carried, and the output
    holds 100 dB against the float64 oracle on every rank."""
    from tests.torch_hostsync_jobs import lowpass, stream_data

    BLOCK, N, AT = 588, 10, 4
    oracle = _width_insert_oracle(stream_data(N, 23, block=BLOCK), AT, BLOCK,
                                  lowpass())
    for r in ranks(pool, "width_insert_job", (1, 4), n_chunks=N, at=AT,
                   block=BLOCK, every=16):
        assert r["error"] is None and r["handle"][:2] == (True, None)
        assert r["out"].shape == oracle.shape
        assert snr_db(oracle, r["out"]) > 100


def test_mesh_insert_width_changer_violating_shape_rule_refused(pool):
    """A resampler inserted ahead of a ``SpectralGain(147, 49)`` whose grid
    the new 640-frame width breaks: the handle refuses with a
    ``ValueError`` that names the shape rule on every rank, and the stream
    runs on unchanged, equal to the run without the insert bit for bit."""
    kw = dict(n_chunks=8, block=588, violate=True, every=16)
    plain = ranks(pool, "width_insert_job", (1, 4), at=None, **kw)[0]["out"]
    for r in ranks(pool, "width_insert_job", (1, 4), at=2, **kw):
        assert r["error"] is None
        assert r["handle"][1] == "ValueError" and "shape rule" in r["handle"][2]
        np.testing.assert_array_equal(r["out"], plain)


# -- twins of the mesh cases of tests/test_soak.py --------------------------------


def _step_gains(schedule, n_samples, block):
    g = np.ones(n_samples, np.float64)
    for b, v in schedule:
        g[b * block:] = np.float64(np.float32(v))
    return g


@pytest.mark.parametrize("lookahead, batch_blocks, block, chunky", [
    (1, 1, 256, False), (8, 4, 256, False), (1, 1, 257, False),
    (1, 4, 256, True), (1, 1, 257, True),
], ids=["on_mesh-1-1", "on_mesh-8-4", "on_aggregated_mesh",
        "on_mesh_chunky_short_reads", "on_aggregated_mesh_chunky"])
def test_soak_randomized_on_mesh(pool, lookahead, batch_blocks, block, chunky):
    """``test_soak_randomized_on_mesh`` (both knob pairs),
    ``..._on_aggregated_mesh``, ``..._on_mesh_chunky_short_reads`` and
    ``..._on_aggregated_mesh_chunky`` on a 2x4 mesh of ranks: the seeded
    retunes land exactly (>= 100 dB against the float64 oracle), the
    neutral surgery and the side line change nothing, the five untargeted
    pushes are agreed at a health round, and the restart streams again.
    What shrank: 256 blocks instead of 1024 (rounds every 4 dispatches, so
    a run still crosses more than 3 of them); surgery targeted at seeded
    blocks on every rank instead of issued mid-flight; the side line joins
    the main line's sync group (a rank may run one executor only)."""
    res = ranks(pool, "soak_job", (2, 4), lookahead=lookahead,
                batch_blocks=batch_blocks, block=block, chunky=chunky)
    for r in res:
        assert r["error"] is None, r["error"]
        assert all(h == (True, "None") for h in r["handles"]), r["handles"]
        total = r["total"]
        data = np.random.default_rng(
            1000 + lookahead * 100 + batch_blocks + 7 + block
            + (13 if chunky else 0)).standard_normal((2, total)).astype(np.float32)
        s1, s2 = r["sched"]
        assert r["out1"].shape == (2, total)
        oracle = (data.astype(np.float64) * _step_gains(s1, total, block)
                  * _step_gains(s2, total, block))
        assert snr_db(oracle, r["out1"]) > 100
        assert r["side"].shape == (2, 10 * block) and np.all(r["side"] == 0.5)
        assert r["out2"].shape == (2, total)
        oracle2 = data.astype(np.float64) * _step_gains(r["sched2"], total, block)
        assert snr_db(oracle2, r["out2"]) > 100
    assert res[0]["agg"] == (4 if block == 257 else 1)


# -- twin of tests/test_latency.py ---------------------------------------------


def test_latency_budget_mesh_units(pool):
    """On an aggregated mesh pipe (block 101 on a 4-way time axis, a = 4)
    the latency unit is ``a`` user blocks: the feed -> sink lag stays
    within (lookahead + 1) * 4 user blocks, and nothing is lost."""
    NB = 80
    for r in ranks(pool, "latency_job", (1, 4), block=101, n_blocks=NB):
        assert r["error"] is None and r["agg"] == 4
        assert r["received"] == NB
        np.testing.assert_array_equal(
            r["out"], np.arange(NB * 101, dtype=np.float32)[None])
        assert r["max_lag"] <= (1 + 1) * 4, r["max_lag"]


# -- twins of the mesh fuzz tests of tests/test_fuzz.py ------------------------


def test_fuzz_distributed_fdl_random_configs(pool, rng):
    """Random (IR length, mesh, chunk, channels, shared or per-channel)
    sweeps of the bin-sharded OLS stage against fftconvolve, >= 100 dB."""
    for case in range(6):
        ch, t = [(1, 2), (1, 4), (2, 4), (1, 8)][int(rng.integers(0, 4))]
        n_local = int(rng.integers(96, 600))
        chunk = n_local * t
        C = ch * int(rng.integers(1, 3))
        P = int(rng.integers(n_local + 1, n_local * 12))
        per_channel = bool(rng.integers(0, 2))
        ir = rng.standard_normal((C, P) if per_channel else (P,)) * np.exp(
            -np.arange(P) / (P / 4.0))
        x = rng.standard_normal((C, chunk * int(rng.integers(1, 4)))).astype(
            np.float32)
        res = pool.run("chain_job", timeout=JOB_LIMIT, mesh=(ch, t),
                       stages=[("OLSStage", (ir,), {})], channels=C,
                       chunk_frames=chunk, x=x)
        out = res[0]["out"]
        if per_channel:
            oracle = np.stack([scipy.signal.fftconvolve(
                x[c].astype(np.float64), ir[c])[: x.shape[1]] for c in range(C)])
        else:
            oracle = scipy.signal.fftconvolve(
                x.astype(np.float64), ir[None, :], axes=1)[:, : x.shape[1]]
        sn = snr_db(oracle, out)
        assert sn > 100, (f"case {case}: mesh {ch}x{t} n_local={n_local} "
                          f"P={P} per_channel={per_channel}: {sn:.1f} dB")


def test_fuzz_sharded_delay_random_configs(pool, rng):
    """Random delay/feedback sweeps of the sharded ``DelayStage`` (short,
    non-dividing and longer-than-chunk delays) against the recurrence."""
    for case in range(6):
        t = [2, 4, 8][int(rng.integers(0, 3))]
        n_local = int(rng.integers(128, 700))
        chunk = n_local * t
        C = int(rng.integers(1, 3))
        D = int(rng.integers(1, int(2.5 * n_local)))
        fb = float(rng.uniform(-0.5, 0.5)) if rng.integers(0, 2) else 0.0
        wet, dry = float(rng.uniform(0.2, 1.0)), float(rng.uniform(0.0, 1.0))
        x = rng.standard_normal((C, chunk * int(rng.integers(1, 4)))).astype(
            np.float32)
        res = pool.run("chain_job", timeout=JOB_LIMIT, mesh=(1, t),
                       stages=[("DelayStage", (D,), {"feedback": fb, "wet": wet,
                                                     "dry": dry})],
                       channels=C, chunk_frames=chunk, x=x)
        x64 = x.astype(np.float64)
        N = x64.shape[1]
        s = np.zeros((C, N + D))
        for n in range(N):
            s[:, n + D] = x64[:, n] + fb * s[:, n]
        oracle = dry * x64 + wet * s[:, :N]
        sn = snr_db(oracle, res[0]["out"])
        assert sn > 95, (f"case {case}: T={t} n_local={n_local} D={D} "
                         f"fb={fb:.2f}: {sn:.1f} dB")


def test_fuzz_weird_shape_mesh_lines(pool, rng):
    """Random (channels, block, mesh) combinations through ``Pipe(mesh=)``
    with health rounds on: channels that do not divide ride pad rows,
    blocks that do not divide aggregate, fusion on or off, and the output
    holds 100 dB against the float64 oracle (FIR, then the gain, then the
    delay's wet/dry mix), where the original holds it against JAX's
    streaming engine."""
    for case in range(5):
        ch_s, t_s = [(1, 4), (2, 4), (4, 2), (2, 2)][int(rng.integers(0, 4))]
        C = int(rng.integers(1, 7))
        block = int(rng.integers(200, 900))
        n_blocks = int(rng.integers(6, 12))
        D = int(rng.integers(1, 2000))
        T = int(rng.integers(5, 40)) | 1
        x = rng.standard_normal((C, block * n_blocks)).astype(np.float32)
        h = np.asarray(ops.design_lowpass(T, 5000.0, 44100.0))
        fuse = bool(rng.integers(0, 2))
        res = [r for r in pool.run(
            "pipe_job", timeout=JOB_LIMIT, mesh=(ch_s, t_s), block=block,
            lines=[{"source": ("feed", x, 44100.0), "ops": [
                ("FIR", (h,), {}), ("Gain", (0.7,), {}),
                ("Delay", (D,), {"wet": 0.5, "dry": 1.0})]}],
            knobs={"optimize": fuse, "host_sync_every": 2}) if r is not None]
        out = res[0]["out"][0]
        for r in res:
            assert r["error"] is None
            np.testing.assert_array_equal(r["out"][0], out)
        s = 0.7 * scipy.signal.lfilter(h, [1.0], x.astype(np.float64), axis=1)
        oracle = s + 0.5 * np.pad(s, ((0, 0), (D, 0)))[:, : s.shape[1]]
        assert out.shape == oracle.shape, (case, out.shape, oracle.shape)
        sn = snr_db(oracle, out)
        assert sn > 100, (f"case {case}: mesh {ch_s}x{t_s} C={C} "
                          f"block={block} D={D} T={T} agg={res[0]['agg']}: "
                          f"{sn:.1f} dB")

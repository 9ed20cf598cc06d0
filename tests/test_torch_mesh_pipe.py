"""The mesh ``Pipe`` of ``pipe_tpu_torch`` on real ranks: the twins of the
tests of ``tests/test_mesh_pipe.py`` that need no live surgery, on the
meshes of the originals, in a pool of 8 gloo ranks
(``tests/torch_mesh_worker.py``; one pool for this file, every job with its
own time limit). The JAX mesh pipe runs in the test process on its 8
virtual devices from the same description of the line.

Every twin asserts on EVERY rank: the sink holds the whole output, equal
across ranks bit for bit, within the original's bar (>= 100 dB, or ``atol``
2e-5) of the JAX mesh pipe's output and of the original's float64 oracle.
Where the original asserts "no recompile", the twin asserts the landing
sample ``at_block * out_width`` instead. Also here: what a mesh pipe refuses
on purpose, a late target, checkpoints across meshes and packages, and a
rank that fails alone. The twins of the surgery tests are in
``tests/test_torch_mesh_surgery.py``.
"""

import time

import numpy as np
import pytest
import scipy.signal

import pipe_tpu
import pipe_tpu.parallel  # noqa: F401
import pipe_tpu_torch
from pipe_tpu_torch import ops
from pipe_tpu_torch.ops.resample import polyphase_design
from pipe_tpu_torch.signal import snr_db
from tests.test_ops import _resample_oracle
from tests.test_torch_ops import stream
from tests.torch_mesh_worker import JobError, Pool, drive_pipe

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")

JOB_LIMIT = 90.0  # seconds a job may take before the pool is killed


@pytest.fixture(scope="module")
def pool():
    p = Pool(world=8)
    yield p
    p.close()


def op(name, *args, **kwargs):
    return (name, args, kwargs)


def feed_line(data, *line_ops, kind="feed", extra=(), sr=44100.0):
    src = (kind, data, sr) if kind == "feed" else (kind, data, *extra)
    return {"source": src, "ops": list(line_ops)}


def mock_line(*line_ops, **mock_kwargs):
    return {"source": ("mock", mock_kwargs), "ops": list(line_ops)}


def port(pool, mesh, block, lines, expect_error=False, **kw):
    """The mesh's ranks' results: no rank failed (unless asked), and every
    rank's sinks hold the same bits."""
    res = pool.run("pipe_job", timeout=JOB_LIMIT, mesh=mesh, block=block,
                   lines=lines, **kw)
    ranks = [r for r in res if r is not None]
    assert len(ranks) == mesh[0] * mesh[1]
    assert all(r is None for r in res[len(ranks):])
    if not expect_error:
        for i, r in enumerate(ranks):
            assert r["error"] is None, (i, r["error"])
    for i, r in enumerate(ranks[1:], 1):
        for a, b in zip(ranks[0]["out"], r["out"]):
            assert a.shape == b.shape, (i, a.shape, b.shape)
            np.testing.assert_array_equal(a, b, err_msg=f"rank {i}")
    return ranks


def jax_pipe(mesh, block, lines, **kw):
    return drive_pipe(pipe_tpu, pipe_tpu.parallel.make_mesh, mesh, block,
                      lines, **kw)


def both(pool, mesh, block, lines, db=100.0, **kw):
    """The port's ranks and the JAX mesh pipe on the same lines: equal
    shapes and >= ``db`` apart; returns (port output, JAX output, ranks)."""
    ranks = port(pool, mesh, block, lines, **kw)
    ref = jax_pipe(mesh, block, lines, **kw)
    assert ref["error"] is None
    assert ranks[0]["agg"] == ref["agg"]
    for y, yj in zip(ranks[0]["out"], ref["out"]):
        assert y.shape == yj.shape, (y.shape, yj.shape)
        if yj.size and np.any(yj):
            assert snr_db(yj, y) >= db, f"{snr_db(yj, y):.1f} dB from JAX"
    return ranks[0]["out"][0], ref["out"][0], ranks


def assert_same_snapshot(ck, ref):
    """The port's snapshot holds the JAX mesh pipe's leaves: the same keys,
    shapes and integer-ness, integer leaves equal, float leaves within
    ``atol`` 2e-5 of the leaf's scale."""
    assert sorted(ref) == sorted(ck)
    for k in ck:
        assert ref[k].shape == ck[k].shape, k
        if np.issubdtype(ref[k].dtype, np.integer):
            assert np.issubdtype(ck[k].dtype, np.integer), k
            np.testing.assert_array_equal(ck[k], ref[k], err_msg=k)
        else:
            scale = max(1.0, float(np.abs(ref[k]).max(initial=0.0)))
            np.testing.assert_allclose(ck[k], ref[k], atol=2e-5 * scale,
                                       err_msg=k)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


# -- twins of tests/test_mesh_pipe.py -------------------------------------------


def test_config5_chain_on_mesh(pool, rng):
    C, BLOCK = 8, 2352
    data = rng.standard_normal((C, BLOCK * 4)).astype(np.float32)
    h = np.asarray(ops.design_lowpass(255, 4000, 44100))
    mixm = (np.ones((2, C)) / C).astype(np.float32)
    y, yj, _ = both(pool, (2, 4), BLOCK, [feed_line(
        data, op("FIR", h), op("Resample", 48000, 44100), op("Mix", mixm))])
    fx = scipy.signal.lfilter(h, [1.0], data.astype(np.float64), axis=1)
    rx = _resample_oracle(fx, polyphase_design(160, 147, 32), 160, 147)
    oracle = mixm.astype(np.float64) @ rx
    assert y.shape == oracle.shape
    assert snr_db(oracle, y) > 100


def test_mesh_matches_single_device_stream(pool, rng):
    C, BLOCK = 4, 2048
    data = rng.standard_normal((C, BLOCK * 3)).astype(np.float32)
    h = np.asarray(ops.design_lowpass(127, 3000, 44100))
    streamed = stream(pipe_tpu_torch, [ops.FIR(h).processor()], data, 512)
    y, _, _ = both(pool, (2, 4), BLOCK, [feed_line(data, op("FIR", h))])
    assert y.shape == streamed.shape
    np.testing.assert_allclose(y, streamed, atol=2e-5)


def test_mesh_mutation_push_no_recompile(pool):
    """A ``set_taps`` pushed at block 4 lands on sample ``4 * BLOCK``
    exactly, on every rank (nothing compiles in the port: the landing
    sample takes the place of the original's compile count)."""
    C, BLOCK, AT = 2, 2048, 4
    h1 = np.asarray(ops.design_lowpass(63, 4000, 44100))
    h2 = np.asarray(ops.design_lowpass(63, 1000, 44100))
    line = mock_line(op("FIR", h1), channels=C, value=1.0, limit=8 * BLOCK)
    push = [(0, 0, "set_taps", (h2,), {}, AT)]
    y, yj, ranks = both(pool, (1, 4), BLOCK, [line], pushes=push)
    plain = port(pool, (1, 4), BLOCK, [line])[0]["out"][0]
    assert y.shape == plain.shape == (C, 8 * BLOCK)
    changed = np.flatnonzero(np.any(y != plain, axis=0))
    assert changed[0] == AT * BLOCK
    g1, g2 = float(np.sum(h1)), float(np.sum(h2))
    assert np.allclose(y[:, BLOCK:AT * BLOCK], g1, atol=1e-3)
    assert np.allclose(y[:, AT * BLOCK + 64:], g2, atol=1e-3)
    np.testing.assert_allclose(y, yj, atol=2e-5)


def test_mesh_partial_final_chunk(pool, rng):
    C, BLOCK = 2, 2048
    N = BLOCK * 2 + 777
    data = rng.standard_normal((C, N)).astype(np.float32)
    h = np.asarray(ops.design_lowpass(63, 4000, 44100))
    y, _, _ = both(pool, (1, 4), BLOCK, [feed_line(data, op("FIR", h))])
    assert y.shape == (C, N)
    oracle = scipy.signal.lfilter(h, [1.0], data.astype(np.float64), axis=1)
    assert snr_db(oracle, y) > 100


def test_mesh_device_source_counts(pool):
    C, BLOCK, n_blocks = 4, 1024, 7
    y, _, ranks = both(pool, (2, 4), BLOCK, [mock_line(
        limit=n_blocks * BLOCK, channels=C, value=0.25)])
    for r in ranks:
        assert r["src"][0] == (n_blocks, n_blocks * BLOCK)
    assert y.shape == (C, n_blocks * BLOCK)
    assert np.all(y == 0.25)


def test_mesh_device_source_channel_padding(pool):
    C, BLOCK, n_blocks = 3, 1024, 5  # 3 channels on a 2-way axis: pad to 4
    h = np.asarray(ops.design_lowpass(63, 4000, 44100))
    y, _, ranks = both(pool, (2, 4), BLOCK, [mock_line(
        op("FIR", h), limit=n_blocks * BLOCK, channels=C, value=0.5)])
    assert all(r["src"][0][0] == n_blocks for r in ranks)
    assert y.shape == (C, n_blocks * BLOCK)
    oracle = scipy.signal.lfilter(
        h, [1.0], np.full((C, n_blocks * BLOCK), 0.5, np.float64), axis=1)
    assert snr_db(oracle, y) > 100


def test_mesh_device_source_partial_final(pool):
    C, BLOCK = 2, 1024
    limit = 3 * BLOCK + 500
    y, _, _ = both(pool, (1, 4), BLOCK, [mock_line(
        limit=limit, channels=C, value=1.0)])
    assert y.shape == (C, limit)
    assert np.all(y == 1.0)
    # the frames past the limit are zeroed before the stages see them: a
    # filter's tail after the partial block holds zeros, as in JAX
    h = np.asarray(ops.design_lowpass(63, 4000, 44100))
    line = mock_line(op("FIR", h), limit=limit, channels=C, value=1.0)
    ranks = port(pool, (1, 4), BLOCK, [line], snapshot=True)
    ref = jax_pipe((1, 4), BLOCK, [line], snapshot=True)
    for r in ranks:
        assert_same_snapshot(r["ckpt"], ref["ckpt"])
    tails = [v for v in ranks[0]["ckpt"].values() if v.shape == (C, 62)]
    assert len(tails) == 1 and not tails[0].any()


@pytest.mark.parametrize("freq, q, kw", [(1000, 1.0, {}),
                                         (60.0, 0.7, {"precision": "extended"})],
                         ids=["biquad_and_compressor_chain",
                              "biquad_extended_precision_pipe"])
def test_mesh_biquad(pool, rng, freq, q, kw):
    """``test_mesh_biquad_and_compressor_chain`` and
    ``test_mesh_biquad_extended_precision_pipe``: the recurrence crosses
    rank and chunk boundaries and holds 100 dB against ``sosfilt``."""
    C, BLOCK = 2, 4096
    data = (rng.standard_normal((C, BLOCK * 3)) * 0.5).astype(np.float32)
    sos = ops.design_peaking_eq(44100, freq=freq, q=q, gain_db=6.0)
    # two float32 realisations of a 60 Hz section agree to their own noise
    # floor only; each is held to the float64 oracle
    y, yj, _ = both(pool, (1, 4), BLOCK,
                    [feed_line(data, op("Biquad", sos, **kw))],
                    db=100.0 if not kw else 95.0)
    oracle = scipy.signal.sosfilt(sos[None, :], data.astype(np.float64), axis=1)
    snr = snr_db(oracle, y)
    assert snr > 100, f"{snr:.1f} dB"


def test_mesh_any_block_size_aggregates(pool, rng):
    """Block 1001 on a 4-way time axis aggregates 4 user blocks per
    dispatch, sample-exact; an off-grid ``at_block`` raises the grid error
    on every rank and the stream runs on unchanged."""
    C, BLOCK = 2, 1001
    data = rng.standard_normal((C, BLOCK * 8)).astype(np.float32)
    line = feed_line(data, op("Gain", 0.5))
    y, _, ranks = both(pool, (1, 4), BLOCK, [line])
    assert all(r["agg"] == 4 for r in ranks)
    assert y.shape == (C, BLOCK * 8)
    assert snr_db(0.5 * data.astype(np.float64), y) > 130
    off = port(pool, (1, 4), BLOCK, [line], expect_error=True,
               pushes=[(0, 0, "set_gain", (0.25,), {}, 5)])
    for r in off:
        assert r["error"][0] == "ValueError" and "dispatch grid" in r["error"][1]
        np.testing.assert_array_equal(r["out"][0], y)
    on = port(pool, (1, 4), BLOCK, [line],
              pushes=[(0, 0, "set_gain", (0.25,), {}, 4)])[0]["out"][0]
    np.testing.assert_array_equal(on[:, :4 * BLOCK], y[:, :4 * BLOCK])
    np.testing.assert_array_equal(on[:, 4 * BLOCK:], 0.25 * data[:, 4 * BLOCK:])


def test_mesh_weird_shape_matrix(pool, rng):
    """6 channels, block 1000, 2x4 mesh, 44.1k -> 48k: a = 147, and the
    output matches the streaming engine >= 100 dB."""
    C, BLOCK = 6, 1000
    N = 147000 + 4 * 1000  # one aggregated dispatch + a partial tail
    data = rng.standard_normal((C, N)).astype(np.float32)
    h = ops.design_lowpass(63, 4000.0, 44100.0)
    y, _, ranks = both(pool, (2, 4), BLOCK, [feed_line(
        data, op("FIR", np.asarray(h)), op("Resample", 48000, 44100))])
    assert all(r["agg"] == 147 for r in ranks)
    streamed = stream(pipe_tpu_torch, [
        ops.FIR(h).processor(), ops.Resampler(48000, 44100).processor()],
        data, 1000)
    n = min(y.shape[1], streamed.shape[1])
    assert n >= N * 160 // 147 - 160
    snr = snr_db(streamed[:, :n].astype(np.float64), y[:, :n])
    assert snr > 100, f"{snr:.1f} dB"


def _taps2d(C, T, step=500.0):
    return np.stack([np.asarray(ops.design_lowpass(T, 2000.0 + step * c, 44100.0))
                     for c in range(C)]).astype(np.float32)


def test_mesh_channel_padding_line(pool, rng):
    C, BLOCK = 6, 2048  # 6 channels on a 4-way channel axis: pad to 8
    data = rng.standard_normal((C, BLOCK * 4)).astype(np.float32)
    taps2d = _taps2d(C, 63)
    y, _, _ = both(pool, (4, 2), BLOCK, [feed_line(data, op("FIR", taps2d))])
    assert y.shape == (C, BLOCK * 4)
    oracle = np.stack([
        scipy.signal.lfilter(taps2d[c].astype(np.float64), [1.0],
                             data[c].astype(np.float64)) for c in range(C)])
    snr = snr_db(oracle, y)
    assert snr > 100, f"{snr:.1f} dB"


def test_mesh_spectral_weird_block_aggregates(pool, rng):
    C, BLOCK, W, HOP = 2, 1000, 1024, 256
    N = 128000 + 3000  # one aggregated dispatch + a partial tail
    x = rng.standard_normal((C, N)).astype(np.float32)
    y, _, ranks = both(pool, (1, 2), BLOCK,
                       [feed_line(x, op("SpectralGain", W, HOP))])
    assert all(r["agg"] == 64 for r in ranks)
    streamed = stream(pipe_tpu_torch, [ops.SpectralGain(W, HOP).processor()],
                      x, W)
    n = min(y.shape[1], streamed.shape[1]) - 2 * W  # exclude the EOF edge
    sn = snr_db(streamed[:, :n].astype(np.float64), y[:, :n])
    assert sn > 100, f"{sn:.1f} dB"


def test_mesh_channel_padding_live_retune(pool, rng):
    """A per-channel retune on a channel-padded line pads its value to the
    built channel count and every rank keeps its rows."""
    C, BLOCK = 6, 1024
    taps = np.stack([np.asarray(ops.design_lowpass(31, 3000.0, 44100.0))] * C
                    ).astype(np.float32)
    data = rng.standard_normal((C, BLOCK * 12)).astype(np.float32)
    line = feed_line(data, op("FIR", taps), op("Gain", np.ones(C, np.float32)))
    pushes = [(0, 0, "set_taps", ((taps * 0.5).astype(np.float32),), {}, 2),
              (0, 1, "set_gain", (2.0 * np.ones(C, np.float32),), {}, 2)]
    y, _, _ = both(pool, (4, 2), BLOCK, [line], pushes=pushes)
    assert y.shape == data.shape
    # the combined retune is gain-neutral (0.5 * 2) up to the FIR tail
    oracle = scipy.signal.lfilter(
        taps[0].astype(np.float64), [1.0], data.astype(np.float64), axis=1)
    assert snr_db(oracle[:, -BLOCK:], y[:, -BLOCK:]) > 80
    assert snr_db(oracle, y) > 100


def test_mesh_channel_changing_stage_rejected_on_padded_line(pool):
    data = np.zeros((6, 2048), np.float32)
    with pytest.raises(JobError, match="channel count") as e:
        pool.run("pipe_job", timeout=JOB_LIMIT, mesh=(4, 2), block=1024,
                 lines=[feed_line(data, op("Channelizer", 4))])
    assert sorted(e.value.errors) == list(range(8))  # every rank alike
    with pytest.raises(Exception, match="channel count"):
        jax_pipe((4, 2), 1024, [feed_line(data, op("Channelizer", 4))])


def test_mesh_stateful_component_needs_spec(pool):
    """The streaming (local-state) FIR is refused on a time-sharded mesh."""
    h = np.asarray(ops.design_lowpass(63, 4000, 44100))
    ranks = port(pool, (1, 4), 2048, [mock_line(
        op("ops.FIR", h), channels=2, value=1.0, limit=4096)],
        expect_error=True)
    for r in ranks:
        assert r["error"][0] == "StartError" and "state_spec" in r["error"][1]
        assert r["out"][0].size == 0


def test_mesh_echo_limiter_chain_with_pushes(pool, rng):
    C, BLOCK = 2, 4096
    data = (rng.standard_normal((C, BLOCK * 3)) * 0.5).astype(np.float32)
    line = feed_line(
        data, op("Delay", 256, feedback=0.5, wet=0.5, dry=1.0),
        op("Gate", threshold_db=-60.0), op("Limiter", threshold_db=-6.0))
    pushes = [(0, 0, "set_feedback", (0.3,), {}, 2),
              (0, 2, "set", (), {"threshold_db": -3.0}, 2)]
    y, _, _ = both(pool, (1, 4), BLOCK, [line], pushes=pushes)
    assert y.shape == data.shape
    assert np.isfinite(y).all()
    assert np.abs(y[:, BLOCK:]).max() < 1.5  # the limiter bounds the tail


def test_mesh_channelizer_via_pipe(pool, rng):
    K, C, BLOCK = 8, 2, 4096
    data = rng.standard_normal((C, BLOCK * 2)).astype(np.float32)
    streamed = stream(pipe_tpu_torch,
                      [ops.Channelizer(K, taps_per_branch=8).processor()],
                      data, 512, sr=48000.0)
    y, _, _ = both(pool, (1, 4), BLOCK, [feed_line(
        data, op("Channelizer", K, taps_per_branch=8), sr=48000.0)])
    assert y.shape == streamed.shape
    np.testing.assert_allclose(y, streamed, atol=2e-5)


def _ckpt_lines(name, rng):
    if name == "roundtrip":
        sos = ops.design_peaking_eq(44100, freq=600, q=1.5, gain_db=3.0)
        h = np.asarray(ops.design_lowpass(127, 3000, 44100))
        return (2, 4), 4, 2048, [op("FIR", h), op("Biquad", sos)], 1.0
    if name == "r3_carries":
        P_ir = 6000  # > n_local = 1024: the bin-sharded delay line
        ir = rng.standard_normal(P_ir) * np.exp(-np.arange(P_ir) / 1200.0)
        return (1, 4), 2, 4096, [
            op("OLS", ir),
            op("Compressor", threshold_db=-12.0, ratio=3.0, attack_ms=5.0,
               release_ms=80.0),
            op("Delay", 300, feedback=0.4, wet=0.3, dry=1.0)], 0.5
    return (1, 4), 2, 4096, [
        op("Delay", 9000, wet=1.0, dry=0.5),  # D > 2 * chunk
        op("Delay", 5000, feedback=0.5, wet=0.4, dry=1.0),  # ring, D >= chunk
        op("Delay", 2500, feedback=0.4, wet=0.3, dry=1.0)], 0.5  # wave-DAG


@pytest.mark.parametrize("name", ["roundtrip", "r3_carries", "r4_ring_carries"])
def test_mesh_pipe_checkpoint(pool, rng, name):
    """``test_mesh_pipe_checkpoint_roundtrip``, ``..._r3_carries`` and
    ``..._r4_ring_carries``: snapshot after the first half, restore into a
    fresh mesh pipe, and the resumed stream equals the unbroken one; every
    rank's snapshot holds the same global arrays, which are the JAX
    pipe's."""
    mesh, C, BLOCK, line_ops, scale = _ckpt_lines(name, rng)
    data = (rng.standard_normal((C, BLOCK * 4)) * scale).astype(np.float32)
    full = port(pool, mesh, BLOCK, [feed_line(data, *line_ops)])[0]["out"][0]
    first = port(pool, mesh, BLOCK, [feed_line(data[:, :2 * BLOCK], *line_ops)],
                 snapshot=True)
    ck = first[0]["ckpt"]
    for r in first[1:]:
        assert sorted(r["ckpt"]) == sorted(ck)
        for k in ck:
            np.testing.assert_array_equal(r["ckpt"][k], ck[k], err_msg=k)
    second = port(pool, mesh, BLOCK, [feed_line(data[:, 2 * BLOCK:], *line_ops)],
                  restore=ck)
    resumed = np.concatenate([first[0]["out"][0], second[0]["out"][0]], axis=1)
    assert resumed.shape == full.shape
    np.testing.assert_allclose(resumed, full, atol=2e-5)
    ref = jax_pipe(mesh, BLOCK, [feed_line(data[:, :2 * BLOCK], *line_ops)],
                   snapshot=True)["ckpt"]
    assert_same_snapshot(ck, ref)


def test_mesh_stats_recorder(pool, rng):
    C, BLOCK = 4, 2048
    data = rng.standard_normal((C, BLOCK * 3)).astype(np.float32)
    h = np.asarray(ops.design_lowpass(63, 3000, 44100))
    ranks = port(pool, (2, 4), BLOCK, [feed_line(data, op("FIR", h))],
                 stats=True)
    for r in ranks:
        blocks, frames, wall_s = r["stats"]
        # 3 data blocks + the dispatch that finds the end of the stream
        assert blocks == 4
        assert frames == blocks * BLOCK
        assert wall_s > 0


def test_mesh_optimize_fuse_sharded_pair(pool, rng):
    """``optimize.fuse`` collapses sharded FIR + Resample into the fused
    sharded stage; the output matches the unfused chain."""
    C, BLOCK = 4, 147 * 16
    data = rng.standard_normal((C, BLOCK * 2)).astype(np.float32)
    h = np.asarray(ops.design_lowpass(63, 3000, 44100))
    line = feed_line(data, op("FIR", h),
                     op("Resample", 48000, 44100, taps_per_phase=16))
    plain, _, ranks = both(pool, (2, 4), BLOCK, [line])
    fused, _, franks = both(pool, (2, 4), BLOCK, [line], fuse=True)
    assert ranks[0]["n_procs"] == [2] and franks[0]["n_procs"] == [1]
    assert fused.shape == plain.shape
    np.testing.assert_allclose(fused, plain, atol=3e-5)


@pytest.mark.parametrize("case", ["biquad_cascade_and_gain_fir", "mix_gain",
                                  "fir_run_and_gain_ols"])
def test_fuse_sharded_on_ranks(pool, rng, case):
    """The sharded fusion tests of ``tests/test_optimize.py`` on their
    meshes, through ``Pipe(..., optimize=True)``: fewer stages, and the
    output within 100 dB of the float64 oracle on every rank."""
    h = np.asarray(ops.design_lowpass(63, 4000.0, 44100.0))
    if case == "biquad_cascade_and_gain_fir":
        mesh, C, BLOCK, n = (1, 4), 2, 4096, 3
        r1 = ops.design_peaking_eq(44100, freq=800, q=1.0, gain_db=4.0)
        r2 = ops.design_peaking_eq(44100, freq=3000, q=1.5, gain_db=-3.0)
        x = rng.standard_normal((C, BLOCK * n)).astype(np.float32)
        line_ops = [op("Gain", 0.5), op("FIR", h), op("Biquad", r1),
                    op("Biquad", r2)]
        o = scipy.signal.lfilter(h, [1.0], 0.5 * x.astype(np.float64), axis=1)
        oracle, n_fused = scipy.signal.sosfilt(np.vstack([r1, r2]), o, axis=1), 2
    elif case == "mix_gain":
        mesh, C, BLOCK, n = (2, 2), 4, 2048, 2
        x = rng.standard_normal((C, BLOCK * n)).astype(np.float32)
        m = rng.standard_normal((2, C)).astype(np.float32)
        line_ops = [op("Gain", 0.5), op("Mix", m)]
        oracle, n_fused = 0.5 * m.astype(np.float64) @ x.astype(np.float64), 1
    else:
        mesh, C, BLOCK, n = (1, 4), 2, 2048, 4
        h2 = np.asarray(ops.design_lowpass(31, 4000.0, 44100.0))
        x = rng.standard_normal((C, BLOCK * n)).astype(np.float32)
        ir = rng.standard_normal(1500) * np.exp(-np.arange(1500) / 250.0)
        line_ops = [op("FIR", h), op("FIR", h2), op("Gain", 0.5), op("OLS", ir)]
        o = x.astype(np.float64)
        for t in (h, h2):
            o = scipy.signal.lfilter(t, [1.0], o, axis=1)
        oracle, n_fused = scipy.signal.lfilter(ir, [1.0], 0.5 * o, axis=1), 2
    y, _, ranks = both(pool, mesh, BLOCK, [feed_line(x, *line_ops)],
                       knobs={"optimize": True})
    assert all(r["n_procs"] == [n_fused] for r in ranks)
    assert snr_db(oracle, y) > 100


def test_run_driver_with_mesh(pool, rng):
    C, BLOCK = 4, 2048
    data = rng.standard_normal((C, BLOCK * 2)).astype(np.float32)
    h = np.asarray(ops.design_lowpass(63, 3000, 44100))
    ranks = port(pool, (2, 4), BLOCK, [feed_line(data, op("FIR", h))],
                 entry="run")
    ref = jax_pipe((2, 4), BLOCK, [feed_line(data, op("FIR", h))], entry="run")
    y = ranks[0]["out"][0]
    oracle = scipy.signal.lfilter(h, [1.0], data.astype(np.float64), axis=1)
    assert snr_db(oracle, y) > 100
    assert snr_db(ref["out"][0], y) > 100


def test_mesh_dispatch_noop_preserves_state(pool, rng):
    """The exit-path padding sweeps blocks with every collective of a
    regular one, commits nothing and delivers nothing."""
    C, BLOCK = 4, 2048
    data = rng.standard_normal((C, BLOCK * 2)).astype(np.float32)
    h = np.asarray(ops.design_lowpass(127, 3000, 44100))
    sos = ops.design_peaking_eq(44100, 800, 2.0, 4.0)
    line = feed_line(data, op("FIR", h), op("Biquad", sos))
    ranks = port(pool, (2, 4), BLOCK, [line], noop=3)
    plain = port(pool, (2, 4), BLOCK, [line])
    for r, q in zip(ranks, plain):
        advanced, before, after, shape = r["noop"]
        assert advanced == 3
        assert shape == (C, BLOCK * 2)  # the sink received nothing extra
        leaves = 0
        for comp_b, comp_a in zip(before, after):
            for k in (comp_b or {}):
                np.testing.assert_array_equal(comp_b[k], comp_a[k])
                leaves += 1
        assert leaves >= 3  # the FIR tail and the biquad's carries
        # the three sweeps made the collectives of three regular blocks
        # (a run's sweeps include the no-op ones that pad the stream to its
        # last health round; those rounds are counted apart, as "health")
        assert r["comm"]["health"] == q["comm"]["health"]
        per_block = {k: v[0] // q["blocks"] for k, v in q["comm"].items()
                     if k != "health"}
        for k, v in per_block.items():
            assert q["comm"][k][0] == q["blocks"] * v, k
            assert r["comm"][k][0] == q["comm"][k][0] + 3 * v, k


@pytest.mark.parametrize("kind, extra, C, BLOCK, N, mesh", [
    ("chunky", (7,), 2, 1024, 1024 * 5 + 311, (2, 4)),
    ("packets", (700,), 2, 512, 700 * 11, (1, 4)),
    ("empty", (), 1, 512, 512 * 3 + 100, (1, 4)),
], ids=["midstream_short_reads_rechunked", "feed_over_returning_packets",
        "feed_empty_reads_skipped"])
def test_mesh_feed(pool, rng, kind, extra, C, BLOCK, N, mesh):
    """``test_mesh_midstream_short_reads_rechunked``,
    ``test_mesh_feed_over_returning_packets`` and
    ``test_mesh_feed_empty_reads_skipped``: whatever lengths the feed
    returns, the stream is re-chunked into full blocks, exactly."""
    data = rng.standard_normal((C, N)).astype(np.float32)
    h = np.asarray(ops.design_lowpass(63, 3000, 44100))
    line_ops = [] if kind == "empty" else [op("FIR", h)]
    y, yj, _ = both(pool, mesh, BLOCK,
                    [feed_line(data, *line_ops, kind=kind, extra=extra)])
    assert y.shape == (C, N)
    if kind == "empty":
        np.testing.assert_allclose(y, data, atol=0)
    else:
        oracle = scipy.signal.lfilter(h, [1.0], data.astype(np.float64), axis=1)
        assert snr_db(oracle, y) > 100
    whole = port(pool, mesh, BLOCK, [feed_line(data, *line_ops)])[0]["out"][0]
    np.testing.assert_array_equal(y, whole)  # repacking changes no sample


def test_mesh_short_reads_batched_with_target(pool, rng):
    C, BLOCK, n_blocks, AT = 2, 1024, 12, 6
    data = rng.standard_normal((C, BLOCK * n_blocks)).astype(np.float32)
    h1 = np.asarray(ops.design_lowpass(63, 3000, 44100))
    h2 = np.asarray(ops.design_lowpass(63, 9000, 44100))
    y, _, ranks = both(
        pool, (2, 4), BLOCK,
        [feed_line(data, op("FIR", h1), kind="chunky", extra=(11,))],
        pushes=[(0, 0, "set_taps", (h2,), {}, AT)], knobs={"batch_blocks": 4})
    assert y.shape == (C, BLOCK * n_blocks)
    cut = AT * BLOCK
    z1 = scipy.signal.lfilter(h1, [1.0], data.astype(np.float64), axis=1)
    z2 = scipy.signal.lfilter(h2, [1.0], data.astype(np.float64), axis=1)
    oracle = np.concatenate([z1[:, :cut], z2[:, cut:]], axis=1)
    assert snr_db(oracle, y) > 100
    # the same bits under other knobs: the landing does not depend on them
    other = port(pool, (2, 4), BLOCK,
                 [feed_line(data, op("FIR", h1))],
                 pushes=[(0, 0, "set_taps", (h2,), {}, AT)],
                 knobs={"lookahead": 3})[0]["out"][0]
    np.testing.assert_array_equal(y, other)


# -- new with the port -----------------------------------------------------------


def test_what_a_mesh_pipe_refuses_on_purpose(pool):
    """On a 2x2 mesh: lines in two executors; surgery without ``at_block``
    (every rank must adopt at the same block); an added line that does not
    join the sync group (its handle fails); a batch that mixes a pipe
    structure mutation with untargeted component mutations. Lines of one
    sync group build."""
    res = [r for r in pool.run("pipe_refusals_job", timeout=JOB_LIMIT,
                               mesh=(2, 2)) if r is not None]
    assert len(res) == 4
    for r in res:
        assert r["two executors"][0] == "ValueError"
        assert "ONE executor" in r["two executors"][1]
        assert r["one group"] == ("no error", "")
        for what in ("insert_processor", "add_line"):
            assert r[what][0] == "ValueError", (what, r[what])
            assert "needs at_block=" in r[what][1]
        assert r["mixed batch"][0] == "ValueError"
        assert "mixes a pipe structure mutation" in r["mixed batch"][1]
        err = r["add_line outside the group"]
        assert err[0] == "ValueError" and "join the existing sync group" in err[1]


def test_two_lines_in_one_group_on_ranks(pool, rng):
    """Two lines sharing a context run in one executor on a 2x2 mesh, with
    a push that lands on both at its block."""
    C, BLOCK = 4, 1024
    a = rng.standard_normal((C, BLOCK * 6)).astype(np.float32)
    b = rng.standard_normal((C, BLOCK * 4 + 100)).astype(np.float32)
    lines = [feed_line(a, op("Gain", 0.5)), feed_line(b, op("Gain", 2.0))]
    ranks = port(pool, (2, 2), BLOCK, lines, shared_context=True,
                 pushes=[(0, 0, "set_gain", (0.25,), {}, 3)])
    ya, yb = ranks[0]["out"]
    np.testing.assert_array_equal(ya[:, :3 * BLOCK], 0.5 * a[:, :3 * BLOCK])
    np.testing.assert_array_equal(ya[:, 3 * BLOCK:], 0.25 * a[:, 3 * BLOCK:])
    np.testing.assert_array_equal(yb, 2.0 * b)


def test_a_late_target_raises_on_its_rank_and_every_rank_ends(pool, rng):
    """Rank 1 pushes its target after the stream passed it: it raises
    ``LateTargetError`` there (strict delivery), pads to the next health
    round and flags it, and its peer raises ``RunError`` from
    ``PeerAbortError`` there: every rank ends in under 15 s with the group
    timeout left at 60 s."""
    from pipe_tpu_torch.parallel import mesh as mesh_mod

    assert mesh_mod.GROUP_TIMEOUT_S == 60.0
    C, BLOCK = 2, 1024
    data = rng.standard_normal((C, BLOCK * 40)).astype(np.float32)
    t0 = time.monotonic()
    res = pool.run("pipe_job", timeout=JOB_LIMIT, mesh=(1, 2), block=BLOCK,
                   lines=[feed_line(data, op("Gain", 0.5))],
                   pushes=[(0, 0, "set_gain", (0.25,), {}, 2)], late_rank=1,
                   wait_s=30.0)
    assert time.monotonic() - t0 < 15
    late = res[1]["error"]
    assert late is not None and late[2] == "LateTargetError", late
    assert "arrived after the dispatch frontier" in late[1]
    peer = res[0]["error"]
    assert peer is not None and peer[0] == "RunError", peer
    assert peer[2] == "PeerAbortError", peer


def test_checkpoint_crosses_meshes(pool, rng):
    """A snapshot taken on 2x4 restores on 1x1, on 1x4 and in the JAX
    package and continues the stream; a JAX mesh pipe's snapshot restores
    on the port's ranks."""
    C, BLOCK = 4, 2048
    sos = ops.design_peaking_eq(44100, freq=600, q=1.5, gain_db=3.0)
    h = np.asarray(ops.design_lowpass(127, 3000, 44100))
    line_ops = [op("FIR", h), op("Biquad", sos),
                op("Compressor", threshold_db=-12.0, ratio=3.0)]
    data = (rng.standard_normal((C, BLOCK * 4)) * 0.5).astype(np.float32)
    full = port(pool, (2, 4), BLOCK, [feed_line(data, *line_ops)])[0]["out"][0]
    first = port(pool, (2, 4), BLOCK,
                 [feed_line(data[:, :2 * BLOCK], *line_ops)], snapshot=True)[0]
    for mesh in ((1, 1), (1, 4)):
        second = port(pool, mesh, BLOCK,
                      [feed_line(data[:, 2 * BLOCK:], *line_ops)],
                      restore=first["ckpt"])[0]["out"][0]
        resumed = np.concatenate([first["out"][0], second], axis=1)
        assert resumed.shape == full.shape
        assert snr_db(full, resumed) > 100
        np.testing.assert_allclose(resumed, full, atol=2e-5)
    # and packages: the port's 2x4 snapshot restores into a JAX mesh pipe,
    # a JAX mesh pipe's into the port's ranks
    second = jax_pipe((2, 4), BLOCK, [feed_line(data[:, 2 * BLOCK:], *line_ops)],
                      restore=first["ckpt"])["out"][0]
    resumed = np.concatenate([first["out"][0], second], axis=1)
    np.testing.assert_allclose(resumed, full, atol=2e-5)
    jfirst = jax_pipe((2, 4), BLOCK, [feed_line(data[:, :2 * BLOCK], *line_ops)],
                      snapshot=True)
    second = port(pool, (2, 4), BLOCK,
                  [feed_line(data[:, 2 * BLOCK:], *line_ops)],
                  restore=jfirst["ckpt"])[0]["out"][0]
    resumed = np.concatenate([jfirst["out"][0], second], axis=1)
    np.testing.assert_allclose(resumed, full, atol=2e-5)


def _jax_trees(p):
    import jax

    return [[{"state": jax.tree.map(np.asarray, c.state),
              "params": jax.tree.map(np.asarray, c.params)}
             for c in route.components()] for route in p.routes]


def test_stream_crosses_packages_through_convert(pool, rng):
    """A JAX mesh pipe's component states and params (numpy) continue in
    the port on 2x4 through ``convert.pipe_trees_from_numpy``, and the
    port's (``pipe_trees_to_numpy``) continue in a JAX mesh pipe."""
    import jax.numpy as jnp

    from tests.torch_mesh_worker import build_lines

    C, BLOCK, mesh = 4, 2048, (2, 4)
    sos = ops.design_peaking_eq(44100, freq=600, q=1.5, gain_db=3.0)
    h = np.asarray(ops.design_lowpass(127, 3000, 44100))
    line_ops = [op("FIR", h), op("Biquad", sos),
                op("Delay", 300, feedback=0.4, wet=0.3, dry=1.0)]
    data = (rng.standard_normal((C, BLOCK * 4)) * 0.5).astype(np.float32)
    full = port(pool, mesh, BLOCK, [feed_line(data, *line_ops)])[0]["out"][0]

    def jax_half(part, trees=None):
        lines, _, sinks, _ = build_lines(pipe_tpu, [feed_line(part, *line_ops)])
        p = pipe_tpu.Pipe(BLOCK, *lines, mesh=pipe_tpu.parallel.make_mesh(*mesh))
        if trees is not None:
            import jax

            for route, rt in zip(p.routes, trees):
                for comp, t in zip(route.components(), rt):
                    comp.state = jax.tree.map(
                        lambda a: jnp.asarray(a), t["state"])
                    comp.params = jax.tree.map(
                        lambda a: jnp.asarray(a), t["params"])
        p.start()
        p.wait(120)
        return sinks[0].values, _jax_trees(p)

    # JAX first, the port second
    ya, trees = jax_half(data[:, :2 * BLOCK])
    yb = port(pool, mesh, BLOCK, [feed_line(data[:, 2 * BLOCK:], *line_ops)],
              trees_in=trees)[0]["out"][0]
    resumed = np.concatenate([ya, yb], axis=1)
    assert snr_db(full, resumed) > 100
    np.testing.assert_allclose(resumed, full, atol=2e-5)
    # the port first, JAX second
    first = port(pool, mesh, BLOCK, [feed_line(data[:, :2 * BLOCK], *line_ops)],
                 trees_out=True)[0]
    yb, _ = jax_half(data[:, 2 * BLOCK:], first["trees"])
    resumed = np.concatenate([first["out"][0], yb], axis=1)
    assert snr_db(full, resumed) > 100
    np.testing.assert_allclose(resumed, full, atol=2e-5)
    # names, shapes and integer-ness are checked on the way in
    bad = [[dict(t) for t in rt] for rt in trees]
    bad[0][1] = {"state": {"tail": np.zeros((C, 5), np.float32)},
                 "params": trees[0][1]["params"]}
    with pytest.raises(JobError, match="shape"):
        pool.run("pipe_job", timeout=JOB_LIMIT, mesh=mesh, block=BLOCK,
                 lines=[feed_line(data, *line_ops)], trees_in=bad)


def test_a_rank_whose_feed_fails_ends_every_ranks_job_within_its_limit(pool, rng):
    """Rank 1's feed raises at block 3 of a 1x2 mesh pipe: it reports the
    failure, pads to the next health round and flags it; its peer raises
    ``RunError`` from ``PeerAbortError`` there (after its own stream ended:
    the last round follows the padding at the end of the stream). Every
    rank ends in under 15 s with the group timeout left at 60 s."""
    from pipe_tpu_torch.parallel import mesh as mesh_mod

    assert mesh_mod.GROUP_TIMEOUT_S == 60.0
    C, BLOCK = 2, 1024
    data = rng.standard_normal((C, BLOCK * 8)).astype(np.float32)
    h = np.asarray(ops.design_lowpass(63, 3000, 44100))
    t0 = time.monotonic()
    res = pool.run("pipe_job", timeout=JOB_LIMIT, mesh=(1, 2), block=BLOCK,
                   lines=[feed_line(data, op("FIR", h), kind="failing",
                                    extra=(3, 1))],
                   wait_s=40.0)
    took = time.monotonic() - t0
    assert took < 15, took
    assert res[1]["error"][0] == "RunError" and "feed failed" in res[1]["error"][1]
    assert res[0]["error"] is not None and res[0]["error"][0] == "RunError"
    assert res[0]["error"][2] == "PeerAbortError", res[0]["error"]
    # the failing rank delivered what it fed; its peer streams on up to the
    # round where it hears the flag (16 dispatches; the stream has 8)
    assert res[1]["out"][0].shape[1] <= 3 * BLOCK
    assert res[0]["out"][0].shape[1] <= 8 * BLOCK

"""The port's sharded layer (``pipe_tpu_torch.parallel``) against the JAX
package's: twins of ``tests/test_parallel.py`` for the main path's stages,
every stage against its oracle and its JAX counterpart, and streams handed
between the packages, on the same seeded inputs and at the same sizes (the
other twins are in ``tests/test_torch_parallel_stages.py``).

The JAX ``ShardedChain`` runs in this process on the 8 virtual CPU devices;
the port's runs one process per shard, in a pool of 8 gloo ranks started
once for this file (``tests/torch_mesh_worker.py``). Every job has its own
time limit, after which the pool is killed and the test fails. Tolerances:
>= 100 dB (``snr_db``) against the float64 oracles and between the
packages; ``atol=2e-5`` where the reference test uses it.
"""

import inspect

import numpy as np
import pytest
import scipy.signal
import torch

import jax

import pipe_tpu_torch
from pipe_tpu import parallel as jparallel
from pipe_tpu.ops.resample import polyphase_design
from pipe_tpu_torch import convert, ops, parallel
from pipe_tpu_torch.parallel import mesh as tmesh
from pipe_tpu_torch.signal import snr_db
from tests.test_ops import _resample_oracle
from tests.test_parallel import _echo_oracle, _envelope64
from tests.torch_mesh_worker import JobError, Pool, PoolTimeout

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)

JOB_LIMIT = 60.0  # seconds a job may take before the pool is killed


@pytest.fixture(scope="module")
def pool():
    p = Pool(world=8)
    yield p
    p.close()


def spec(name, *args, **kwargs):
    """A stage by name, built alike in both packages."""
    return (name, args, kwargs)


def run_port(pool, mesh, stages, channels, chunk, x, **kw):
    """Per-rank results of the port's chain (None for ranks off the mesh)."""
    res = pool.run("chain_job", timeout=JOB_LIMIT, mesh=mesh, stages=stages,
                   channels=channels, chunk_frames=chunk, x=x, **kw)
    members = [r for r in res if r is not None]
    assert len(members) == mesh[0] * mesh[1]
    for r in members[1:]:  # every rank gathers the same global output
        np.testing.assert_array_equal(r["out"], members[0]["out"])
        assert r["local_shape"] == members[0]["local_shape"]
    return members


def jax_chain(mesh, stages, channels, chunk):
    return jparallel.ShardedChain(
        jparallel.make_mesh(*mesh),
        [getattr(jparallel.chain, n)(*a, **k) for n, a, k in stages],
        channels=channels, chunk_frames=chunk)


def both(pool, mesh, stages, channels, chunk, x, **kw):
    """``(port output, JAX output)`` for the same chain and stream."""
    out = run_port(pool, mesh, stages, channels, chunk, x, **kw)[0]["out"]
    jout = jax_chain(mesh, stages, channels, chunk).process(x)
    assert out.shape == jout.shape
    return out, jout


def assert_100db(oracle, out, jout, bar=100):
    assert snr_db(oracle, out) > bar, snr_db(oracle, out)
    assert snr_db(jout.astype(np.float64), out) > bar


# ---------------------------------------------------------------------------
# twins of tests/test_parallel.py
# ---------------------------------------------------------------------------


def test_fir_time_sharded(rng, pool):
    h = ops.design_lowpass(255, cutoff=4000, sample_rate=44100)
    x = rng.standard_normal((2, 8192)).astype(np.float32)
    out, jout = both(pool, (1, 4), [spec("FIRStage", h)], 2, 4096, x)
    oracle = scipy.signal.lfilter(h, [1.0], x.astype(np.float64), axis=1)
    assert out.shape == x.shape
    assert_100db(oracle, out, jout)


def test_fir_channel_and_time_sharded(rng, pool):
    h = ops.design_lowpass(101, cutoff=2000, sample_rate=44100)
    x = rng.standard_normal((8, 4096)).astype(np.float32)
    out, jout = both(pool, (2, 4),
                     [spec("FIRStage", h), spec("GainStage", 0.5)], 8, 2048, x)
    oracle = 0.5 * scipy.signal.lfilter(h, [1.0], x.astype(np.float64), axis=1)
    assert_100db(oracle, out, jout)


def test_resample_time_sharded(rng, pool):
    # N_local = 588 = 4*147 satisfies the divisibility rule for 160/147
    x = rng.standard_normal((2, 4704)).astype(np.float32)  # 2 chunks of 2352
    out, jout = both(pool, (1, 4), [spec("ResampleStage", 48000, 44100)],
                     2, 2352, x)
    assert out.shape == (2, 4704 * 160 // 147)
    hp64 = polyphase_design(160, 147, 32)
    oracle = _resample_oracle(x.astype(np.float64), hp64, 160, 147)
    assert_100db(oracle, out, jout)


def test_biquad_time_sharded_cross_device_scan(rng, pool):
    """IIR feedback crossing 4 rank boundaries via the local recurrence +
    cross-rank prefix + refinement must match sequential sosfilt."""
    sos = ops.design_peaking_eq(44100, freq=1000, q=2.0, gain_db=6.0)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    out, jout = both(pool, (1, 4), [spec("BiquadStage", sos)], 2, 2048, x)
    oracle = scipy.signal.sosfilt(sos[None, :], x.astype(np.float64), axis=1)
    assert_100db(oracle, out, jout)


def test_biquad_time_sharded_high_q_100db(rng, pool):
    """|pole|~=0.995 EQ at 100 dB vs the float64 oracle on a sharded mesh,
    multi-chunk so the refined carry crosses both the chunk and the rank
    boundary; parity with the port's streaming engine."""
    sos = ops.design_peaking_eq(44100, freq=1000, q=10.0, gain_db=6.0)
    assert np.sqrt(sos[5]) >= 0.9949
    x = rng.standard_normal((8, 16384)).astype(np.float32)
    out, jout = both(pool, (2, 4), [spec("BiquadStage", sos)], 8, 4096, x)
    oracle = scipy.signal.sosfilt(sos[None, :], x.astype(np.float64), axis=1)
    assert_100db(oracle, out, jout)
    streamed = pipe_tpu_torch.process(x, [ops.Biquad(sos).processor()],
                                      block_size=4096, sample_rate=44100.0)
    assert snr_db(streamed.astype(np.float64), out) > 100


def test_biquad_time_sharded_extended_precision(rng, pool):
    """precision='extended' on the mesh: a 60 Hz q=0.7 section (float32
    floor ~85 dB) must stay >=100 dB with the dd recurrence sharded over 4
    time shards and the dd carry crossing two chunk boundaries."""
    sos = ops.design_peaking_eq(44100, freq=60.0, q=0.7, gain_db=6.0)
    x = rng.standard_normal((2, 12288)).astype(np.float32)
    out, jout = both(pool, (1, 4),
                     [spec("BiquadStage", sos, precision="extended")],
                     2, 4096, x)
    oracle = scipy.signal.sosfilt(sos[None, :], x.astype(np.float64), axis=1)
    assert_100db(oracle, out, jout)
    # and the f32 stage is genuinely below the bar here (floor is real)
    std = run_port(pool, (1, 4), [spec("BiquadStage", sos)], 2, 4096, x)
    assert snr_db(oracle, std[0]["out"]) < 100


def test_mix_psum_merged_sink(rng, pool):
    """Config-5 shape: channel-sharded lines merged by a summing mixer."""
    x = rng.standard_normal((8, 2048)).astype(np.float32)
    m = rng.standard_normal((2, 8)).astype(np.float32)
    out, jout = both(pool, (4, 2), [spec("MixStage", m)], 8, 1024, x)
    oracle = m.astype(np.float64) @ x.astype(np.float64)
    assert out.shape == (2, 2048)
    assert_100db(oracle, out, jout)


def _config5(C):
    h = ops.design_lowpass(255, cutoff=4000, sample_rate=44100)
    mix = (np.ones((2, C)) / C).astype(np.float32)
    return h, mix


def _config5_oracle(x, h, mix, sos_rows=()):
    fx = scipy.signal.lfilter(h, [1.0], x.astype(np.float64), axis=1)
    rx = _resample_oracle(fx, polyphase_design(160, 147, 32), 160, 147)
    for sos in sos_rows:
        rx = scipy.signal.sosfilt(np.asarray(sos)[None, :], rx, axis=1)
    return mix.astype(np.float64) @ rx


def test_full_config5_chain(rng, pool):
    """FIR -> 44.1k->48k resample -> merged mix, channels+time sharded: the
    headline graph, verified against the sequential oracle."""
    C = 8
    h, mix = _config5(C)
    x = rng.standard_normal((C, 2352)).astype(np.float32)
    stages = [spec("FIRStage", h), spec("ResampleStage", 48000, 44100),
              spec("MixStage", mix)]
    out, jout = both(pool, (2, 4), stages, C, 2352, x)
    oracle = _config5_oracle(x, h, mix)
    assert out.shape == oracle.shape
    assert_100db(oracle, out, jout)


def test_chunked_equals_single_chunk(rng, pool):
    """Carry across chunks: two 2048-chunks == one 4096-chunk."""
    h = ops.design_lowpass(127, cutoff=3000, sample_rate=44100)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    c1 = run_port(pool, (1, 2), [spec("FIRStage", h)], 2, 4096, x)[0]["out"]
    c2 = run_port(pool, (1, 2), [spec("FIRStage", h)], 2, 2048, x)[0]["out"]
    np.testing.assert_allclose(c1, c2, atol=2e-5)


def _build_error(pool, mesh, stages, channels, chunk):
    """The error every member rank raised (all alike), as (mro, message)."""
    res = [r for r in pool.run("build_error_job", timeout=JOB_LIMIT, mesh=mesh,
                               stages=stages, channels=channels,
                               chunk_frames=chunk) if r is not None]
    assert len(res) == mesh[0] * mesh[1]
    assert all(r == res[0] for r in res), res  # no rank is left waiting
    return res[0][1], res[0][2]


def test_validation_errors(pool):
    """The reference's messages, raised by every rank alike."""
    h = np.ones(9)
    cases = [
        ((1, 2), [spec("FIRStage", h)], 2, 1001, "divisible"),
        ((1, 2), [spec("MixStage", np.ones((1, 2))), spec("GainStage", 1.0)],
         2, 1024, "last stage"),
        ((1, 4), [spec("FIRStage", np.ones(2000))], 2, 4096, "halo"),
        ((1, 4), [spec("ResampleStage", 48000, 44100)], 2, 4096,
         "divisible by 147"),
        ((2, 2), [spec("FIRStage", np.ones((3, 9)))], 4, 1024,
         "per-channel taps for 3 channels, chain has 4"),
        ((1, 2), [spec("MixStage", np.ones((2, 3)))], 4, 1024,
         "mix matrix expects 3 input channels, chain has 4"),
    ]
    for mesh, stages, channels, chunk, match in cases:
        mro, msg = _build_error(pool, mesh, stages, channels, chunk)
        assert "ValueError" in mro and match in msg, (mro, msg)
        # the JAX package raises the same for the same build
        with pytest.raises(ValueError, match=match):
            jax_chain(mesh, stages, channels, chunk)
    mro, _ = _build_error(pool, (1, 4), [spec("FIRStage", np.ones(2000))], 2, 4096)
    assert "ShapeConstraintError" in mro
    # a mesh larger than the group: here 8 ranks, in this process none
    msgs = pool.run("mesh_error_job", timeout=JOB_LIMIT, mesh=(4, 4))
    assert all("needs 16 devices, have 8" in m for m in msgs), msgs
    with pytest.raises(ValueError, match="needs 8 devices"):
        parallel.make_mesh(4, 2)
    with pytest.raises(ValueError, match="cluster has 1"):
        parallel.make_global_mesh(2, 4)
    with pytest.raises(ValueError, match="no counterpart"):
        parallel.make_mesh(1, 1, devices=[0])


def test_global_mesh_and_host_sharding(rng, pool):
    """One process: ``initialize`` is a no-op, a 1x1 global mesh needs no
    group, and ``shard_host_chunk`` declares the local block. On the pool:
    each rank feeds its own block and gets its own block back."""
    parallel.initialize()
    parallel.initialize()  # idempotent
    mesh = parallel.make_global_mesh(channel_shards=1, time_shards=1)
    assert mesh.size == 1 and mesh.member and mesh.transport is None
    x = rng.standard_normal((4, 147 * 32)).astype(np.float32)
    gx = parallel.shard_host_chunk(mesh, x)
    assert gx.shape == x.shape
    chain = parallel.ShardedChain(mesh, [parallel.GainStage(2.0)], channels=4,
                                  chunk_frames=147 * 32)
    y = chain.step(gx)
    np.testing.assert_allclose(y.numpy(), 2.0 * x, rtol=1e-6)
    np.testing.assert_array_equal(chain.step(x).numpy(), y.numpy())

    res = run_port(pool, (2, 4), [spec("GainStage", 2.0)], 4, 147 * 32, x,
                   local_input=True)
    np.testing.assert_allclose(res[0]["out"], 2.0 * x, rtol=1e-6)
    assert res[0]["local_shape"] == (2, 147 * 8)
    assert sorted(r["position"] for r in res) == [
        (c, t) for c in range(2) for t in range(4)]  # time last


def test_fused_fir_resample_stage_matches_two_stage(rng, pool):
    """FIRResampleStage == FIRStage + ResampleStage over a (2, 4) mesh."""
    C = 4
    x = rng.standard_normal((C, 2352 * 2)).astype(np.float32)
    h = ops.design_lowpass(255, cutoff=4000, sample_rate=44100)
    y_two = run_port(pool, (2, 4), [spec("FIRStage", h),
                                    spec("ResampleStage", 48000, 44100)],
                     C, 2352, x)[0]["out"]
    y_fused, j_fused = both(pool, (2, 4),
                            [spec("FIRResampleStage", h, 48000, 44100)],
                            C, 2352, x)
    assert y_fused.shape == y_two.shape
    assert snr_db(y_two, y_fused) > 100
    assert snr_db(j_fused.astype(np.float64), y_fused) > 100


def test_fir_per_channel_taps_sharded(rng, pool):
    """Per-channel taps shard over CH_AXIS along with the channels."""
    C, T = 4, 65
    taps = np.stack([
        np.asarray(ops.design_lowpass(T, 1000.0 * (c + 1), 44100.0))
        for c in range(C)
    ])
    x = rng.standard_normal((C, 4096)).astype(np.float32)
    out, jout = both(pool, (2, 4), [spec("FIRStage", taps)], C, 2048, x)
    oracle = np.stack([
        scipy.signal.lfilter(taps[c], [1.0], x[c].astype(np.float64))
        for c in range(C)
    ])
    assert_100db(oracle, out, jout)


def test_chain_live_param_retune_no_recompile(pool):
    """Replacing a stage's parameter between chunks is a live retune: the
    chain reads ``stage.params`` at every step."""
    C, chunk = 2, 1024
    x = np.ones((C, 2 * chunk), np.float32)
    res = run_port(pool, (1, 4), [spec("GainStage", 1.0)], C, chunk, x,
                   retune=(1, 0, "gain", np.float32(0.25)))
    out = res[0]["out"]
    assert np.allclose(out[:, :chunk], 1.0) and np.allclose(out[:, chunk:], 0.25)
    # in one process: an unchanged leaf is not localized again
    chain = parallel.ShardedChain(parallel.make_mesh(1, 1),
                                  [parallel.GainStage(1.0)], C, chunk)
    p1 = chain.params()[0]["gain"]
    assert chain.params()[0]["gain"] is p1
    chain.stages[0].params["gain"] = np.float32(0.25)
    assert float(chain.params()[0]["gain"]) == 0.25
    assert np.allclose(chain.step(x[:, :chunk]).numpy(), 0.25)


def test_biquad_retune_replaces_the_kept_boundary_responses(rng):
    """A BiquadStage keeps its unit-state responses between chunks; a retune
    (a replaced ``sos`` leaf, the rank's tensor written in place, or the
    host array edited in place) must drop them and take effect.
    Without the refinement pass, which would repair a stale response: 90 dB
    is the unrefined float32 recurrence's own floor here."""
    sos_a = ops.design_peaking_eq(48000, 1000, 1.0, 3.0)
    sos_b = ops.design_peaking_eq(48000, 3000, 2.0, -6.0)
    sos_c = ops.design_highshelf(48000, 8000, -2.0)
    x = rng.standard_normal((8, 4 * 2048)).astype(np.float32)
    for cls, pack in ((parallel.BiquadStage, lambda r: r),
                      (parallel.BiquadCascadeStage, lambda r: r[None, :])):
        st = cls(pack(sos_a), refine=False)
        chain = parallel.ShardedChain(parallel.make_mesh(1, 1), [st], 8, 2048)
        y = [chain.step(x[:, :2048]).numpy()]
        kept = dict((st if cls is parallel.BiquadStage else st._row)._basis)
        st.params["sos"] = pack(np.float32(sos_b))  # replaced
        y.append(chain.step(x[:, 2048:4096]).numpy())
        chain.params()[0]["sos"].copy_(torch.tensor(pack(np.float32(sos_a))))
        y.append(chain.step(x[:, 4096:6144]).numpy())  # written in place
        host = st.params["sos"]
        host[...] = pack(np.float32(sos_c))  # the host array edited in place
        assert st.params["sos"] is host
        y.append(chain.step(x[:, 6144:]).numpy())
        assert kept and len(kept) == 1
        # the oracle: the direct form I recurrence in float64 (the stage's
        # state is the last two inputs and outputs), coefficients switched
        # at the chunk boundaries
        x64 = np.concatenate([np.zeros((8, 2)), x.astype(np.float64)], axis=1)
        want = np.zeros_like(x64)
        for i, sos in enumerate((sos_a, sos_b, sos_a, sos_c)):
            c = np.float32(sos).astype(np.float64)
            for ch in range(8):
                lo = 2 + i * 2048
                zi = scipy.signal.lfiltic(c[:3], c[3:], want[ch, lo - 2:lo][::-1],
                                          x64[ch, lo - 2:lo][::-1])
                want[ch, lo:lo + 2048], _ = scipy.signal.lfilter(
                    c[:3], c[3:], x64[ch, lo:lo + 2048], zi=zi)
        assert snr_db(want[:, 2:], np.concatenate(y, 1)) > 90


def test_gain_stage_per_channel_vector(pool):
    C, chunk = 4, 1024
    g = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    x = np.ones((C, chunk), np.float32)
    out, jout = both(pool, (2, 2), [spec("GainStage", g)], C, chunk, x)
    assert np.allclose(out, g[:, None]) and np.allclose(jout, g[:, None])


def test_exclusive_prefix_ladder_matches_gather(rng, pool):
    """The shift-ladder exclusive prefix == the all_gather one on a
    non-commutative associative op (2x2 matrix products), any axis size,
    and both equal the sequential left fold."""
    for t in (1, 2, 4, 8):
        vals = rng.standard_normal((t, 2, 2)).astype(np.float32)
        res = pool.run("prefix_job", timeout=JOB_LIMIT, t=t, vals=vals)[:t]
        acc = np.eye(2)
        for d, (g, l) in enumerate(res):
            np.testing.assert_allclose(g, l, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(g, acc, rtol=1e-5, atol=1e-6)
            acc = vals[d].astype(np.float64) @ acc


def test_mesh_shape_invariance(rng, pool):
    """One chain, one stream, four mesh shapes: the output does not depend
    on how the mesh factors, to 100 dB (sums run in another order on every
    shape, so never to the bit). The reference's chain."""
    sos = ops.design_peaking_eq(44100, freq=800, q=2.0, gain_db=4.0)
    h = np.asarray(ops.design_lowpass(63, 5000, 44100))
    x = rng.standard_normal((8, 8192)).astype(np.float32)
    stages = [spec("FIRStage", h), spec("BiquadStage", sos),
              spec("CompressorStage", threshold_db=-12.0, ratio=3.0)]

    ref = run_port(pool, (1, 1), stages, 8, 4096, x)[0]["out"].astype(np.float64)
    jref = jax_chain((1, 1), stages, 8, 4096).process(x)
    assert snr_db(jref.astype(np.float64), ref) > 100
    for ch, t in [(2, 1), (1, 4), (2, 4)]:
        out = run_port(pool, (ch, t), stages, 8, 4096, x)[0]["out"]
        s = snr_db(ref, out)
        assert s > 100, f"mesh {ch}x{t}: {s:.1f} dB"


# ---------------------------------------------------------------------------
# the sharded main path with the EQ, the remaining stages, and the handoff
# ---------------------------------------------------------------------------

EQ_ROWS = (
    ops.design_peaking_eq(48000, freq=1000, q=1.0, gain_db=3.0),
    ops.design_highshelf(48000, freq=8000, gain_db=-2.0),
)


def _main_path(C):
    h, mix = _config5(C)
    return h, mix, [
        spec("FIRStage", h), spec("ResampleStage", 48000, 44100, 32),
        spec("BiquadStage", EQ_ROWS[0]), spec("BiquadStage", EQ_ROWS[1]),
        spec("MixStage", mix)]


@pytest.mark.parametrize("mesh", [(1, 4), (2, 2), (2, 4), (4, 2)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_config5_with_eq_on_every_mesh(rng, pool, mesh):
    """FIR -> resample -> two EQ sections -> merged mix, three chunks: the
    float64 oracle, the JAX chain on the same mesh, and chunked == one
    chunk."""
    C, chunk = 8, 2352
    h, mix, stages = _main_path(C)
    x = rng.standard_normal((C, 3 * chunk)).astype(np.float32)
    res = run_port(pool, mesh, stages, C, chunk, x)
    out = res[0]["out"]
    jout = jax_chain(mesh, stages, C, chunk).process(x)
    oracle = _config5_oracle(x, h, mix, EQ_ROWS)
    assert out.shape == oracle.shape == (2, 3 * 2560)
    assert_100db(oracle, out, jout)
    assert res[0]["local_shape"] == (2, 2560 // mesh[1])
    one = run_port(pool, mesh, stages, C, 3 * chunk, x)[0]["out"]
    np.testing.assert_allclose(out, one, atol=2e-5)
    # the carries are replicated over the time axis: ranks of one channel
    # row hold the same bits
    by_row = {}
    for r in res:
        by_row.setdefault(r["position"][0], []).append(r["local_carries"])
    for row in by_row.values():
        for other in row[1:]:
            for a, b in zip(jax.tree.leaves(row[0]), jax.tree.leaves(other)):
                np.testing.assert_array_equal(a, b)
    # the collectives of a chunk, counted on the host: one halo and one
    # carry broadcast for the FIR where there is a time axis, one
    # all_reduce for the mix where there is a channel axis
    comm = res[0]["comm"]
    assert comm[0] == {"send_recv": [1, 254 * 4 * C // mesh[0]],
                       "broadcast": [1, 254 * 4 * C // mesh[0]]}
    assert comm[4] == ({"all_reduce": [1, 2 * (2560 // mesh[1]) * 4]}
                       if mesh[0] > 1 else {})
    assert comm[2]["all_gather"][0] == 2  # the prefix of each pass


OTHER_STAGES = {
    "FIRCascadeStage": (
        lambda C: [spec("FIRCascadeStage",
                        [ops.design_lowpass(63, 5000, 44100),
                         ops.design_lowpass(33, 8000, 44100)])],
        lambda x: scipy.signal.lfilter(
            ops.design_lowpass(33, 8000, 44100), [1.0],
            scipy.signal.lfilter(ops.design_lowpass(63, 5000, 44100), [1.0],
                                 x, axis=1), axis=1)),
    "FIRGainStage": (
        lambda C: [spec("FIRGainStage", ops.design_lowpass(63, 5000, 44100),
                        np.linspace(0.5, 2.0, C).astype(np.float32))],
        lambda x: np.linspace(0.5, 2.0, x.shape[0]).astype(np.float32)[:, None]
        * scipy.signal.lfilter(ops.design_lowpass(63, 5000, 44100), [1.0], x,
                               axis=1)),
    "MixGainStage": (
        lambda C: [spec("MixGainStage", (np.ones((2, C)) / C).astype(np.float32),
                        np.linspace(0.5, 2.0, C).astype(np.float32), side="in")],
        lambda x: (np.ones((2, x.shape[0])) / x.shape[0]).astype(np.float32)
        @ (np.linspace(0.5, 2.0, x.shape[0]).astype(np.float32)[:, None] * x)),
    "BiquadCascadeStage": (
        lambda C: [spec("BiquadCascadeStage", np.stack(EQ_ROWS))],
        lambda x: scipy.signal.sosfilt(np.stack(EQ_ROWS), x, axis=1)),
    "BiquadCascadeStage-extended": (
        lambda C: [spec("BiquadCascadeStage", np.stack(EQ_ROWS),
                        precision="extended")],
        lambda x: scipy.signal.sosfilt(np.stack(EQ_ROWS), x, axis=1)),
    "BiquadStage-norefine": (
        lambda C: [spec("BiquadStage", EQ_ROWS[0], refine=False)],
        lambda x: scipy.signal.sosfilt(EQ_ROWS[0][None, :], x, axis=1)),
}


def _ir(P, C=None):
    """A decaying seeded IR, shared (P,) or per-channel (C, P)."""
    shape = (P,) if C is None else (C, P)
    return (np.random.default_rng(P).standard_normal(shape)
            * np.exp(-np.arange(P) / (P / 5.0)))


def _conv(x, ir):
    rows = ir if ir.ndim == 2 else [ir] * x.shape[0]
    return np.stack([scipy.signal.fftconvolve(x[c], rows[c])[: x.shape[1]]
                     for c in range(x.shape[0])])


def _dynamics_oracle(x, attack_ms, release_ms, gain_of_env_db):
    env = _envelope64(x, attack_ms=attack_ms, release_ms=release_ms)
    return x * gain_of_env_db(20.0 * np.log10(np.maximum(env, 1e-8)))


def _streamed(processors_of, block=512, sample_rate=44100.0):
    """The port's streaming engine on the same input as the oracle."""
    return lambda x: pipe_tpu_torch.process(
        x.astype(np.float32), processors_of(), block_size=block,
        sample_rate=sample_rate).astype(np.float64)


def _bursty(rng, C, n):
    x = (rng.standard_normal((C, n)) * 0.5).astype(np.float32)
    x[:, n // 3: 2 * n // 3] *= 1e-4
    return x


def _fm(rng, C, n):
    t = np.arange(n) / 48000.0
    x = np.cos(2 * np.pi * 10000.0 * t + 2.0 * np.sin(2 * np.pi * 1000.0 * t))
    return (np.linspace(0.5, 1.0, C)[:, None] * x).astype(np.float32)


_LP = ops.design_lowpass(63, 4000, 48000)
_GAINS = np.random.default_rng(3).uniform(0.0, 1.5, (4, 129)).astype(np.float32)

# name -> (stages of C, oracle of x in float64[, input of (rng, C, n)]); on
# the 2x4 mesh below n_local is 512
OTHER_STAGES.update({
    "OLSStage": (
        lambda C: [spec("OLSStage", _ir(300))], lambda x: _conv(x, _ir(300))),
    "OLSStage-partitioned": (
        lambda C: [spec("OLSStage", _ir(1500, C))],
        lambda x: _conv(x, _ir(1500, x.shape[0]))),
    "OLSGainStage": (
        lambda C: [spec("OLSGainStage", _ir(1500),
                        np.linspace(0.5, 2.0, C).astype(np.float32))],
        lambda x: np.linspace(0.5, 2.0, x.shape[0]).astype(np.float32)[:, None]
        * _conv(x, _ir(1500))),
    "CompressorStage": (
        lambda C: [spec("CompressorStage", -12.0, 3.0, 2.0, 60.0)],
        lambda x: _dynamics_oracle(
            x, 2.0, 60.0,
            lambda db: 10.0 ** (-np.maximum(db + 12.0, 0.0) * (2.0 / 3.0) / 20.0))),
    "LimiterStage": (
        lambda C: [spec("LimiterStage", -6.0, 0.5, 40.0)],
        lambda x: _dynamics_oracle(
            x, 0.5, 40.0, lambda db: 10.0 ** (-np.maximum(db + 6.0, 0.0) / 20.0))),
    "GateStage": (
        lambda C: [spec("GateStage", -30.0, 60.0, 1.0, 5.0)],
        lambda x: _dynamics_oracle(
            x, 1.0, 5.0, lambda db: np.where(db >= -30.0, 1.0, 1e-3)),
        _bursty),
    "DelayStage-pure": (
        lambda C: [spec("DelayStage", 300, wet=1.0, dry=0.25)],
        lambda x: _echo_oracle(x, 300, 0.0, 1.0, 0.25)),
    "DelayStage-ladder": (
        lambda C: [spec("DelayStage", 300, feedback=0.6, wet=0.8, dry=0.5)],
        lambda x: _echo_oracle(x, 300, 0.6, 0.8, 0.5)),
    "DelayStage-wave": (
        lambda C: [spec("DelayStage", 1200, feedback=0.55, wet=0.8, dry=0.5)],
        lambda x: _echo_oracle(x, 1200, 0.55, 0.8, 0.5)),
    "DelayStage-ring": (
        lambda C: [spec("DelayStage", 3000, feedback=0.6, wet=0.8, dry=0.5)],
        lambda x: _echo_oracle(x, 3000, 0.6, 0.8, 0.5)),
    "SpectralGainStage": (
        lambda C: [spec("SpectralGainStage", 256, 64, _GAINS)],
        _streamed(lambda: [ops.SpectralGain(256, 64, _GAINS).processor()])),
    "SpectralGateStage": (
        lambda C: [spec("SpectralGateStage", 256, 64, 8.0, -60.0, 6.0)],
        _streamed(lambda: [ops.SpectralGate(256, 64, 8.0, -60.0, 6.0).processor()])),
    "ChannelizerStage": (
        lambda C: [spec("ChannelizerStage", 8, taps_per_branch=8)],
        _streamed(lambda: [ops.Channelizer(8, taps_per_branch=8).processor()])),
    "IQMixStage-FMDiscriminatorStage": (
        lambda C: [spec("IQMixStage", 10000.0, sample_rate=48000.0),
                   spec("FIRStage", _LP), spec("FMDiscriminatorStage")],
        _streamed(lambda: ops.fm_demod_factory(10000.0, _LP), sample_rate=48000.0),
        _fm),
    "IQMixStage-EnvelopeDetectorStage": (
        lambda C: [spec("IQMixStage", 10000.0, sample_rate=48000.0),
                   spec("FIRStage", _LP), spec("EnvelopeDetectorStage")],
        _streamed(lambda: ops.am_demod_factory(10000.0, _LP), sample_rate=48000.0),
        _fm),
})


@pytest.mark.parametrize("name", OTHER_STAGES)
def test_stage_vs_oracle_and_jax(rng, pool, name):
    """Each stage beyond the main path on a 2x4 mesh, two chunks."""
    C, chunk = 4, 2048
    stages_of, oracle_of, *input_of = OTHER_STAGES[name]
    if input_of:
        x = input_of[0](rng, C, 2 * chunk)
    else:
        x = rng.standard_normal((C, 2 * chunk)).astype(np.float32)
    out, jout = both(pool, (2, 4), stages_of(C), C, chunk, x)
    # without its refinement pass a section sits at the float32 recurrence's
    # own floor in both packages, with independent rounding noise: 95 dB
    bar = 95 if name.endswith("norefine") else 100
    assert_100db(oracle_of(x.astype(np.float64)), out, jout, bar=bar)


def test_channel_padding_of_non_dividing_counts(rng, pool):
    """6 channels on a 4-wide channel axis ride two zero pad rows, sliced off
    the gathered output; the mix's columns are padded alike."""
    C, chunk = 6, 2048
    h, mix = _config5(C)
    x = rng.standard_normal((C, 2 * chunk)).astype(np.float32)
    stages = [spec("FIRStage", h), spec("GainStage", np.arange(1.0, C + 1))]
    res = run_port(pool, (4, 2), stages, C, chunk, x)
    fx = scipy.signal.lfilter(h, [1.0], x.astype(np.float64), axis=1)
    assert res[0]["out"].shape == (C, 2 * chunk) and res[0]["local_shape"] == (2, 1024)
    assert snr_db(np.arange(1.0, C + 1)[:, None] * fx, res[0]["out"]) > 100
    out, jout = both(pool, (4, 2), [spec("FIRStage", h), spec("MixStage", mix)],
                     C, chunk, x)
    assert_100db(mix.astype(np.float64) @ fx, out, jout)


def _handoff_chains(rng):
    """name -> (channels, chunk, stages, input, float64 oracle or None): the
    main path, and three chains that between them hold every other carry
    (``zfdl``, ``env``/``env_lo``, the ladder's ``hist``, ``ring``, the
    spectral ``hist``/``tail``, the single-FFT ``hist``; the oscillator's
    ``n``, ``tail``, ``prev``; the channelizer's ``hist``)."""
    C, chunk = 8, 2352
    h, mix, main = _main_path(C)
    main[2] = spec("BiquadStage", EQ_ROWS[0], precision="extended")
    x = rng.standard_normal((C, 4 * chunk)).astype(np.float32)
    effects = [
        spec("OLSStage", _ir(3000)), spec("CompressorStage", -12.0, 3.0),
        spec("DelayStage", 300, feedback=0.5, wet=0.5, dry=0.5),
        spec("DelayStage", 2500, feedback=0.4, wet=0.5, dry=0.5),
        spec("SpectralGainStage", 256, 64, _GAINS),
        spec("OLSGainStage", _ir(200), 0.5)]
    receiver = [spec("IQMixStage", 10000.0, sample_rate=48000.0),
                spec("FIRStage", _LP), spec("FMDiscriminatorStage")]
    bank = [spec("LimiterStage", -6.0, 0.5, 40.0),
            spec("DelayStage", 700, wet=1.0, dry=0.25),
            spec("ChannelizerStage", 8, taps_per_branch=8)]
    x4 = rng.standard_normal((4, 4 * 4096)).astype(np.float32)
    return {
        "main": (C, chunk, main, x, _config5_oracle(x, h, mix, EQ_ROWS)),
        "effects": (4, 4096, effects, x4, None),
        "receiver": (4, 4096, receiver, _fm(rng, 4, 4 * 4096), None),
        "bank": (4, 4096, bank, x4, None),
    }


@pytest.mark.parametrize("name", ["main", "effects", "receiver", "bank"])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_stream_crosses_packages_through_convert(rng, pool, direction, name):
    """A stream begun in one package's ShardedChain continues in the
    other's from the global carries: the whole output >= 100 dB against the
    oracle of the uninterrupted stream (float64 for the main path, the JAX
    chain's own uninterrupted run for the others)."""
    mesh = (2, 4)
    C, chunk, stages, x, oracle = _handoff_chains(rng)[name]
    first, second = x[:, :2 * chunk], x[:, 2 * chunk:]
    if oracle is None:
        oracle = jax_chain(mesh, stages, C, chunk).process(x).astype(np.float64)
    if direction == "jax_to_torch":
        jc = jax_chain(mesh, stages, C, chunk)
        y1 = jc.process(first)
        carries = jax.tree.map(np.asarray, jc.carries)
        y2 = run_port(pool, mesh, stages, C, chunk, second,
                      carries=carries)[0]["out"]
    else:
        res = run_port(pool, mesh, stages, C, chunk, first)
        y1 = res[0]["out"]
        jc = jax_chain(mesh, stages, C, chunk)
        for have, got in zip(jax.tree.leaves(jc.carries),
                             jax.tree.leaves(res[0]["carries"])):
            assert have.shape == got.shape and have.dtype == got.dtype
        jc.carries = jax.tree.map(
            lambda have, got: jax.device_put(got, have.sharding),
            jc.carries, res[0]["carries"])
        y2 = jc.process(second)
    half = y1.shape[1]
    assert snr_db(oracle[:, half:], y2) > 100, snr_db(oracle[:, half:], y2)
    assert snr_db(oracle, np.concatenate([y1, y2], axis=1)) > 100


def test_convert_checks_shapes_and_names(rng):
    chain = parallel.ShardedChain(
        parallel.make_mesh(1, 1),
        [parallel.FIRStage(np.ones(9)), parallel.GainStage(1.0)], 2, 64)
    with pytest.raises(ValueError, match="1 carry trees for 2 stages"):
        convert.chain_carries_from_numpy(chain, ({"tail": np.zeros((2, 8))},))
    with pytest.raises(ValueError, match="carry of shape"):
        convert.chain_carries_from_numpy(
            chain, ({"tail": np.zeros((2, 7), np.float32)}, ()))
    with pytest.raises(ValueError, match="parameters"):
        convert.chain_params_from_numpy(chain, ({"h": np.ones(9)}, {"gain": 2.0}))
    convert.chain_params_from_numpy(
        chain, ({"taps": np.r_[2.0, np.zeros(8)]}, {"gain": np.float32(3.0)}))
    x = rng.standard_normal((2, 64)).astype(np.float32)
    np.testing.assert_allclose(chain.step(x).numpy(), 6.0 * x, rtol=1e-6)
    tail = convert.chain_carries_to_numpy(chain)[0]["tail"]
    np.testing.assert_array_equal(tail, x[:, -8:])
    with pytest.raises(ValueError, match="carry tree"):
        convert.chain_carries_from_numpy(
            chain, ({"hist": np.zeros((2, 8), np.float32)}, ()))
    # stages with other carries: names, shapes and the counter's dtype
    chain = parallel.ShardedChain(
        parallel.make_mesh(1, 1),
        [parallel.IQMixStage(10000.0, 48000.0), parallel.OLSStage(np.ones(100)),
         parallel.SpectralGainStage(16, 4), parallel.DelayStage(9)], 2, 64)
    got = convert.chain_carries_to_numpy(chain)
    assert got[0]["n"].dtype == np.int32 and sorted(got[2]) == ["hist", "tail"]
    assert got[1]["zfdl"].shape == (2, 2, 4, 65) and got[3]["ring"].shape == (4, 64)
    bad = list(got)
    bad[0] = {"n": np.float32(3.0)}
    with pytest.raises(ValueError, match="carry of dtype float32"):
        convert.chain_carries_from_numpy(chain, tuple(bad))
    bad[0] = {"n": np.asarray(40, np.int32)}
    convert.chain_carries_from_numpy(chain, tuple(bad))
    assert chain.carries[0]["n"] == 40
    assert convert.chain_carries_to_numpy(chain)[0]["n"] == 40
    params = [dict(st.params) for st in chain.stages]
    params[2]["gains"] = np.full(9, 2.0)
    convert.chain_params_from_numpy(chain, tuple(params))
    assert chain.stages[2].params["gains"].dtype == np.float32
    with pytest.raises(ValueError, match="parameters"):
        convert.chain_params_from_numpy(
            chain, ({}, {"ir_spec": params[1]["ir_f"]}, params[2], params[3]))


def test_halo_primitives_on_the_pool(rng, pool):
    """halo_from_left, last_shard and the channel psum, then all_to_all, the
    cyclic shifts and broadcast_last, as each rank sees them on a 2x4 mesh,
    with the calls and bytes counted on the host."""
    t, halo = 4, 3
    x = rng.standard_normal((2, 64)).astype(np.float32)
    carried = rng.standard_normal((2, halo)).astype(np.float32)
    res = [r for r in pool.run("halo_job", timeout=JOB_LIMIT, t=t, x=x,
                               carried=carried, halo=halo) if r is not None]
    assert len(res) == 8
    n = 64 // t
    for r in res:
        ci, ti = r["position"]
        want = carried[ci] if ti == 0 else x[ci, ti * n - halo:ti * n]
        np.testing.assert_array_equal(r["left"][0], want)
        np.testing.assert_array_equal(r["last"][0], x[ci, -halo:])
        np.testing.assert_allclose(
            r["psum"][0], x[:, ti * n:(ti + 1) * n].sum(0), rtol=1e-6)
        sends = int(ti < t - 1) + int(ti > 0)
        assert r["stats"] == {"send_recv": [1, halo * 4 * sends],
                              "broadcast": [1, halo * 4],
                              "all_reduce": [1, n * 4]}
        # all_to_all: slice ti of every rank's block, in axis order
        w = n // t
        want = np.stack([x[ci:ci + 1, j * n + ti * w:j * n + (ti + 1) * w]
                         for j in range(t)])
        np.testing.assert_array_equal(r["all_to_all"], want)
        # cyclic shifts: position i receives from (i - hops) mod t; a whole
        # turn (and none) is the rank's own block and no call
        assert set(r["cyclic"]) == {1, t - 1, t, t + 1, 0}
        for hops, got in r["cyclic"].items():
            src = (ti - hops) % t
            np.testing.assert_array_equal(got[0], x[ci, src * n:(src + 1) * n])
        np.testing.assert_array_equal(r["broadcast_last"][0], x[ci, -n:])
        assert r["stats2"] == {"all_to_all": [1, n * 4],
                               "send_recv": [3, 3 * 2 * n * 4],
                               "broadcast": [1, n * 4]}
    # two ranks on the axis: a rank sends to and receives from the same peer
    res = [r for r in pool.run("halo_job", timeout=JOB_LIMIT, t=2, x=x,
                               carried=carried, halo=halo) if r is not None]
    assert len(res) == 4
    for r in res:
        ci, ti = r["position"]
        np.testing.assert_array_equal(r["cyclic"][1][0],
                                      x[ci, (1 - ti) * 32:(2 - ti) * 32])
        np.testing.assert_array_equal(r["cyclic"][2][0], x[ci, ti * 32:(ti + 1) * 32])
        np.testing.assert_array_equal(
            r["all_to_all"][:, 0], np.stack(
                [x[ci, j * 32 + ti * 16:j * 32 + (ti + 1) * 16] for j in range(2)]))


def test_the_transport_is_explicit():
    """A tensor on the wrong side of the mesh's transport raises: the
    library never moves it by another road silently."""
    import torch

    for transport, word in (("nccl", "nccl"), ("gloo+host", "gloo\\+host")):
        m = tmesh.Mesh(1, 2, 0, transport, {})
        with pytest.raises(RuntimeError, match=f"{word} transport moves CUDA"):
            m._stage_out(torch.ones(2))
    parallel.shutdown()  # an earlier test's initialize() was a no-op
    with pytest.raises(ValueError, match="transport"):
        parallel.initialize("localhost:1", num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="unknown transport"):
        tmesh._set_transport("mpi")


def test_every_stage_of_the_jax_package_constructs():
    """All 22 stage names of the JAX package exist in the port as stages
    that build; only the mesh ``Pipe`` and its ``sharded`` wrappers are
    left, and ``Pipe(mesh=...)`` goes on refusing."""
    args = {
        "GainStage": (1.0,), "FIRStage": (np.ones(3),),
        "FIRCascadeStage": ([np.ones(3), np.ones(2)],),
        "FIRResampleStage": (np.ones(3), 2, 1, 4), "ResampleStage": (2, 1, 4),
        "OLSStage": (np.ones(8),), "OLSGainStage": (np.ones(8), 2.0),
        "BiquadStage": (EQ_ROWS[0],), "BiquadCascadeStage": (np.stack(EQ_ROWS),),
        "CompressorStage": (), "LimiterStage": (), "GateStage": (),
        "DelayStage": (5,), "SpectralGainStage": (16, 4),
        "SpectralGateStage": (16, 4, 0.5), "ChannelizerStage": (4, 2),
        "IQMixStage": (1000.0,), "EnvelopeDetectorStage": (),
        "FMDiscriminatorStage": (), "MixStage": (np.ones((2, 2)),),
        "FIRGainStage": (np.ones(3), 2.0), "MixGainStage": (np.ones((2, 2)), 2.0),
    }
    names = [n for n, c in vars(jparallel.chain).items()
             if inspect.isclass(c) and issubclass(c, jparallel.chain.Stage)
             and c is not jparallel.chain.Stage and not n.startswith("_")]
    assert sorted(names) == sorted(args) and len(names) == 22
    x = np.random.default_rng(0).standard_normal((2, 64)).astype(np.float32)
    for name in names:
        st = getattr(parallel, name)(*args[name])
        assert isinstance(st, parallel.Stage)
        chain = parallel.ShardedChain(parallel.make_mesh(1, 1), [st], 2, 32)
        y = np.concatenate([chain.gather(chain.step(x[:, :32])).numpy(),
                            chain.gather(chain.step(x[:, 32:])).numpy()], axis=1)
        assert np.isfinite(y).all() and y.shape == (
            chain.out_channels, 2 * chain.out_frames), name
    assert not hasattr(parallel.chain, "_not_ported")
    # every name the JAX package exports exists in the port, the wrappers
    # of the mesh Pipe included, and a Pipe takes a mesh
    missing = set(jparallel.__all__) - set(parallel.__all__)
    assert not missing, missing
    sink = pipe_tpu_torch.mock.Sink()
    p = pipe_tpu_torch.Pipe(64, pipe_tpu_torch.Line(
        source=pipe_tpu_torch.mock.Source(channels=1, limit=64, value=2.0).source(),
        processors=[parallel.sharded.Gain(0.5).processor()],
        sink=sink.sink()), mesh=parallel.make_mesh(1, 1))
    p.start()
    p.wait(60)
    assert sink.values.shape == (1, 64) and np.all(sink.values == 1.0)


def test_a_hung_or_dead_rank_fails_its_job_within_its_limit(pool):
    """A rank that sleeps, and a rank that dies while its peers wait for it
    in a collective: the job fails at its own limit, the pool is killed,
    and the next job gets a new pool."""
    import time

    starts = pool.starts
    t0 = time.monotonic()
    with pytest.raises(PoolTimeout, match="gave no answer within 2"):
        pool.run("hang_job", timeout=2.0, seconds=120)
    assert time.monotonic() - t0 < 10
    t0 = time.monotonic()
    with pytest.raises(PoolTimeout):
        pool.run("die_job", timeout=5.0)
    assert time.monotonic() - t0 < 15
    assert pool.run("hang_job", timeout=JOB_LIMIT, seconds=0) == list(range(8))
    assert pool.starts == starts + 2
    with pytest.raises(JobError, match="AttributeError"):
        pool.run("chain_job", timeout=JOB_LIMIT, mesh=(1, 2),
                 stages=[spec("NoSuchStage")], channels=2, chunk_frames=64,
                 x=np.zeros((2, 64), np.float32))

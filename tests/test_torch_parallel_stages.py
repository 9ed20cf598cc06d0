"""The rest of the port's sharded stages against the JAX package's: twins of
the ``tests/test_parallel.py`` and ``tests/test_collectives.py`` tests of
``OLSStage``/``OLSGainStage``, the dynamics stages, ``DelayStage``, the
spectral stages, the channelizer and the demodulators, on the same seeded
inputs and at the same sizes.

The JAX ``ShardedChain`` runs in this process on the 8 virtual CPU devices;
the port's runs one process per shard in a pool of 8 gloo ranks
(``tests/torch_mesh_worker.py``), every job under its own time limit.
Tolerances: >= 100 dB (``snr_db``) against the float64 oracle of the JAX
test and between the packages unless a test states another; ``atol=2e-5``
against the streaming engines where the JAX test uses it; bit for bit
where the sharded stage evaluates in the streaming engine's order.
"""

import numpy as np
import pytest
import scipy.signal

import jax

import pipe_tpu_torch
from pipe_tpu_torch import ops, parallel
from pipe_tpu_torch.signal import snr_db
from tests.test_parallel import _echo_oracle, _envelope64
from tests.test_torch_parallel import (  # noqa: F401 - pool is a fixture
    _build_error,
    assert_100db,
    both,
    jax_chain,
    pool,
    run_port,
    spec,
)

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


def stream(x, processors, block, sample_rate=44100.0):
    """``x`` through the port's streaming engine."""
    return pipe_tpu_torch.process(x, processors, block_size=block,
                                  sample_rate=sample_rate)


def conv_oracle(x, ir):
    """Float64 causal convolution, a shared (P,) or per-channel (C, P) IR."""
    ir = np.asarray(ir, np.float64)
    rows = ir if ir.ndim == 2 else [ir] * x.shape[0]
    return np.stack([
        scipy.signal.fftconvolve(x[c].astype(np.float64), rows[c])[: x.shape[1]]
        for c in range(x.shape[0])
    ])


def decaying(rng, shape, tau):
    return rng.standard_normal(shape) * np.exp(-np.arange(shape[-1]) / tau)


# ---------------------------------------------------------------------------
# OLSStage
# ---------------------------------------------------------------------------


def test_ols_time_sharded(rng, pool):
    ir = decaying(rng, (1000,), 200.0)
    x = rng.standard_normal((2, 8192)).astype(np.float32)
    out, jout = both(pool, (1, 4), [spec("OLSStage", ir)], 2, 4096, x)
    assert_100db(conv_oracle(x, ir), out, jout)


def test_ols_per_channel_ir_sharded(rng, pool):
    C = 4
    x = rng.standard_normal((C, 4096 * 2)).astype(np.float32)
    ir = decaying(rng, (C, 500), 100.0)
    out, jout = both(pool, (2, 4), [spec("OLSStage", ir)], C, 4096, x)
    assert_100db(conv_oracle(x, ir), out, jout)


def test_ols_partitioned_fdl_ir_longer_than_local_chunk(rng, pool):
    """An IR longer than the local chunk time-shards via the partitioned
    FDL, the delay line crossing chunk AND rank boundaries (n_local = 1024,
    K = 6; three chunks)."""
    ir = decaying(rng, (6000,), 1200.0)
    x = rng.standard_normal((2, 4096 * 3)).astype(np.float32)
    res = run_port(pool, (1, 4), [spec("OLSStage", ir)], 2, 4096, x)
    jout = jax_chain((1, 4), [spec("OLSStage", ir)], 2, 4096).process(x)
    assert_100db(conv_oracle(x, ir), res[0]["out"], jout)
    # exactly the two transposes a chunk, on every rank
    for r in res:
        assert r["comm"][0]["all_to_all"][0] == 2 and len(r["comm"][0]) == 1


def test_ols_partitioned_fdl_64k_tap_config4(rng, pool):
    """BASELINE config 4's IR length: a 65,536-tap reverb, time-sharded 4
    ways with chunk 16384 (K = 16 partitions). 90 dB against the float64
    oracle, the bar of the streaming 64k-tap test; the packages agree to
    100 dB."""
    P = 65536
    ir = decaying(rng, (P,), 8000.0)
    x = rng.standard_normal((2, 16384 * 2)).astype(np.float32)
    out, jout = both(pool, (1, 4), [spec("OLSStage", ir)], 2, 16384, x)
    assert snr_db(conv_oracle(x, ir), out) > 90
    assert snr_db(jout.astype(np.float64), out) > 100


def test_ols_partitioned_per_channel_and_channel_sharded(rng, pool):
    C = 4  # n_local = 1024 -> K = 3
    ir = decaying(rng, (C, 3000), 600.0)
    x = rng.standard_normal((C, 4096 * 2)).astype(np.float32)
    out, jout = both(pool, (2, 4), [spec("OLSStage", ir)], C, 4096, x)
    assert_100db(conv_oracle(x, ir), out, jout)


@pytest.mark.parametrize("mesh", [(1, 8), (2, 4)], ids=lambda m: f"{m[0]}x{m[1]}")
def test_ols_distributed_fdl_mesh_shapes(rng, pool, mesh):
    """The bin-sharded FDL on a 1x8 and a 2x4 mesh: another T means other
    bin-slice widths (with and without bin padding) and another K."""
    ir = decaying(rng, (10000,), 2000.0)
    x = rng.standard_normal((4, 8192 * 3)).astype(np.float32)
    out, jout = both(pool, mesh, [spec("OLSStage", ir)], 4, 8192, x)
    assert_100db(conv_oracle(x, ir), out, jout)


def test_ols_partitioned_matches_streaming_engine(rng, pool):
    """Sharded partitioned-FDL output == the port's streaming UPOLS engine
    (``ops.OLSConvolve``) on the same stream, to 120 dB as the JAX test."""
    ir = decaying(rng, (5000,), 1000.0)
    x = rng.standard_normal((2, 4096 * 2)).astype(np.float32)
    out = run_port(pool, (1, 4), [spec("OLSStage", ir)], 2, 4096, x)[0]["out"]
    streamed = stream(x, [ops.OLSConvolve(ir).processor()], 512)
    assert out.shape == streamed.shape
    assert snr_db(streamed.astype(np.float64), out) > 120


@pytest.mark.parametrize("lag", [0, 1023, 1024, 2500, 5999])
def test_ols_partitioned_impulse_ir_is_a_pure_shift(rng, pool, lag):
    """One tap at a known lag: the two all_to_all reshapes put every block
    and bin slice back where it belongs, or the shift shows it. On one
    partition edge, inside a partition, and at both ends of the IR."""
    ir = np.zeros(6000)
    ir[lag] = 1.0
    x = rng.standard_normal((2, 4096 * 3)).astype(np.float32)
    out = run_port(pool, (1, 4), [spec("OLSStage", ir)], 2, 4096, x)[0]["out"]
    want = np.concatenate([np.zeros((2, lag), np.float32),
                           x[:, : x.shape[1] - lag]], axis=1)
    assert snr_db(want.astype(np.float64), out) > 120


def test_ols_gain_stage_and_live_ir_swap(rng, pool):
    """``OLSGainStage`` scales the output by its live gain, and
    ``transform_ir`` of a built stage gives the planes of a live IR swap, in
    both regimes; the planes equal the JAX stage's."""
    x = rng.standard_normal((2, 4096 * 2)).astype(np.float32)
    g = np.asarray([0.5, 2.0], np.float32)
    for P in (300, 3000):
        ir, ir2 = decaying(rng, (P,), 100.0), decaying(rng, (P,), 50.0)
        out, jout = both(pool, (1, 4), [spec("OLSGainStage", ir, g)], 2, 4096, x)
        assert_100db(g[:, None] * conv_oracle(x, ir), out, jout)
        st = parallel.OLSStage(ir)
        jst = jax_chain((1, 4), [spec("OLSStage", ir)], 2, 4096).stages[0]
        st.time_shards = 4
        st.build(2, 2, 1024)
        planes = st.transform_ir(ir2)
        np.testing.assert_array_equal(planes, np.asarray(jst.transform_ir(ir2)))
        res = run_port(pool, (1, 4), [spec("OLSStage", ir)], 2, 4096, x,
                       retune=(0, 0, "ir_f", planes))
        assert snr_db(conv_oracle(x, ir2), res[0]["out"]) > 100


# ---------------------------------------------------------------------------
# dynamics
# ---------------------------------------------------------------------------


def test_compressor_stage_time_sharded(rng, pool):
    """Time-sharded compressor vs a sequential FLOAT64 oracle."""
    C, chunk = 2, 4096
    x = (rng.standard_normal((C, chunk * 2)) * 0.8).astype(np.float32)
    st = spec("CompressorStage", threshold_db=-12.0, ratio=3.0, attack_ms=2.0,
              release_ms=60.0, sample_rate=44100.0)
    out, jout = both(pool, (1, 4), [st], C, chunk, x)
    env = _envelope64(x, attack_ms=2.0, release_ms=60.0)
    env_db = 20.0 * np.log10(np.maximum(env, 1e-8))
    over = np.maximum(env_db - (-12.0), 0.0)
    oracle = x.astype(np.float64) * 10.0 ** ((-over * (1.0 - 1.0 / 3.0)) / 20.0)
    assert_100db(oracle, out, jout)
    # the port's streaming engine computes the same envelope
    streamed = stream(x, [ops.Compressor(-12.0, 3.0, 2.0, 60.0).processor()], 512)
    assert snr_db(streamed.astype(np.float64), out) > 100


def test_gate_and_limiter_stages_match_float64(rng, pool):
    """Sharded gate/limiter vs sequential FLOAT64 oracles; the gate's hard
    threshold is compared with a guard band, since an eps-level envelope
    difference can legally flip a sample sitting on the threshold."""
    C, chunk = 2, 4096
    x = (rng.standard_normal((C, chunk * 2)) * 0.5).astype(np.float32)
    x[:, 3000:6000] *= 0.01  # bursty, so the gate opens and closes
    gate = spec("GateStage", threshold_db=-30.0, range_db=60.0, attack_ms=1.0,
                release_ms=80.0, sample_rate=44100.0)
    gy, jgy = both(pool, (1, 4), [gate], C, chunk, x)
    env = _envelope64(x, attack_ms=1.0, release_ms=80.0)
    env_db = 20.0 * np.log10(np.maximum(env, 1e-8))
    g = np.where(env_db >= -30.0, 1.0, 10.0 ** (-60.0 / 20.0))
    decided = np.abs(env_db - (-30.0)) > 1e-3
    assert (g < 1).any() and (g == 1).any()  # it did both
    np.testing.assert_allclose(
        gy[decided], (x.astype(np.float64) * g)[decided], atol=3e-6)
    np.testing.assert_allclose(gy[decided], jgy[decided], atol=3e-6)

    lim = spec("LimiterStage", threshold_db=-6.0, attack_ms=0.5,
               release_ms=40.0, sample_rate=44100.0)
    ly, jly = both(pool, (1, 4), [lim], C, chunk, x)
    env2 = _envelope64(x, attack_ms=0.5, release_ms=40.0)
    over = np.maximum(20.0 * np.log10(np.maximum(env2, 1e-8)) - (-6.0), 0.0)
    assert_100db(x.astype(np.float64) * 10.0 ** (-over / 20.0), ly, jly)


def test_envelope_stages_ignore_the_precision_knob(rng):
    """A recursive path: no product goes through ``config.matmul``, so the
    three precision names give the same bits."""
    x = (rng.standard_normal((2, 2048)) * 0.8).astype(np.float32)
    outs = []
    for name in ("highest", "high", "default"):
        with pipe_tpu_torch.config.matmul_precision_scope(name):
            chain = parallel.ShardedChain(
                parallel.make_mesh(1, 1),
                [parallel.CompressorStage(-12.0, 3.0),
                 parallel.DelayStage(300, feedback=0.5)], 2, 1024)
            outs.append(chain.process(x))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


# ---------------------------------------------------------------------------
# DelayStage
# ---------------------------------------------------------------------------


def _delay(pool, mesh, C, chunk, x, D, **kw):
    """``(port out, JAX out, the port's stage as built here)``."""
    st = spec("DelayStage", D, **kw)
    out, jout = both(pool, mesh, [st], C, chunk, x)
    here = parallel.DelayStage(D, **kw)
    here.time_shards = mesh[1]
    here.build(C, C // mesh[0], chunk // mesh[1])
    return out, jout, here


def test_delay_stage_pure_time_sharded(rng, pool):
    """Pure delay: the tap is one exact slice from the left neighbour. The
    output equals the port's streaming ``Delay`` bit for bit."""
    D = 300  # does not divide n_local=1024 -> pure-delay regime
    x = rng.standard_normal((2, 4096 * 2)).astype(np.float32)
    out, jout, st = _delay(pool, (1, 4), 2, 4096, x, D, wet=1.0, dry=0.25)
    assert not st.can_feedback and not st._ladder and not st._wave
    assert_100db(_echo_oracle(x, D, 0.0, 1.0, 0.25), out, jout, bar=130)
    streamed = stream(x, [ops.Delay(D, wet=1.0, dry=0.25).processor()], 4096)
    np.testing.assert_array_equal(out, streamed)


def test_delay_stage_feedback_echo_cross_device(rng, pool):
    """Feedback echo: the block recurrence crosses rank boundaries via the
    affine prefix ladder (s[n] = x[n] + fb*s[n-D])."""
    D, fb = 256, 0.6
    x = rng.standard_normal((2, 4096 * 3)).astype(np.float32)
    out, jout, st = _delay(pool, (1, 4), 2, 4096, x, D, feedback=fb, wet=0.8,
                           dry=0.5)
    assert st.can_feedback and st._ladder
    assert_100db(_echo_oracle(x, D, fb, 0.8, 0.5), out, jout, bar=110)


def test_delay_stage_feedback_non_dividing_delay(rng, pool):
    """D=300 on n_local=1024 (D does not divide the local chunk): the
    rotated-affine history transfer crosses rank AND chunk boundaries; a
    negative feedback exercises the signed integer power."""
    x = rng.standard_normal((2, 4096 * 3)).astype(np.float32)
    for fb in (0.6, -0.6):
        out, jout, st = _delay(pool, (1, 4), 2, 4096, x, 300, feedback=fb,
                               wet=0.8, dry=0.5)
        assert st._ladder
        assert_100db(_echo_oracle(x, 300, fb, 0.8, 0.5), out, jout, bar=110)


def test_delay_stage_pure_delay_longer_than_local_chunk(rng, pool):
    """D=5000 > chunk: a multi-hop exact-slice fetch from the block ring;
    D >= chunk makes feedback structurally free."""
    D = 5000
    x = rng.standard_normal((2, 4096 * 3)).astype(np.float32)
    out, jout, st = _delay(pool, (1, 4), 2, 4096, x, D, wet=1.0, dry=0.25)
    assert st.can_feedback and not st._ladder and not st._wave
    assert_100db(_echo_oracle(x, D, 0.0, 1.0, 0.25), out, jout, bar=130)


def test_delay_stage_feedback_longer_than_local_chunk(rng, pool):
    """Feedback echo with n_local=1024 < D=2500 < chunk: the wave-DAG. It
    evaluates in the sequential order, so it equals the port's streaming
    ``Delay`` bit for bit."""
    D, fb = 2500, 0.55
    x = rng.standard_normal((2, 4096 * 3)).astype(np.float32)
    out, jout, st = _delay(pool, (1, 4), 2, 4096, x, D, feedback=fb, wet=1.0,
                           dry=0.0)
    assert st._wave
    assert_100db(_echo_oracle(x, D, fb, 1.0, 0.0), out, jout, bar=110)
    streamed = stream(x, [ops.Delay(D, feedback=fb, wet=1.0, dry=0.0)
                          .processor()], 512)
    np.testing.assert_array_equal(out, streamed)


def test_delay_stage_feedback_high_fb_long_stream_floor(rng, pool):
    """fb=0.9 over 16 chunks on an 8-way time mesh: the ladder's three
    rounds and the rotated transfer hold 120 dB."""
    D, fb = 300, 0.9
    x = rng.standard_normal((1, 4096 * 16)).astype(np.float32)
    out, jout, _ = _delay(pool, (1, 8), 1, 4096, x, D, feedback=fb, wet=0.7,
                          dry=0.3)
    assert_100db(_echo_oracle(x, D, fb, 0.7, 0.3), out, jout, bar=120)


@pytest.mark.parametrize("D,fb,bar", [
    (700, 0.0, 100), (5000, 0.0, 100), (6000, 0.6, 110), (2500, 0.55, 110),
], ids=["one-hop-pure", "multi-hop-pure", "ring-feedback", "wave-dag"])
def test_delay_block_ring_parity_2x4_mesh(rng, pool, D, fb, bar):
    """The time-sharded block ring on the 2x4 (channels x time) mesh in
    every regime: the fetches ride the time axis while channels shard
    orthogonally."""
    chunk = 4096  # n_local = 1024
    x = rng.standard_normal((4, chunk * 4)).astype(np.float32)
    kw = dict(feedback=fb, wet=0.8, dry=0.5) if fb else dict(wet=1.0, dry=0.25)
    out, jout, st = _delay(pool, (2, 4), 4, chunk, x, D, **kw)
    assert st._wave == (D == 2500)
    assert_100db(_echo_oracle(x, D, fb, kw["wet"], kw["dry"]), out, jout, bar=bar)


def test_delay_contradictory_feedback_args_rejected():
    with pytest.raises(ValueError, match="contradictory"):
        parallel.DelayStage(300, feedback=0.5, allow_feedback=False)
    with pytest.raises(ValueError, match="delay_frames"):
        parallel.DelayStage(0)


def test_delay_stage_allow_feedback_live_retune(rng, pool):
    """``allow_feedback=True`` builds the recurrence with fb=0; a live
    ``feedback`` parameter then turns the echo on between chunks."""
    D = 300
    x = rng.standard_normal((2, 4096 * 2)).astype(np.float32)
    st = spec("DelayStage", D, allow_feedback=True)
    res = run_port(pool, (1, 4), [st], 2, 4096, x[:, :4096])
    assert snr_db(_echo_oracle(x[:, :4096], D, 0.0, 1.0, 0.0), res[0]["out"]) > 100
    # fb=0 for one chunk, 0.4 from the second: the oracle switches with it
    out = run_port(pool, (1, 4), [st], 2, 4096, x,
                   retune=(1, 0, "feedback", np.float32(0.4)))[0]["out"]
    s = np.zeros((2, x.shape[1] + D))
    for n in range(x.shape[1]):
        s[:, D + n] = x[:, n] + (0.4 if n >= 4096 else 0.0) * s[:, n]
    assert snr_db(s[:, : x.shape[1]], out) > 110
    out2, jout2 = both(pool, (1, 4), [spec("DelayStage", D, feedback=0.4)],
                       2, 4096, x)
    assert_100db(_echo_oracle(x, D, 0.4, 1.0, 0.0), out2, jout2, bar=110)


# ---------------------------------------------------------------------------
# spectral
# ---------------------------------------------------------------------------


def test_spectral_gain_stage_time_sharded(rng, pool):
    """Time-sharded STFT engine == the sequential streaming engine:
    analysis-history halo left->right, OLA spill to the right neighbour,
    both carries across chunks."""
    W, H = 256, 64
    x = rng.standard_normal((2, 8192)).astype(np.float32)
    gains = rng.uniform(0.0, 1.5, W // 2 + 1).astype(np.float32)
    out, jout = both(pool, (1, 4), [spec("SpectralGainStage", W, H, gains)],
                     2, 4096, x)
    seq = stream(x, [ops.SpectralGain(W, H, gains).processor()], 512)
    assert out.shape == seq.shape
    np.testing.assert_allclose(out, seq, atol=2e-5)
    np.testing.assert_allclose(out, jout, atol=2e-5)
    assert snr_db(jout.astype(np.float64), out) > 100


def test_spectral_gain_stage_channel_and_time_sharded(rng, pool):
    """Per-channel bin curves shard over the channel axis; unity gains give
    perfect reconstruction (delayed by W-hop) through a 2x4 mesh."""
    W, H = 256, 64
    x = rng.standard_normal((8, 4096)).astype(np.float32)
    gains = np.ones((8, W // 2 + 1), np.float32)
    out, jout = both(pool, (2, 4), [spec("SpectralGainStage", W, H, gains),
                                    spec("GainStage", 0.5)], 8, 2048, x)
    L = W - H
    assert_100db(0.5 * x[:, : 4096 - L].astype(np.float64), out[:, L:],
                 jout[:, L:])


def test_spectral_gate_stage_matches_streaming(rng, pool):
    """Sharded gate == streaming SpectralGate output on the same signal."""
    W, H, sr, n = 256, 64, 8000.0, 4096
    t = np.arange(n) / sr
    x = (np.sin(2 * np.pi * 500.0 * t)
         + 0.01 * rng.standard_normal(n)).astype(np.float32)[None, :]
    thr, red, knee = 0.5, -60.0, 6.0
    out, jout = both(pool, (1, 4),
                     [spec("SpectralGateStage", W, H, thr, red, knee)],
                     1, 2048, x)
    seq = stream(x, [ops.SpectralGate(W, H, thr, red, knee).processor()], 512,
                 sample_rate=sr)
    np.testing.assert_allclose(out, seq, atol=2e-5)
    np.testing.assert_allclose(out, jout, atol=2e-5)


def test_spectral_stage_validation(pool):
    for stage, chunk, match in (
            (spec("SpectralGainStage", 512, 128), 4 * 200, "multiple of hop"),
            (spec("SpectralGainStage", 2048, 512), 4 * 1024, "halo 1536"),
    ):
        mro, msg = _build_error(pool, (1, 4), [stage], 2, chunk)
        assert "ShapeConstraintError" in mro and "ValueError" in mro
        assert match in msg
        with pytest.raises(ValueError, match=match):
            jax_chain((1, 4), [stage], 2, chunk)
    with pytest.raises(ValueError, match="gains must be"):
        parallel.SpectralGainStage(256, 64, np.ones(5))


# ---------------------------------------------------------------------------
# channelizer and demodulators
# ---------------------------------------------------------------------------


def test_channelizer_stage_matches_streaming(rng, pool):
    """Sharded polyphase filterbank == the streaming Channelizer on the
    same stream (history halo correctness)."""
    K = 8
    x = rng.standard_normal((2, 4096 * 2)).astype(np.float32)
    out, jout = both(pool, (1, 4),
                     [spec("ChannelizerStage", K, taps_per_branch=8)],
                     2, 4096, x)
    seq = stream(x, [ops.Channelizer(K, taps_per_branch=8).processor()], 512,
                 sample_rate=48000.0)
    assert out.shape == seq.shape == (2 * 2 * (K // 2 + 1), 8192 // K)
    np.testing.assert_allclose(out, seq, atol=2e-5)
    assert snr_db(jout.astype(np.float64), out) > 100


def _fm_signal(n, sr, carrier):
    t = np.arange(n) / sr
    phase = 2 * np.pi * carrier * t + 2.0 * np.sin(2 * np.pi * 1000.0 * t)
    return np.cos(phase).astype(np.float32)[None, :], t


def test_fm_receiver_chain_time_sharded(rng, pool):
    """IQ mix -> lowpass FIR -> FM discriminator, time-sharded, vs the
    streaming demod chain: the exact-phase oscillator offsets per rank and
    the one-sample discriminator halo must line up globally."""
    sr, n = 48000.0, 4096 * 2
    x, t = _fm_signal(n, sr, 12000.0)
    h = np.asarray(ops.design_lowpass(63, 4000, sr))
    stages = [spec("IQMixStage", 12000.0, sample_rate=sr), spec("FIRStage", h),
              spec("FMDiscriminatorStage")]
    out, jout = both(pool, (1, 4), stages, 1, 4096, x)
    seq = stream(x, ops.fm_demod_factory(12000.0, h), 512, sample_rate=sr)
    assert out.shape == seq.shape
    np.testing.assert_allclose(out, seq, atol=2e-5)
    np.testing.assert_allclose(out, jout, atol=2e-5)
    # and it demodulates: the deviation is 2000*cos(2*pi*1000*t), delayed
    # by the FIR's group delay
    settle, gd = 2000, (len(h) - 1) // 2
    expected = np.cos(2 * np.pi * 1000.0 * (t - gd / sr))
    d = out[0, settle:] - out[0, settle:].mean()
    m = expected[settle:] - expected[settle:].mean()
    assert float(np.dot(d, m) / (np.linalg.norm(d) * np.linalg.norm(m))) > 0.95


def test_am_envelope_chain_channel_and_time_sharded(rng, pool):
    """IQ mix -> FIR -> envelope detector over a 2x4 mesh == streaming AM
    demod (per-shard I/Q pairing stays consistent under channel sharding).
    The carrier's period (24 samples) does not divide the chunk, so the
    carried sample index moves."""
    sr, C, n = 48000.0, 2, 4096 * 2
    t = np.arange(n) / sr
    msg = 0.5 * (1.0 + 0.6 * np.sin(2 * np.pi * 800.0 * t))
    x = (msg * np.cos(2 * np.pi * 10000.0 * t)).astype(np.float32)
    x = np.stack([x, 0.7 * x])
    h = np.asarray(ops.design_lowpass(63, 3000, sr))
    stages = [spec("IQMixStage", 10000.0, sample_rate=sr), spec("FIRStage", h),
              spec("EnvelopeDetectorStage")]
    res = run_port(pool, (2, 4), stages, C, 4096, x)
    out = res[0]["out"]
    jout = jax_chain((2, 4), stages, C, 4096).process(x)
    seq = stream(x, ops.am_demod_factory(10000.0, h), 512, sample_rate=sr)
    assert out.shape == seq.shape
    np.testing.assert_allclose(out, seq, atol=2e-5)
    np.testing.assert_allclose(out, jout, atol=2e-5)
    n_carry = res[0]["carries"][0]["n"]
    assert n_carry.dtype == np.int32 and n_carry.shape == ()
    assert int(n_carry) == (2 * 4096) % 24 != 0
    assert all(r["local_carries"][0]["n"].dtype == np.int32 for r in res)


def test_positional_stages_refuse_padded_channel_counts(pool):
    """``channel_pad_safe = False``: 3 channels on a 2-wide channel axis
    would be padded, and the I/Q rail layout is positional."""
    for stages in ([spec("IQMixStage", 1000.0)],
                   [spec("GainStage", 1.0), spec("EnvelopeDetectorStage")],
                   [spec("FMDiscriminatorStage")]):
        mro, msg = _build_error(pool, (2, 2), stages, 3, 1024)
        assert "ValueError" in mro and "positional channel layout" in msg
        with pytest.raises(ValueError, match="positional channel layout"):
            jax_chain((2, 2), stages, 3, 1024)
    # unpaired rails, and the channelizer's shape rules: global shapes only
    for stages, chunk, match in (
            ([spec("FMDiscriminatorStage")], 1024, "paired I/Q"),
            ([spec("EnvelopeDetectorStage")], 1024, "paired I/Q"),
            ([spec("ChannelizerStage", 8)], 2 * 1020, "multiple of K=8"),
            ([spec("ChannelizerStage", 8, 16)], 2 * 64, "halo 128"),
    ):
        mro, msg = _build_error(pool, (2, 2), stages, 2, chunk)
        assert "ValueError" in mro and match in msg, msg
    with pytest.raises(ValueError, match="even"):
        parallel.ChannelizerStage(7)


# ---------------------------------------------------------------------------
# exact collective counts: twins of tests/test_collectives.py
# ---------------------------------------------------------------------------

T4, C_LOCAL, N_LOCAL = 4, 8, 8192  # a 2x4 mesh, 16 channels, chunk 32768


def _p2p(ti, hops, cyclic=False):
    """Sends plus receives of one shift at time index ``ti``."""
    if cyclic:
        return 2
    return int(ti + hops < T4) + int(ti - hops >= 0)


def _halo(width, n=1):
    """``n`` one-hop halos of ``width`` samples a row."""
    return lambda ti: [n, n * C_LOCAL * width * 4 * _p2p(ti, 1)]


def _cyclic(widths):
    """Cyclic shifts moving ``widths`` samples a row in all."""
    return lambda ti: [len(widths), C_LOCAL * sum(widths) * 4 * 2]


COMM_CASES = {
    "gain": (lambda: spec("GainStage", 0.5), {}),
    # two spectrum transposes of (T, 2, C, ceil(8193/4)) floats
    "ols_64k_distributed_fdl": (
        lambda: spec("OLSStage", decaying(np.random.default_rng(0), (65536,), 8000.0)),
        {"all_to_all": lambda ti: [2, 2 * T4 * 2 * C_LOCAL * 2049 * 4]}),
    # P <= n_local: one halo and one carry broadcast of P samples
    "ols_single_fft": (
        lambda: spec("OLSStage", decaying(np.random.default_rng(0), (1000,), 200.0)),
        {"send_recv": _halo(1000),
         "broadcast": lambda ti: [1, C_LOCAL * 1000 * 4]}),
    # three prefixes of (a, u) per channel, the one-sample halo, two carries
    "compressor": (
        lambda: spec("CompressorStage"),
        {"all_gather": lambda ti: [3, 3 * T4 * 2 * C_LOCAL * 4],
         "send_recv": _halo(1),
         "broadcast": lambda ti: [2, C_LOCAL * 3 * 4]}),
    # analysis history and OLA spill, each a halo and a carry of W - hop
    "spectral_gain": (
        lambda: spec("SpectralGainStage", 1024, 256),
        {"send_recv": _halo(768, 2),
         "broadcast": lambda ti: [2, 2 * C_LOCAL * 768 * 4]}),
    # pure tap inside one block: one D-wide slice, one hop
    "delay_pure_300": (lambda: spec("DelayStage", 300, wet=1.0),
                       {"send_recv": _cyclic([300])}),
    "delay_pure_5000": (lambda: spec("DelayStage", 5000, wet=1.0),
                        {"send_recv": _cyclic([5000])}),
    # multi-hop: two exact slices, n samples in all
    "delay_pure_20000_multihop": (
        lambda: spec("DelayStage", 20000, wet=1.0),
        {"send_recv": _cyclic([3616, 4576])}),
    # ladder: the seed shift and log2(T) rounds of (C, D) offsets, then the
    # exit history from the last rank
    "delay_feedback_300": (
        lambda: spec("DelayStage", 300, feedback=0.5),
        {"send_recv": lambda ti: [3, C_LOCAL * 300 * 4 * (
            2 * _p2p(ti, 1) + _p2p(ti, 2))],
         "broadcast": lambda ti: [1, C_LOCAL * 300 * 4]}),
    "delay_feedback_5000": (
        lambda: spec("DelayStage", 5000, feedback=0.5),
        {"send_recv": lambda ti: [3, C_LOCAL * 5000 * 4 * (
            2 * _p2p(ti, 1) + _p2p(ti, 2))],
         "broadcast": lambda ti: [1, C_LOCAL * 5000 * 4]}),
    # wave-DAG: W = ceil(N/D) waves of two exact slices, n samples each
    "delay_feedback_12000_wave": (
        lambda: spec("DelayStage", 12000, feedback=0.5),
        {"send_recv": _cyclic([3808, 4384] * 3)}),
    "delay_feedback_22937_wave": (
        lambda: spec("DelayStage", 22937, feedback=0.5),
        {"send_recv": _cyclic([6553, 1639] * 2)}),
    # D >= chunk: free feedback; the aligned piece is the rank's own slot
    "delay_feedback_40000": (
        lambda: spec("DelayStage", 40000, feedback=0.5),
        {"send_recv": _cyclic([7232])}),
}


@pytest.mark.parametrize("name", COMM_CASES)
def test_stage_collective_counts(pool, name):
    """Every collective of one chunk step, per stage and rank, as exact
    calls and payload bytes from ``ShardedChain.last_comm``: a stage that
    starts to over-communicate fails here."""
    stage_of, want = COMM_CASES[name]
    x = np.zeros((16, T4 * N_LOCAL), np.float32)
    res = run_port(pool, (2, T4), [stage_of()], 16, T4 * N_LOCAL, x)
    for r in res:
        ti = r["position"][1]
        assert r["comm"][0] == {k: f(ti) for k, f in want.items()}, (name, ti)
        payload = C_LOCAL * N_LOCAL * 4
        # the JAX package's bound on bytes over payload holds here too (its
        # convention counts what a rank receives; a shift here counts both
        # directions)
        if name == "ols_64k_distributed_fdl":
            assert r["comm"][0]["all_to_all"][1] / payload <= 4.5


def test_delay_ring_carry_is_time_sharded(pool):
    """The Delay block ring stays time-sharded (memory /T), on the stage as
    built and on every rank of a running chain."""
    for D, fb in ((20000, 0.0), (40000, 0.5)):
        st = parallel.DelayStage(D, feedback=fb, wet=1.0)
        st.time_shards = 4
        st.build(16, 8, 8192)
        assert st.carry_spec["ring"].axes == (parallel.CH_AXIS, parallel.TIME_AXIS)
        kc = -(-D // 32768)
        assert st.carry["ring"].shape == (16, kc * 32768)
        res = run_port(pool, (2, 4), [spec("DelayStage", D, feedback=fb, wet=1.0)],
                       16, 32768, np.zeros((16, 32768), np.float32))
        for r in res:
            assert r["local_carries"][0]["ring"].shape == (8, kc * 8192)
        assert res[0]["carries"][0]["ring"].shape == (16, kc * 32768)
    # D < chunk with feedback: the replicated history is bounded by D
    st = parallel.DelayStage(5000, feedback=0.5)
    st.time_shards = 4
    st.build(16, 8, 8192)
    assert st.carry["hist"].shape == (16, 5000)


def test_ols_distributed_fdl_carry_is_sharded(pool):
    """The FDL carry and the partition spectra stay bin-sharded (memory
    /T)."""
    st = parallel.OLSStage(np.ones(65536, np.float32))
    st.time_shards = 4
    st.build(16, 8, 8192)
    assert st.carry_spec["zfdl"].axes == (
        None, None, parallel.CH_AXIS, parallel.TIME_AXIS)
    assert st._K == 8 and st.carry["zfdl"].shape == (8, 2, 16, 4 * 2049)
    assert st.params["ir_f"].shape == (2, 9, 4 * 2049)
    res = run_port(pool, (2, 4), [spec("OLSStage", np.ones(65536, np.float32))],
                   16, 32768, np.zeros((16, 32768), np.float32))
    for r in res:
        assert r["local_carries"][0]["zfdl"].shape == (8, 2, 8, 2049)

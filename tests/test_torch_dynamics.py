"""The port's dynamics ops (delay/echo, compressor, gate) and the ``lax``
primitives they lean on, against the JAX package and float64 oracles.

- The clamp helpers match ``lax.dynamic_slice``/``dynamic_update_slice``
  exactly, including negative and overflowing starts; the prefix scan
  matches ``lax.associative_scan`` to float32 rounding (its combine tree
  differs).
- JAX-vs-port: the same seeded blocks, with a mid-stream partial block,
  through the JAX op and, from JAX's state carried with ``convert``, the
  port's: >= 100 dB on the output and on every float state leaf, integer
  state (the ring's ``pos``) equal.
- The twins of ``tests/test_dynamics.py``, at the same bars against the
  same float64 oracles.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch
from jax import lax

import pipe_tpu_torch
from pipe_tpu import ops as jops
from pipe_tpu.ops import dynamics as jdyn
from pipe_tpu_torch import mock, mutable, ops, optimize
from pipe_tpu_torch.graph import Line
from pipe_tpu_torch.ops import dynamics as tdyn, prims
from pipe_tpu_torch.ops.biquad import _two_sum
from pipe_tpu_torch.signal import Signal, SignalProperties, snr_db
from tests.test_torch_ops import (
    assert_twins_agree,
    step_twins,
    stream,
    stream_chunks,
)

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

SNR_TARGET = 100.0


def stream_through(procs, x, block, sr=44100.0):
    return stream(pipe_tpu_torch, procs, x, block, sr)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# -- the lax primitives --------------------------------------------------------


@pytest.mark.parametrize("width", [1, 5, 24])
def test_dynamic_slices_clamp_like_lax(width):
    rng = np.random.default_rng(width)
    x = rng.standard_normal((3, 24)).astype(np.float32)
    upd = rng.standard_normal((3, width)).astype(np.float32)
    starts = [-40, -24, -1, 0, 7, 24 - width, 25 - width, 23, 60]
    starts += [int(s) for s in rng.integers(-50, 50, 12)]
    for start in starts:
        ref = np.asarray(lax.dynamic_slice(jnp.asarray(x), (0, start),
                                           (3, width)))
        got = prims.dynamic_slice(_t(x), start, width).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=f"slice {start}")
        ref = np.asarray(lax.dynamic_update_slice(
            jnp.asarray(x), jnp.asarray(upd), (0, start)))
        tx = _t(x).clone()
        got = prims.dynamic_update_slice_(tx, _t(upd), start)
        assert got is tx  # in place
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"update {start}")


@pytest.mark.parametrize("combine", ["affine", "max_decay"])
@pytest.mark.parametrize("n", [1, 7, 512])
def test_prefix_scan_matches_associative_scan(combine, n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 0.999, (3, n)).astype(np.float32)
    u = rng.standard_normal((3, n)).astype(np.float32)
    if combine == "max_decay":
        u = np.abs(u)
    jfn = getattr(jdyn, f"_{combine}_combine" if combine == "max_decay"
                  else "_affine1_combine")
    tfn = getattr(tdyn, f"_{combine}_combine" if combine == "max_decay"
                  else "_affine1_combine")
    ja, ju = lax.associative_scan(jfn, (jnp.asarray(a), jnp.asarray(u)),
                                  axis=1)
    ta, tu = prims.prefix_scan(tfn, (_t(a), _t(u)))
    assert snr_db(np.asarray(ja), ta.numpy()) > 130
    assert snr_db(np.asarray(ju), tu.numpy()) > 130


# -- JAX vs port ---------------------------------------------------------------


@pytest.mark.parametrize(
    "make, B",
    [
        (lambda o: o.Delay(600, feedback=0.5, wet=0.8, dry=0.3), 256),
        (lambda o: o.Delay(100, feedback=0.6, wet=0.7, dry=0.3), 256),
        (lambda o: o.Delay(100, wet=0.5, dry=0.5), 256),
        (lambda o: o.Compressor(-15.0, 4.0, attack_ms=20.0, release_ms=80.0), 256),
        (lambda o: o.NoiseGate(threshold_db=-3.0, attack_ms=2.0, release_ms=20.0), 256),
    ],
    ids=["delay-ring-feedback", "delay-scan-feedback", "delay-hist",
         "compressor", "noise-gate"],
)
def test_dynamics_match_jax(make, B):
    """The envelope state (2 values a channel) tracks a decay whose
    coefficient comes from float32 ``exp``/``expm1``, which XLA and torch
    may round an ulp apart; over a few hundred samples of decay that moves
    it ~1e-5 relative, so the state is held at 90 dB while the output
    keeps the 100 dB bar. The smoothed envelope's dd low word is compared
    as part of its float64 sum with the high word (alone it is rounding
    noise)."""
    chunks = [B, B, 77, B, B, 131, B]
    jout, tout, js, ts = step_twins(make(jops), make(ops), 2, B, chunks,
                                    switch=3)
    for st in (js, ts):
        if "env_lo" in st:
            env = st["env"].astype(np.float64)
            env[:, 1] += st.pop("env_lo")
            st["env"] = env
    assert_twins_agree(jout, tout, js, ts, state_db=90.0)


def test_envelope_block_matches_jax():
    rng = np.random.default_rng(3)
    x = np.abs(rng.standard_normal((2, 700))).astype(np.float32)
    env0 = rng.uniform(0, 1, (2, 2)).astype(np.float32)
    lo = (1e-9 * rng.standard_normal(2)).astype(np.float32)
    rc, oma = np.float32(0.998), np.float32(3e-4)
    j0, jlo, jenv = jax.jit(jdyn.envelope_block)(
        jnp.asarray(env0), jnp.asarray(x), jnp.int32(650), jnp.asarray(rc),
        jnp.asarray(oma), jnp.asarray(lo))
    t0, tlo, tenv = tdyn.envelope_block(_t(env0), _t(x), 650, _t(rc),
                                        _t(oma), _t(lo))
    assert snr_db(np.asarray(jenv), tenv.numpy()) > 120
    assert snr_db(np.asarray(j0), t0.numpy()) > 120


# -- twins of tests/test_dynamics.py -------------------------------------------


def _envelope_oracle(x_abs, rc, ac, raw0=0.0, env0=0.0):
    """Sequential float64 envelope: release max-decay + attack one-pole."""
    raw = np.zeros_like(x_abs, dtype=np.float64)
    env = np.zeros_like(x_abs, dtype=np.float64)
    r, e = raw0, env0
    for n in range(x_abs.shape[-1]):
        r = max(x_abs[..., n], rc * r)
        e = ac * e + (1.0 - ac) * r
        raw[..., n], env[..., n] = r, e
    return raw, env


def _envelope64(x, attack_ms, release_ms, sr=44100.0):
    """Sequential float64 envelope with true float64 coefficients."""
    rc = np.exp(-1000.0 / (release_ms * sr))
    ac = np.exp(-1000.0 / (attack_ms * sr))
    xa = np.abs(x.astype(np.float64))
    env = np.zeros_like(xa)
    r = np.zeros(x.shape[0])
    e = np.zeros(x.shape[0])
    for n in range(x.shape[1]):
        r = np.maximum(xa[:, n], rc * r)
        e = ac * e + (1.0 - ac) * r
        env[:, n] = e
    return env


def _echo_oracle(x, D, fb, wet, dry):
    s = np.zeros(x.shape[1])
    out = np.zeros(x.shape[1])
    for n in range(x.shape[1]):
        dtap = s[n - D] if n >= D else 0.0
        s[n] = x[0, n] + fb * dtap
        out[n] = dry * x[0, n] + wet * dtap
    return out


def _delayed(x, D):
    oracle = np.zeros_like(x, dtype=np.float64)
    oracle[:, D:] = x[:, :-D]
    return oracle


def test_pure_delay(rng):
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    y = stream_through([ops.Delay(300).processor()], x, 512)
    assert snr_db(_delayed(x, 300), y) >= SNR_TARGET


def test_delay_wet_dry_mix(rng):
    x = rng.standard_normal((1, 2048)).astype(np.float32)
    y = stream_through([ops.Delay(100, wet=0.4, dry=0.6).processor()], x, 256)
    oracle = 0.6 * x + 0.4 * _delayed(x, 100)
    assert snr_db(oracle, y) >= SNR_TARGET


def test_pure_delay_ring_unaligned(rng):
    """D >= block with D % block != 0: the ring write wraps mid-block, and
    the clamped third write keeps the low canonical slots fresh."""
    x = rng.standard_normal((2, 16384)).astype(np.float32)
    y = stream_through([ops.Delay(600).processor()], x, 512)
    assert snr_db(_delayed(x, 600), y) >= SNR_TARGET


def test_pure_delay_ring_mastering_shape(rng):
    D = 11025
    x = rng.standard_normal((1, 3 * D + 640)).astype(np.float32)
    y = stream_through([ops.Delay(D, wet=1.0, dry=0.0).processor()], x, 512)
    assert snr_db(_delayed(x, D), y) >= SNR_TARGET


def test_pure_delay_ring_partial_midstream_block(rng):
    """A short mid-stream chunk advances pos by a non-block stride: every
    later write wraps at a new residue."""
    chunks = [512, 300, 512, 512, 129, 512, 512, 512, 77]
    x = rng.standard_normal((2, sum(chunks))).astype(np.float32)
    y = stream_chunks(pipe_tpu_torch, [ops.Delay(1024).processor()], x, 512,
                      chunks)
    assert y.shape == x.shape
    assert snr_db(_delayed(x, 1024), y) >= SNR_TARGET


def test_feedback_echo_ring_unaligned(rng):
    x = rng.standard_normal((1, 16384)).astype(np.float32)
    d = ops.Delay(600, feedback=0.5, wet=1.0, dry=0.3)
    y = stream_through([d.processor()], x, 512)
    assert snr_db(_echo_oracle(x, 600, 0.5, 1.0, 0.3), y[0]) >= 110


def test_feedback_echo(rng):
    N, D = 8192, 1024
    x = np.zeros((1, N), np.float32)
    x[:, 0] = 1.0  # impulse -> echoes at D, 2D, 3D...
    y = stream_through([ops.Delay(D, feedback=0.5, wet=1.0, dry=1.0)
                        .processor()], x, 512)
    out = _echo_oracle(x, D, 0.5, 1.0, 1.0)
    assert snr_db(out, y[0]) >= SNR_TARGET
    assert out[D] == pytest.approx(1.0)
    assert out[2 * D] == pytest.approx(0.5)
    assert out[3 * D] == pytest.approx(0.25)


def test_feedback_echo_short_delay(rng):
    """D < block: the in-block recurrence runs as lane-parallel scans."""
    x = rng.standard_normal((1, 8192)).astype(np.float32)
    d = ops.Delay(100, feedback=0.6, wet=0.7, dry=0.3)
    y = stream_through([d.processor()], x, 512)
    assert snr_db(_echo_oracle(x, 100, 0.6, 0.7, 0.3), y[0]) >= 110


def test_feedback_echo_short_delay_partial_final_block(rng):
    x = rng.standard_normal((1, 512 * 3 + 77)).astype(np.float32)
    y = stream_through([ops.Delay(130, feedback=0.5).processor()], x, 512)
    assert y.shape == x.shape
    assert snr_db(_echo_oracle(x, 130, 0.5, 1.0, 0.0), y[0]) >= 110


def test_feedback_echo_high_fb_long_stream_floor(rng):
    """fb=0.95 over 256 blocks: each lane is revisited only every D
    samples, so the per-visit rounding is unamplified; the JAX suite's
    bar is 125 dB."""
    C, N, D, fb = 1, 131072, 100, 0.95
    x = rng.standard_normal((C, N)).astype(np.float32)
    y = stream_through([ops.Delay(D, feedback=fb, wet=0.7, dry=0.3)
                        .processor()], x, 512)
    a = np.zeros(D + 1)
    a[0], a[D] = 1.0, -fb
    s = scipy.signal.lfilter([1.0], a, x.astype(np.float64), axis=1)
    delayed = np.concatenate([np.zeros((C, D)), s[:, :-D]], axis=1)
    assert snr_db(0.3 * x.astype(np.float64) + 0.7 * delayed, y) > 125


def test_envelope_block_matches_sequential(rng):
    C, B = 2, 1000
    x = np.abs(rng.standard_normal((C, B))).astype(np.float32)
    rc, ac = 0.999, 0.9
    new0, new_lo, env = tdyn.envelope_block(
        torch.zeros((C, 2)), _t(x), B, _t(rc), _t(1.0 - ac))
    for c in range(C):
        raw_o, env_o = _envelope_oracle(x[c].astype(np.float64), rc, ac)
        assert snr_db(env_o, env[c].numpy()) >= 110
        assert float(new0[c, 0]) == pytest.approx(raw_o[-1], rel=1e-5)
        assert float(new0[c, 1]) == pytest.approx(env_o[-1], rel=1e-5)


def test_envelope_streaming_continuity(rng):
    """Blocked envelope == one-shot envelope (state carries across)."""
    C, B = 1, 2048
    x = np.abs(rng.standard_normal((C, B))).astype(np.float32)
    rc, ao = _t(0.995), _t(1.0 - 0.8)
    _, _, whole = tdyn.envelope_block(torch.zeros((C, 2)), _t(x), B, rc, ao)
    st, lo, parts = torch.zeros((C, 2)), torch.zeros((C,)), []
    for i in range(4):
        st, lo, e = tdyn.envelope_block(st, _t(x[:, i * 512:(i + 1) * 512]),
                                        512, rc, ao, lo)
        parts.append(e.numpy())
    assert snr_db(whole.numpy(), np.concatenate(parts, axis=1)) >= 110


def test_dd_coefficient_split_survives_jit():
    """The (1 - oma) hi/lo split of the envelope keeps its error channel:
    the port's eager ops fold nothing, so the plain Sterbenz form is exact
    without the JAX package's laundering constant."""
    oma = _t(np.float32(7.558578e-05))  # a 300 ms attack at 44.1 kHz
    hi = 1.0 - oma
    lo = (1.0 - hi) - oma
    oma64 = np.float64(oma.item())
    true_lo = (1.0 - oma64) - np.float64(np.float32(1.0 - oma64))
    assert lo.item() != 0.0
    assert np.float64(hi.item()) + np.float64(lo.item()) == 1.0 - oma64
    assert lo.item() == pytest.approx(true_lo, rel=1e-6)
    # and the error-free sum the carry uses stays exact
    a = _t(np.float32(1.0))
    s, e = _two_sum(a, -oma)
    assert np.float64(s.item()) + np.float64(e.item()) == 1.0 - oma64


def test_compressor_slow_attack_holds_100db(rng):
    """A 50 ms attack (kappa ~ 4400; a plain float32 one-pole sits near
    93 dB there) clears 100 dB against a float64 oracle."""
    x = (0.5 * rng.standard_normal((2, 32768))).astype(np.float32)
    att, rel, thr, ratio = 50.0, 120.0, -15.0, 4.0
    comp = ops.Compressor(threshold_db=thr, ratio=ratio, attack_ms=att,
                          release_ms=rel)
    y = stream_through([comp.processor()], x, 1024)
    env = _envelope64(x, attack_ms=att, release_ms=rel)
    over = np.maximum(20.0 * np.log10(np.maximum(env, 1e-8)) - thr, 0.0)
    g = 10.0 ** ((-over * (1.0 - 1.0 / ratio)) / 20.0)
    snr = snr_db(x.astype(np.float64) * g, y)
    assert snr > 100, f"{snr:.1f} dB"


def test_compressor_attenuates_above_threshold():
    N = 44100
    t = np.arange(N) / 44100.0
    x = (0.9 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)[None, :]
    comp = ops.Compressor(threshold_db=-20.0, ratio=4.0, attack_ms=1.0,
                          release_ms=100.0)
    y = stream_through([comp.processor()], x, 512)
    gain_db = 20 * np.log10(np.abs(y[0, -8000:]).max()
                            / np.abs(x[0, -8000:]).max())
    expect = -(20 * np.log10(0.9) + 20.0) * (1 - 1 / 4.0)  # about -14.3 dB
    assert gain_db == pytest.approx(expect, abs=0.5)


def test_limiter_infinite_ratio():
    x = (0.9 * np.ones((1, 22050))).astype(np.float32)
    lim = ops.Compressor(threshold_db=-12.0, ratio=np.inf, attack_ms=0.5,
                         release_ms=50.0)
    y = stream_through([lim.processor()], x, 512)
    assert 20 * np.log10(np.abs(y[0, -4000:]).max()) == pytest.approx(
        -12.0, abs=0.3)


def test_compressor_below_threshold_unity(rng):
    x = (0.01 * rng.standard_normal((1, 8192))).astype(np.float32)
    y = stream_through([ops.Compressor(threshold_db=-20.0, ratio=4.0)
                        .processor()], x, 512)
    assert snr_db(x.astype(np.float64), y) >= 60


def test_compressor_live_mutation():
    """A threshold pushed mid-stream lands at a block boundary."""
    comp = ops.Compressor(threshold_db=0.0, ratio=np.inf, attack_ms=0.01,
                          release_ms=0.01)
    src = mock.Source(channels=1, value=0.5, limit=512 * 200, interval=0.002)
    sink = mock.Sink()
    p = pipe_tpu_torch.Pipe(512, pipe_tpu_torch.Line(
        source=src.source(), processors=[comp.processor()],
        sink=sink.sink()))
    p.start()
    time.sleep(0.1)
    p.push(comp.set(threshold_db=-20.0))  # clamp 0.5 (-6 dB) to -20 dB
    p.wait(60)
    vals = sink.values[0]
    assert vals.max() == pytest.approx(0.5, abs=1e-3)
    assert vals.min() == pytest.approx(10 ** (-20 / 20), abs=5e-3)
    with pytest.raises(KeyError):
        comp.set(knee_db=3.0)


def test_noise_gate_gates_quiet_passes_loud():
    x = np.zeros((1, 44100), np.float32)
    x[0, :20000] = 0.5  # loud
    x[0, 30000:] = 1e-4  # quiet (-80 dB)
    gate = ops.NoiseGate(threshold_db=-50.0, range_db=80.0, attack_ms=0.5,
                         release_ms=5.0)
    y = stream_through([gate.processor()], x, 512)
    assert np.abs(y[0, 1000:19000]).max() == pytest.approx(0.5, abs=1e-3)
    assert np.abs(y[0, -4000:]).max() < 1e-7  # attenuated by 80 dB


def test_delay_set_feedback_live():
    """Feedback enabled by a mutation on a delay long enough for it; a
    short pure delay refuses (structural capability)."""
    d = ops.Delay(1024, feedback=0.0, wet=1.0, dry=1.0)
    comp = d.processor()(mutable.mutable(), 512, SignalProperties(44100.0, 1))
    impulse = torch.zeros((1, 512))
    impulse[0, 0] = 1.0
    zero = Signal(torch.zeros((1, 512)), 512)
    st, _ = comp.step(comp.state, comp.params, Signal(impulse, 512))
    d.set_feedback(0.5).apply()  # live enable: must not be a no-op
    ys = []
    for _ in range(4):
        st, y = comp.step(st, comp.params, zero)
        ys.append(y.data)
    assert float(ys[1][0, 0]) == pytest.approx(1.0)  # echo at n=1024
    assert float(ys[3][0, 0]) == pytest.approx(0.5)  # 2nd echo at n=2048

    short = ops.Delay(100, feedback=0.0)
    short.processor()(mutable.mutable(), 512, SignalProperties(44100.0, 1))
    with pytest.raises(ValueError, match="cannot do feedback"):
        short.set_feedback(0.3)


def test_fused_set_bank_after_fuse(rng):
    """optimize.fuse delegates Resampler.set_bank as well as FIR.set_taps."""
    fir = ops.FIR(ops.design_lowpass(63, 4000.0, 44100.0))
    rs = ops.Resampler(160, 147)
    fused = optimize.fuse(Line(source=None, sink=None,
                               processors=[fir.processor(), rs.processor()]))
    x = rng.standard_normal((1, 147 * 10)).astype(np.float32)
    stream_through(fused.processors, x, 588)
    m1 = fir.set_taps(ops.design_lowpass(63, 1000.0, 44100.0))
    m2 = rs.set_bank(ops.polyphase_design(160, 147, 32))
    assert m1 is not None and m2 is not None
    m1.apply()
    m2.apply()
    comp = fir._delegate._component
    np.testing.assert_allclose(
        comp.get_param("taps").numpy(),
        ops.design_lowpass(63, 1000.0, 44100.0).astype(np.float32))

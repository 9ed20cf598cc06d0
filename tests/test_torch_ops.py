"""The port's ops (FIR, resampler, fused FIR+resampler, mix, gain) against
the JAX package, on the same seeded inputs, at >= 110 dB with equal frame
counts. Both sides run float32; they differ only in summation order, so
they agree far above the 100 dB bar the JAX suite holds each op to against
float64 oracles."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipe_tpu
import pipe_tpu_torch
from pipe_tpu import ops as jops
from pipe_tpu.ops import fir as jfir, fused as jfused, resample as jrs
from pipe_tpu_torch import ops as tops
from pipe_tpu_torch.ops import fir as tfir, fused as tfused, resample as trs
from pipe_tpu_torch.signal import snr_db

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

AGREE_DB = 110


def stream(pkg, proc_allocs, x, block, sr=44100.0):
    """Push (C, N) float32 ``x`` through a line of processors built for
    ``pkg`` (``pipe_tpu`` or ``pipe_tpu_torch``) with a host feed and a host
    sink; return the concatenated (C_out, M) output."""
    C, N = x.shape
    pos = [0]
    out = []

    def feed(block_size):
        if pos[0] >= N:
            return None
        chunk = x[:, pos[0]: pos[0] + block_size]
        pos[0] += chunk.shape[1]
        return chunk

    def src(mctx, block_size):
        return pkg.Source(
            output=pkg.SignalProperties(sample_rate=sr, channels=C), feed=feed
        )

    def sink(mctx, block_size, props):
        return pkg.Sink(receive=lambda a: out.append(np.array(a)))

    pkg.run(block, pkg.Line(source=src, processors=list(proc_allocs),
                            sink=sink))
    return np.concatenate(out, axis=1)


def stream_chunks(pkg, proc_allocs, x, block, chunks, sr=44100.0):
    """Like :func:`stream`, but the feed returns the given chunk lengths in
    order (a short chunk mid-stream is a partial block)."""
    C, N = x.shape
    assert sum(chunks) == N
    state = {"pos": 0, "i": 0}
    out = []

    def feed(block_size):
        if state["i"] >= len(chunks):
            return None
        n = chunks[state["i"]]
        assert n <= block_size
        state["i"] += 1
        state["pos"] += n
        return x[:, state["pos"] - n: state["pos"]]

    pkg.run(block, pkg.Line(
        source=lambda m, b: pkg.Source(
            output=pkg.SignalProperties(sample_rate=sr, channels=C), feed=feed),
        processors=list(proc_allocs),
        sink=lambda m, b, p: pkg.Sink(receive=lambda a: out.append(np.array(a)))))
    return np.concatenate(out, axis=1)


def step_twins(jop, top, C, B, chunks, switch, sr=44100.0, seed=0):
    """One op of each package stepped directly over the same seeded blocks
    (``chunks`` valid frames each, garbage past them): JAX (jitted, as its
    executor runs it) over all of them, the port from JAX's state before
    block ``switch``, carried with ``convert``. Returns the JAX outputs of
    the blocks from ``switch`` on, the port's, and both final states as
    numpy trees."""
    import jax

    from pipe_tpu import mutable as jmutable
    from pipe_tpu.signal import Signal as JSignal, SignalProperties as JProps
    from pipe_tpu_torch import convert, mutable
    from pipe_tpu_torch.signal import Signal, SignalProperties

    rng = np.random.default_rng(seed)
    blocks = [rng.standard_normal((C, B)).astype(np.float32) for _ in chunks]
    jcomp = jop.processor()(jmutable.mutable(), B, JProps(sr, C))
    tcomp = top.processor()(mutable.mutable(), B, SignalProperties(sr, C))
    jstep = jax.jit(jcomp.step)
    jstate, jout, mid = jcomp.state, [], None
    for i, (x, f) in enumerate(zip(blocks, chunks)):
        if i == switch:
            mid = jax.tree.map(np.asarray, jstate)
        jstate, sig = jstep(jstate, jcomp.params,
                            JSignal(jnp.asarray(x), jnp.int32(f)))
        jout.append(np.asarray(sig.data)[:, : int(sig.frames)])
    tstate, tout = convert.tree_from_numpy(mid), []
    for x, f in zip(blocks[switch:], chunks[switch:]):
        tstate, sig = tcomp.step(tstate, tcomp.params,
                                 Signal(torch.from_numpy(x), f))
        tout.append(sig.data.numpy()[:, : sig.frames])
    return (jout[switch:], tout, jax.tree.map(np.asarray, jstate),
            convert.tree_to_numpy(tstate))


def assert_twins_agree(jout, tout, jstate, tstate, db=100.0, state_db=None):
    """Equal frame counts, outputs >= ``db`` apart, and the final states
    key for key: integer leaves equal, float leaves >= ``state_db``
    (default ``db``) apart."""
    from pipe_tpu_torch.tree import tree_flatten

    assert [a.shape for a in tout] == [a.shape for a in jout]
    assert snr_db(np.concatenate(jout, 1), np.concatenate(tout, 1)) >= db
    jl, jdef = tree_flatten(jstate)
    tl, tdef = tree_flatten(tstate)
    assert jdef == tdef
    for a, b in zip(jl, tl):
        assert a.shape == b.shape and a.dtype == b.dtype
        if np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b)
        elif np.any(a):
            assert snr_db(a, b) >= (db if state_db is None else state_db)
        else:
            assert not np.any(b)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


@pytest.mark.parametrize(
    "taps_shape, B",
    [((255,), 2352), ((255,), 1024), ((15,), 512), ((40,), 100), ((4, 33), 640)],
    ids=["toeplitz-pad", "toeplitz", "short", "small-block", "per-channel"],
)
def test_fir_apply_matches_jax(taps_shape, B):
    rng = np.random.default_rng(10)
    C = 4
    taps = rng.standard_normal(taps_shape) / taps_shape[-1]
    tail = rng.standard_normal((C, taps_shape[-1] - 1)).astype(np.float32)
    x = rng.standard_normal((C, B)).astype(np.float32)
    ref = np.asarray(jfir.fir_apply(_j(tail), _j(x), _j(taps)))
    got = tfir.fir_apply(_t(tail), _t(x), _t(taps)).numpy()
    assert got.shape == ref.shape == (C, B)
    assert snr_db(ref, got) > AGREE_DB


@pytest.mark.parametrize("num_taps", [255, 9])
def test_fir_block_partial_frames_matches_jax(num_taps):
    """A full block then a partial one: outputs to ``frames`` and the new
    tail (the last T-1 VALID samples) agree."""
    rng = np.random.default_rng(11)
    C, B = 4, 512
    taps = jfir.design_lowpass(num_taps, 4000, 44100)
    jt, tt = jfir.fir_init_tail(C, num_taps), tfir.fir_init_tail(C, num_taps)
    for frames in (B, 300, 0):
        x = rng.standard_normal((C, B)).astype(np.float32)
        jt, jy = jfir.fir_block(jt, _j(x), jnp.int32(frames), _j(taps))
        tt, ty = tfir.fir_block(tt, _t(x), frames, _t(taps))
        if frames:
            assert snr_db(np.asarray(jy)[:, :frames], ty.numpy()[:, :frames]) > AGREE_DB
        assert snr_db(np.asarray(jt), tt.numpy()) > AGREE_DB


def test_resample_apply_matches_jax():
    rng = np.random.default_rng(12)
    C, B = 4, 147 * 4
    hp = jrs.polyphase_design(160, 147, 32)
    hist = rng.standard_normal((C, 31)).astype(np.float32)
    x = rng.standard_normal((C, B)).astype(np.float32)
    ref = np.asarray(jrs.resample_apply(_j(hist), _j(x), _j(hp), 160, 147))
    got = trs.resample_apply(_t(hist), _t(x), _t(hp), 160, 147).numpy()
    assert got.shape == ref.shape == (C, 160 * 4)
    assert snr_db(ref, got) > AGREE_DB


@pytest.mark.parametrize(
    "make, block",
    [
        (lambda o: o.Resampler(48000, 44100).processor(), 294),  # fast path
        (lambda o: o.Resampler(48000, 44100).processor(), 100),  # gather path
        (lambda o: o.Resampler(3, 2, taps_per_phase=8).processor(), 64),
        (lambda o: o.FIRResampler(o.design_lowpass(63, 4000, 44100),
                                  48000, 44100).processor(), 294),
        (lambda o: o.FIRResampler(o.design_lowpass(63, 4000, 44100),
                                  48000, 44100).processor(), 100),
    ],
    ids=["resampler-fast", "resampler-gather", "resampler-3/2",
         "fused-fast", "fused-gather"],
)
def test_streamed_resampler_matches_jax(make, block):
    """Streaming rate change with a partial final block: the frame counts
    are exact and the samples agree."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, block * 7 + 55)).astype(np.float32)
    ref = stream(pipe_tpu, [make(jops)], x, block)
    got = stream(pipe_tpu_torch, [make(tops)], x, block)
    assert got.shape == ref.shape
    assert snr_db(ref, got) > AGREE_DB


def test_combine_bank_and_fused_apply_match_jax():
    rng = np.random.default_rng(14)
    C, B = 4, 147 * 2
    taps = jfir.design_lowpass(255, 4000, 44100)
    hp = jrs.polyphase_design(160, 147, 32)
    ref_bank = np.asarray(jfused.combine_bank(_j(taps), _j(hp)))
    got_bank = tfused.combine_bank(_t(taps), _t(hp)).numpy()
    assert got_bank.shape == ref_bank.shape == (160, 32 + 254)
    assert snr_db(ref_bank, got_bank) > AGREE_DB

    hist = rng.standard_normal((C, 32 + 253)).astype(np.float32)
    x = rng.standard_normal((C, B)).astype(np.float32)
    ref = np.asarray(jfused.fused_apply(_j(hist), _j(x), _j(taps), _j(hp), 160, 147))
    got = tfused.fused_apply(_t(hist), _t(x), _t(taps), _t(hp), 160, 147).numpy()
    assert got.shape == ref.shape == (C, 320)
    assert snr_db(ref, got) > AGREE_DB


def test_channel_mix_block_matches_jax():
    rng = np.random.default_rng(15)
    m = rng.standard_normal((2, 8)).astype(np.float32)
    x = rng.standard_normal((8, 1000)).astype(np.float32)
    ref = np.asarray(jops.channel_mix_block(_j(x), _j(m)))
    got = tops.channel_mix_block(_t(x), _t(m)).numpy()
    assert got.shape == ref.shape == (2, 1000)
    assert snr_db(ref, got) > AGREE_DB


@pytest.mark.parametrize("gain", [0.5, [0.5, -1.0, 2.0]], ids=["scalar", "per-channel"])
def test_gain_block_matches_jax(gain):
    x = np.random.default_rng(16).standard_normal((3, 100)).astype(np.float32)
    ref = np.asarray(jops.gain_block(_j(x), _j(gain)))
    got = tops.gain_block(_t(x), _t(gain)).numpy()
    assert got.shape == ref.shape
    assert snr_db(ref, got) > AGREE_DB

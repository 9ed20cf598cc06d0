"""The port's polyphase channelizer, oscillator, IQ mixer and demodulators,
against the JAX package and float64 oracles.

- JAX-vs-port: the same seeded blocks, with mid-stream partial blocks,
  through each stateful op, from JAX's state carried with ``convert``:
  >= 100 dB on the output (the FM discriminator is nonlinear and holds the
  same bar), integer state (the channelizer's ``pcnt``, the oscillator's
  ``n``) equal.
- The twins of the channelizer and demod tests of ``tests/test_ops.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipe_tpu_torch
from pipe_tpu import ops as jops
from pipe_tpu.ops import channelizer as jch
from pipe_tpu_torch import ops
from pipe_tpu_torch.ops import channelizer as tch
from pipe_tpu_torch.ops.channelizer import Channelizer, design_prototype, split_bins
from pipe_tpu_torch.signal import snr_db
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


class _Chain:
    """A list of processor allocators as one op, for ``step_twins``."""

    def __init__(self, make, pkg):
        self._allocs = make(pkg)

    def processor(self):
        def alloc(mctx, block_size, props):
            comps = []
            for a in self._allocs:
                comps.append(a(mctx, block_size, props))
                props = comps[-1].output
            last = comps[-1]

            def step(state, params, sig):
                new = []
                for c, st, pr in zip(comps, state, params):
                    st, sig = c.step(st, pr, sig)
                    new.append(st)
                return new, sig

            return type(last)(output=last.output, step=step,
                              state=[c.state for c in comps],
                              params=[c.params for c in comps])

        return alloc


@pytest.mark.parametrize(
    "make, B",
    [
        (lambda o: o.Channelizer(8, taps_per_branch=12), 300),
        (lambda o: o.Oscillator(1234.5), 256),
        (lambda o: o.IQMix(5000.0), 256),
        (lambda o: _Chain(lambda p: p.fm_demod_factory(
            6000.0, p.design_lowpass(31, 3000.0, 44100.0)), o), 256),
        (lambda o: _Chain(lambda p: p.am_demod_factory(
            6000.0, p.design_lowpass(31, 3000.0, 44100.0)), o), 256),
    ],
    ids=["channelizer", "oscillator", "iq-mix", "fm-chain", "am-chain"],
)
def test_stateful_ops_match_jax(make, B):
    chunks = [B, 101, B, B, 37, B, B]
    jout, tout, js, ts = step_twins(make(jops), make(ops), 2, B, chunks,
                                    switch=2)
    assert_twins_agree(jout, tout, js, ts)


def test_channelize_block_matches_jax(rng):
    K = 8
    gp = tch.polyphase_branches(design_prototype(K, 12), K).astype(np.float32)
    hist = rng.standard_normal((2, K * (gp.shape[1] - 1))).astype(np.float32)
    x = rng.standard_normal((2, 512)).astype(np.float32)
    jre, jim = jch.channelize_block(jnp.asarray(hist), jnp.asarray(x),
                                    jnp.asarray(gp), K)
    tre, tim = tch.channelize_block(torch.from_numpy(hist),
                                    torch.from_numpy(x), torch.from_numpy(gp), K)
    assert tre.shape == jre.shape == (2, K // 2 + 1, 512 // K)
    ref = np.asarray(jre) + 1j * np.asarray(jim)
    got = tre.numpy() + 1j * tim.numpy()
    err = np.sum(np.abs(ref - got) ** 2)
    assert 10 * np.log10(np.sum(np.abs(ref) ** 2) / err) > 120


# -- twins of tests/test_ops.py: demod -----------------------------------------


def test_oscillator_phase_exact_long_stream():
    """Exact integer phase stays >= 100 dB after 200k samples."""
    sr, f, n = 8000, 1000.0, 200_000
    x = np.ones((1, n), np.float32)
    out = stream_through([ops.Oscillator(f).processor()], x, 512, sr=sr)
    oracle = np.cos(2 * np.pi * f * np.arange(n, dtype=np.float64) / sr)
    assert snr_db(oracle, out[0]) > SNR_TARGET


def test_am_demod_recovers_message():
    sr, n = 8000, 8000
    t = np.arange(n, dtype=np.float64) / sr
    msg = 0.5 + 0.5 * np.sin(2 * np.pi * 50.0 * t)
    x = (msg * np.cos(2 * np.pi * 1000.0 * t)).astype(np.float32)[None, :]
    chain = ops.am_demod_factory(1000.0, ops.design_lowpass(255, 200, sr))
    out = stream_through(chain, x, 512, sr=sr)
    assert out.shape == (1, n)
    delay = 127  # lowpass group delay
    oracle = msg[1000 - delay: n - 1000 - delay] / 2.0
    assert snr_db(oracle, out[0, 1000:-1000]) > 40


def test_fm_demod_recovers_message():
    sr, fc, dev, N = 44100.0, 8000.0, 1500.0, 44100
    t = np.arange(N) / sr
    msg = np.sin(2 * np.pi * 40.0 * t)
    phase = 2 * np.pi * fc * t + 2 * np.pi * dev * np.cumsum(msg) / sr
    x = np.cos(phase).astype(np.float32)[None, :]
    chain = ops.fm_demod_factory(fc, ops.design_lowpass(255, 3000.0, sr))
    got_hz = stream_through(chain, x, 512)[0] * sr
    settle, gd = 2000, 127
    g = got_hz[settle + gd: -settle + gd]
    e = (dev * msg)[settle:-settle]
    assert np.corrcoef(g, e)[0, 1] > 0.999
    assert np.abs(np.max(g) - dev) < dev * 0.05


# -- twins of tests/test_ops.py: channelizer -----------------------------------


def test_channelizer_matches_direct_oracle(rng):
    """Bank output == direct downconvert + filter + decimate in float64."""
    K, C, block = 8, 2, 512
    N = block * 6
    x = rng.standard_normal((C, N)).astype(np.float32)
    Y = split_bins(stream_through([Channelizer(K, 12).processor()], x, block),
                   K)
    h = design_prototype(K, 12)
    xf = x.astype(np.float64)
    M, n = N // K, np.arange(N)
    for k in range(K // 2 + 1):
        down = xf * np.exp(-2j * np.pi * k * n / K)[None, :]
        filt = np.stack([np.convolve(down[c], h)[:N] for c in range(C)])
        oracle = filt[:, ::K][:, :M]
        err = oracle - Y[:, k, :M]
        s = 10 * np.log10(max(np.sum(np.abs(oracle) ** 2), 1e-300)
                          / max(np.sum(np.abs(err) ** 2), 1e-300))
        assert s >= 100, f"bin {k}: {s:.1f} dB"


def test_channelizer_sine_lands_in_one_bin():
    K, block = 16, 512
    N = block * 8
    tone = np.cos(2 * np.pi * (3.0 / K) * np.arange(N)).astype(np.float32)[None, :]
    Y = split_bins(stream_through([Channelizer(K).processor()], tone, block), K)
    settle = Y.shape[2] // 4
    power = np.mean(np.abs(Y[0, :, settle:]) ** 2, axis=1)
    assert np.argmax(power) == 3
    assert power[3] > 1e4 * np.delete(power, 3).max()  # > 40 dB isolation


def test_channelizer_any_block_size(rng):
    """A block size that is not a multiple of K streams exactly: the pend
    carry absorbs the residue."""
    x = rng.standard_normal((1, 8000)).astype(np.float32)
    ref = stream_through([ops.Channelizer(8).processor()], x, 512)
    got = stream_through([ops.Channelizer(8).processor()], x, 500)
    n = min(ref.shape[1], got.shape[1])
    assert n >= 8000 // 8 - 1
    np.testing.assert_allclose(got[:, :n], ref[:, :n], atol=2e-5)


def test_channelizer_midstream_partial_blocks(rng):
    """Ragged mid-stream chunks (frames % K != 0) give the same subband
    stream as contiguous feeding."""
    K, block, N = 8, 64, 64 * 40
    x = rng.standard_normal((1, N)).astype(np.float32)

    def run_with(chunks):
        return split_bins(stream_chunks(
            pipe_tpu_torch, [Channelizer(K, taps_per_branch=8).processor()],
            x, block, chunks), K)

    ref = run_with([64] * 40)
    ragged, left = [], N
    for n in [36, 17, 50, 64, 3, 29, 61, 44] * 20:
        if left == 0:
            break
        ragged.append(min(n, left))
        left -= ragged[-1]
    got = run_with(ragged)
    M = min(ref.shape[2], got.shape[2])
    assert ref.shape[2] - got.shape[2] <= 1  # at most one trailing group held
    assert np.abs(ref[:, :, :M] - got[:, :, :M]).max() < 1e-6

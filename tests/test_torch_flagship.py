"""The port's flagship chunk function against the JAX package's: three
chained chunks with carried history, fused and unfused, at >= 100 dB (the
chain bar; both sides run float32 and differ only in summation order)."""

import jax
import numpy as np
import pytest
import torch

import pipe_tpu_torch
from pipe_tpu import flagship as jflag
from pipe_tpu_torch import convert, flagship as tflag
from pipe_tpu_torch.signal import snr_db

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

C, CHUNK = 8, 147 * 16


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
def test_flagship_chunks_match_jax(fused):
    jfn, jstate, _ = jflag.make_flagship(channels=C, chunk=CHUNK, fused=fused)
    tfn, tstate, _ = tflag.make_flagship(channels=C, chunk=CHUNK, fused=fused)
    assert [tuple(t.shape) for t in tstate] == [t.shape for t in jstate]
    jfn = jax.jit(jfn)
    rng = np.random.default_rng(20)
    for _ in range(3):
        x = rng.standard_normal((C, CHUNK)).astype(np.float32)
        jstate, jy = jfn(jstate, x)
        tstate, ty = tfn(tstate, torch.from_numpy(x))
        assert ty.shape == (2, CHUNK * 160 // 147) == jy.shape
        assert snr_db(np.asarray(jy), ty.numpy()) > 100
    for j, t in zip(jstate, convert.tree_to_numpy(tstate)):
        assert snr_db(np.asarray(j), t) > 100


def test_flagship_fused_matches_unfused():
    x = np.random.default_rng(21).standard_normal((C, CHUNK)).astype(np.float32)
    outs = []
    for fused in (True, False):
        fn, state, _ = tflag.make_flagship(channels=C, chunk=CHUNK, fused=fused)
        ys = []
        for _ in range(2):
            state, y = fn(state, torch.from_numpy(x))
            ys.append(y.numpy())
        outs.append(np.concatenate(ys, 1))
    assert snr_db(outs[1], outs[0]) > 100


def test_flagship_rejects_chunk_off_the_resampler_grid():
    with pytest.raises(ValueError, match="multiple of 147"):
        tflag.make_flagship(channels=C, chunk=1000)

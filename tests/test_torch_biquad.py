"""The port's biquad module against the JAX package: the recurrence paths
(the TPU kernel runs in Pallas interpret mode here), the streaming cascade
with carried state, and a JAX state continued by the port. The CUDA kernel
itself is held against its plain version in tests/test_torch_gpu.py, which
imports no JAX (the card machine has none).

Tolerance: >= 110 dB, the bar the JAX suite sets between its own recurrence
paths (tests/test_ops.py::test_iir_tiled_paths_match_assoc): the paths
differ only in float32 summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pipe_tpu.ops import biquad as jbq
from pipe_tpu_torch import convert, kernels
from pipe_tpu_torch.ops import biquad as tbq
from pipe_tpu_torch.signal import snr_db

SOS = np.stack([
    jbq.design_peaking_eq(48000, 1000, 1.0, 3.0),
    jbq.design_highshelf(48000, 8000, -2.0),
])


def _recurrence_inputs(seed, C, B):
    rng = np.random.default_rng(seed)
    sos = jbq.design_peaking_eq(44100, freq=2000, q=2.0, gain_db=6.0)
    a1, a2 = np.float32(sos[4]), np.float32(sos[5])
    v = rng.standard_normal((C, B)).astype(np.float32)
    s = rng.standard_normal((C, 2)).astype(np.float32)
    return v, s, a1, a2


@pytest.mark.parametrize("jax_path", ["tiles", "pallas_interpret", "assoc"])
@pytest.mark.parametrize("port_path", ["tiles", "assoc"])
def test_iir_apply_matches_jax(port_path, jax_path):
    v, s, a1, a2 = _recurrence_inputs(1, 8, 4096)
    ref = np.asarray(jax.jit(
        lambda: jbq._iir_apply(jnp.asarray(v), jnp.asarray(s), jnp.float32(a1),
                               jnp.float32(a2), force=jax_path)
    )())
    got = tbq._iir_apply(torch.from_numpy(v), torch.from_numpy(s),
                         torch.tensor(a1), torch.tensor(a2), force=port_path)
    assert got.shape == (8, 4096)
    assert snr_db(ref, got.numpy()) > 110


def test_iir_default_path_on_cpu_is_plain_tiles():
    """A CPU tensor that passes the tile gate takes the plain version; the
    kernel path itself refuses a CPU tensor instead of falling back."""
    v, s, a1, a2 = _recurrence_inputs(2, 8, 2048)
    args = (torch.from_numpy(v), torch.from_numpy(s), torch.tensor(a1),
            torch.tensor(a2))
    before = kernels.iir_tiles_launches
    y = tbq._iir_apply(*args)
    assert torch.equal(y, tbq._iir_apply(*args, force="tiles"))
    with pytest.raises(ValueError, match="CUDA"):
        tbq._iir_apply(*args, force="kernel")
    assert kernels.iir_tiles_launches == before


def _stream_blocks(seed, C, B, n_blocks, frames_last):
    rng = np.random.default_rng(seed)
    blocks = [rng.standard_normal((C, B)).astype(np.float32)
              for _ in range(n_blocks)]
    frames = [B] * (n_blocks - 1) + [frames_last]
    return blocks, frames


def _jax_cascade(blocks, frames, state=None):
    sos = jnp.asarray(SOS.astype(np.float32))
    if state is None:
        state = jbq.biquad_init_state(blocks[0].shape[0], SOS.shape[0])
    step = jax.jit(lambda st, x, f: jbq.biquad_block(st, x, f, sos))
    outs = []
    for x, f in zip(blocks, frames):
        state, y = step(state, jnp.asarray(x), jnp.int32(f))
        outs.append(np.asarray(y)[:, :f])
    return state, outs


def _port_cascade(blocks, frames, state=None):
    sos = torch.from_numpy(SOS.astype(np.float32))
    if state is None:
        state = tbq.biquad_init_state(blocks[0].shape[0], SOS.shape[0])
    outs = []
    for x, f in zip(blocks, frames):
        state, y = tbq.biquad_block(state, torch.from_numpy(x), f, sos)
        outs.append(y.numpy()[:, :f])
    return state, outs


@pytest.mark.parametrize("B", [512, 2048])  # assoc and tiled paths
def test_biquad_block_chained_matches_jax(B):
    blocks, frames = _stream_blocks(3, 8, B, 4, B - 37)
    jstate, jout = _jax_cascade(blocks, frames)
    tstate, tout = _port_cascade(blocks, frames)
    for j, t in zip(jout, tout):
        assert t.shape == j.shape
    assert snr_db(np.concatenate(jout, 1), np.concatenate(tout, 1)) > 110
    # the carried state has the JAX package's keys and shapes; its values
    # are 2 samples per channel of the streams compared above, so their SNR
    # (over 16 values) scatters a few dB around the streams' and gets a
    # 100 dB bar
    js = jax.tree.map(np.asarray, jstate)
    for a, b in zip(js, convert.tree_to_numpy(tstate)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape
            assert snr_db(a[k], b[k]) > 100


def test_jax_state_continued_by_port():
    """Two blocks through JAX, the state carried across with
    ``convert.tree_from_numpy``, two more through the port — against JAX
    running all four."""
    blocks, frames = _stream_blocks(4, 8, 2048, 4, 2048)
    _, full = _jax_cascade(blocks, frames)
    mid, _ = _jax_cascade(blocks[:2], frames[:2])
    state = convert.tree_from_numpy(jax.tree.map(np.asarray, mid))
    _, rest = _port_cascade(blocks[2:], frames[2:], state)
    assert snr_db(np.concatenate(full[2:], 1), np.concatenate(rest, 1)) > 110


def test_biquad_extended_precision_not_ported():
    with pytest.raises(NotImplementedError):
        tbq.Biquad(SOS, precision="extended")

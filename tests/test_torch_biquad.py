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
import scipy.signal
import torch

import pipe_tpu_torch
from pipe_tpu.ops import biquad as jbq
from pipe_tpu_torch import convert, kernels
from pipe_tpu_torch.ops import biquad as tbq
from pipe_tpu_torch.signal import snr_db

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

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


PORT_PATHS = {"tiles": tbq._iir_tiles, "assoc": tbq._iir_assoc}


@pytest.mark.parametrize("jax_path", ["tiles", "pallas_interpret", "assoc"])
@pytest.mark.parametrize("port_path", PORT_PATHS)
def test_iir_apply_matches_jax(port_path, jax_path):
    v, s, a1, a2 = _recurrence_inputs(1, 8, 4096)
    ref = np.asarray(jax.jit(
        lambda: jbq._iir_apply(jnp.asarray(v), jnp.asarray(s), jnp.float32(a1),
                               jnp.float32(a2), force=jax_path)
    )())
    got = PORT_PATHS[port_path](torch.from_numpy(v), torch.from_numpy(s),
                                torch.tensor(a1), torch.tensor(a2))
    assert got.shape == (8, 4096)
    assert snr_db(ref, got.numpy()) > 110


@pytest.mark.parametrize("shape", [(8, 2048), (8, 1000), (8, 640)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_iir_default_path_on_cpu_is_plain_tiles(shape):
    """A CPU block with whole 8-channel groups takes the plain tile version
    at any length (a partial last tile included); the kernel itself refuses
    a CPU tensor instead of falling back."""
    v, s, a1, a2 = _recurrence_inputs(2, *shape)
    args = (torch.from_numpy(v), torch.from_numpy(s), torch.tensor(a1),
            torch.tensor(a2))
    before = kernels.launch_counts()["iir_tiles"]
    y = tbq._iir_apply(*args)
    assert torch.equal(y, tbq._iir_tiles(*args))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.iir_tiles(*args)
    assert kernels.launch_counts()["iir_tiles"] == before


SECTIONS = {  # name -> float64 SOS row
    "peaking-1k": jbq.design_peaking_eq(48000, 1000, 1.0, 3.0),
    "shelf-8k": jbq.design_highshelf(48000, 8000, -2.0),
    "near-dc-20": jbq.design_peaking_eq(44100, 20.0, 0.5, 6.0),
}


def _f64_recurrence(v, s, a1, a2):
    """The recurrence step by step in float64 (float32 coefficients)."""
    a1, a2 = np.float64(a1), np.float64(a2)
    v = v.astype(np.float64)
    y = np.empty_like(v)
    y1, y2 = s[:, 0].astype(np.float64), s[:, 1].astype(np.float64)
    for n in range(v.shape[1]):
        y[:, n] = v[:, n] - a1 * y1 - a2 * y2
        y1, y2 = y[:, n], y1
    return y


def _section_inputs(section, shape, seed):
    rng = np.random.default_rng(seed)
    row = SECTIONS[section]
    a1, a2 = np.float32(row[4]), np.float32(row[5])
    v = rng.standard_normal(shape).astype(np.float32)
    s = rng.standard_normal((shape[0], 2)).astype(np.float32)
    port = tbq._iir_tiles(torch.from_numpy(v), torch.from_numpy(s),
                          torch.tensor(a1), torch.tensor(a2))
    return v, s, a1, a2, port.numpy()


@pytest.mark.parametrize("jax_path", ["tiles", "pallas_interpret"])
@pytest.mark.parametrize("shape", [(8, 2048), (16, 4096)], ids=str)
@pytest.mark.parametrize("section", SECTIONS)
def test_three_pass_tiles_match_jax(section, shape, jax_path):
    """The plain version in the CUDA kernel's three passes (all tile
    products, then the carries, then the boundary terms) against the JAX
    package's tile paths, which walk the tiles in order. The near-DC
    section is held as ``test_near_dc_section_streams_no_worse_than_jax``
    holds it: against float64, no worse than JAX. One unrefined pass over
    white noise reads 50.6-51.0 dB there (JAX 41.7-42.1 dB; the responses
    grow to ~150, and the port forms them in float64), so its floor is 45
    dB, not that test's 60 dB for the refined, streamed section."""
    v, s, a1, a2, got = _section_inputs(section, shape, seed=7)
    ref = np.asarray(jax.jit(
        lambda: jbq._iir_apply(jnp.asarray(v), jnp.asarray(s), jnp.float32(a1),
                               jnp.float32(a2), force=jax_path))())
    assert got.shape == shape
    if section != "near-dc-20":
        assert snr_db(ref, got) >= 110
        return
    f64 = _f64_recurrence(v, s, a1, a2)
    port_db, jax_db = snr_db(f64, got), snr_db(f64, ref)
    assert port_db >= 45, f"port {port_db:.1f} dB"
    assert port_db >= jax_db - 1, f"port {port_db:.1f} dB, JAX {jax_db:.1f} dB"


@pytest.mark.parametrize("shape", [(8, 2048), (16, 4096)], ids=str)
@pytest.mark.parametrize("section", ["peaking-1k", "shelf-8k"])
def test_three_pass_tiles_match_float64(section, shape):
    """>= 90 dB against the step-by-step float64 recurrence: what is left
    is float32 rounding in the tile products and the carries."""
    v, s, a1, a2, got = _section_inputs(section, shape, seed=8)
    assert snr_db(_f64_recurrence(v, s, a1, a2), got) >= 90


@pytest.mark.parametrize("refine", [True, False], ids=["refine", "plain"])
@pytest.mark.parametrize("frames_last", ["B", "B-1", "1", "0"])
def test_section_ref_matches_jax_over_carried_blocks(frames_last, refine):
    """``_biquad_section_ref`` (the plain version of the section kernel)
    against ``pipe_tpu``'s ``biquad_section_block`` over 4 blocks of
    (8, 2048), the last valid to ``frames_last``: the port carries its own
    state, and for the last block it also continues from the JAX state
    brought over by ``convert``. Outputs >= 110 dB with the refinement
    pass; without it each package keeps the rounding noise of its own
    float32 recurrence (JAX's single pass sits ~115 dB from float64, the
    streams read 108.7 dB apart), so >= 105 dB. The carried state is 2
    samples a channel of those streams, so its SNR over 16 values scatters
    a few dB around theirs and gets a bar 10 dB lower."""
    C, B = 8, 2048
    bar = 110 if refine else 105
    frames_last = {"B": B, "B-1": B - 1, "1": 1, "0": 0}[frames_last]
    blocks, frames = _stream_blocks(11, C, B, 4, frames_last)
    row = SOS[0].astype(np.float32)
    jstep = jax.jit(lambda st, x, f: jbq.biquad_section_block(
        st, x, f, jnp.asarray(row), refine=refine))
    zeros = np.zeros((C, 2), np.float32)
    jst = {"x_tail": jnp.asarray(zeros), "s": jnp.asarray(zeros)}
    tst = {"x_tail": torch.from_numpy(zeros), "s": torch.from_numpy(zeros)}
    coefs = torch.from_numpy(row)
    for i, (x, f) in enumerate(zip(blocks, frames)):
        before = convert.tree_from_numpy(jax.tree.map(np.asarray, jst))
        jst, jy = jstep(jst, jnp.asarray(x), jnp.int32(f))
        tst, ty = tbq._biquad_section_ref(tst, torch.from_numpy(x), f, coefs,
                                          refine=refine)
        jy = np.asarray(jy)
        assert ty.shape == jy.shape == (C, B)
        if f:
            assert snr_db(jy[:, :f], ty.numpy()[:, :f]) >= bar
        if i == 3:
            cst, cy = tbq._biquad_section_ref(before, torch.from_numpy(x), f,
                                              coefs, refine=refine)
            if f:
                assert snr_db(jy[:, :f], cy.numpy()[:, :f]) >= bar
            states = (tst, cst)
        else:
            states = (tst,)
        for st in states:
            assert st.keys() == jst.keys()
            for k in st:
                assert tuple(st[k].shape) == (C, 2)
                assert snr_db(np.asarray(jst[k]), st[k].numpy()) >= bar - 10
    if frames_last == 0:  # an empty block keeps the carried state exactly
        for k in before:
            assert torch.equal(cst[k], before[k])


def test_section_block_on_cpu_is_the_plain_section():
    """A CPU block takes ``_biquad_section_ref`` whether or not it passes
    the tile gate, and launches nothing."""
    rng = np.random.default_rng(12)
    coefs = torch.from_numpy(SOS[1].astype(np.float32))
    before = kernels.launch_counts()
    for C, B in ((8, 2048), (2, 512)):
        st = {k: torch.from_numpy(rng.standard_normal((C, 2)).astype(np.float32))
              for k in ("x_tail", "s")}
        x = torch.from_numpy(rng.standard_normal((C, B)).astype(np.float32))
        got_st, got = tbq.biquad_section_block(st, x, B - 5, coefs)
        ref_st, ref = tbq._biquad_section_ref(st, x, B - 5, coefs)
        assert torch.equal(got, ref)
        assert all(torch.equal(got_st[k], ref_st[k]) for k in ref_st)
    assert kernels.launch_counts() == before


def _stream_blocks(seed, C, B, n_blocks, frames_last):
    rng = np.random.default_rng(seed)
    blocks = [rng.standard_normal((C, B)).astype(np.float32)
              for _ in range(n_blocks)]
    frames = [B] * (n_blocks - 1) + [frames_last]
    return blocks, frames


# one jitted cascade step for every test: jit compiles it once per shape
_jax_cascade_step = jax.jit(lambda st, x, f: jbq.biquad_block(
    st, x, f, jnp.asarray(SOS.astype(np.float32))))


def _jax_cascade(blocks, frames, state=None):
    if state is None:
        state = jbq.biquad_init_state(blocks[0].shape[0], SOS.shape[0])
    outs = []
    for x, f in zip(blocks, frames):
        state, y = _jax_cascade_step(state, jnp.asarray(x), jnp.int32(f))
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


@pytest.mark.parametrize("C, B", [  # 'tiles' (8 channels), 'assoc' (2)
    pytest.param(8, 512, id="512"), pytest.param(8, 2048, id="2048"),
    pytest.param(2, 512, id="2-512")])
def test_biquad_block_chained_matches_jax(C, B):
    blocks, frames = _stream_blocks(3, C, B, 4, B - 37)
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


def _partial_tile_cases():
    """(C, B, frames of the last block): blocks whose last 256-frame tile
    is partial or that are shorter than one tile, each valid to 0, 1, 2,
    B - 37 and B frames where those exist."""
    for C, B in ((8, 640), (64, 640), (8, 1000), (8, 100), (8, 1), (16, 2304)):
        for f in sorted({0, 1, 2, B - 37, B}):
            if 0 <= f <= B:
                yield pytest.param(C, B, f, id=f"{C}x{B}-f{f}")


@pytest.mark.parametrize("C, B, frames_last", _partial_tile_cases())
def test_biquad_block_partial_tiles_match_jax(monkeypatch, C, B, frames_last):
    """The plain version of the section kernel on blocks that fill no whole
    number of tiles: the recurrence runs as ``'tiles'`` with the last tile
    zero-padded (2 sections x 2 passes x 4 blocks), streamed over 4 blocks
    against ``pipe_tpu``'s cascade with the bars of
    ``test_biquad_block_chained_matches_jax``: >= 110 dB on the streams,
    >= 100 dB on the carried state."""
    tiled = []
    ref_tiles = tbq._iir_tiles_ref
    monkeypatch.setattr(tbq, "_iir_tiles_ref",
                        lambda *a: tiled.append(a[0].shape) or ref_tiles(*a))
    blocks, frames = _stream_blocks(13, C, B, 4, frames_last)
    jstate, jout = _jax_cascade(blocks, frames)
    tstate, tout = _port_cascade(blocks, frames)
    assert tiled == [(C, B)] * 16
    for j, t in zip(jout, tout):
        assert t.shape == j.shape
    assert snr_db(np.concatenate(jout, 1), np.concatenate(tout, 1)) >= 110
    js = jax.tree.map(np.asarray, jstate)
    for a, b in zip(js, convert.tree_to_numpy(tstate)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape
            assert snr_db(a[k], b[k]) >= 100


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


@pytest.mark.parametrize("C, B", [(2, 512), (8, 2048), (8, 640)])  # assoc, tiles
def test_near_dc_section_streams_no_worse_than_jax(C, B):
    """A 20 Hz q=0.5 section at 44.1 kHz (DC gain of 1/A near 1e5) over 16
    blocks on the default float32 path, against float64. The port forms
    the prefix products and the tile responses in float64 (see
    ``_iir_assoc`` and ``_iir_sequences``); measured: assoc 65.4 dB (JAX
    44.3 dB), tiles 65.0 dB (JAX 63.7 dB), tiles with a partial last tile
    at 640 frames 64.8 dB (JAX's assoc 40.1 dB). With both in float32 the
    port read 8.5 dB (its block map diverged) and 55.6 dB."""
    sos = jbq.design_peaking_eq(44100, 20.0, 0.5, 6.0)[None]
    sos32 = (sos / sos[:, 3:4]).astype(np.float32)
    blocks, frames = _stream_blocks(0, C, B, 16, B)
    ref = scipy.signal.sosfilt(sos, np.concatenate(blocks, 1).astype(np.float64),
                               axis=1)
    step = jax.jit(lambda st, x, f: jbq.biquad_block(st, x, f, jnp.asarray(sos32)))
    jst, tst = jbq.biquad_init_state(C, 1), tbq.biquad_init_state(C, 1)
    jout, tout = [], []
    for x, f in zip(blocks, frames):
        jst, jy = step(jst, jnp.asarray(x), jnp.int32(f))
        tst, ty = tbq.biquad_block(tst, torch.from_numpy(x), f,
                                   torch.from_numpy(sos32))
        jout.append(np.asarray(jy))
        tout.append(ty.numpy())
    jax_db = snr_db(ref, np.concatenate(jout, 1))
    port_db = snr_db(ref, np.concatenate(tout, 1))
    assert port_db >= 60, f"port {port_db:.1f} dB"
    assert port_db >= jax_db - 1, f"port {port_db:.1f} dB, JAX {jax_db:.1f} dB"


def test_biquad_extended_precision_not_ported():
    """``precision='extended'`` is ported: the double-f32 cascade carries
    an ``s_lo`` state, and a JAX state continued by the port gives JAX's
    own continuation at >= 140 dB (both form the same error-free
    transforms over the same prefix-doubling tree)."""
    blocks, frames = _stream_blocks(6, 2, 512, 5, 300)
    sos_lo = tbq.split_f32_pair(SOS / SOS[:, 3:4])[1]
    jstate = jbq.biquad_init_state(2, 2, extended=True)
    # the coefficients are jit arguments: as compile-time constants XLA
    # would fold the JAX package's laundering constant away
    step = jax.jit(lambda st, x, f, hi, lo: jbq.biquad_block(
        st, x, f, hi, sections_lo=lo))
    hi_lo = (jnp.asarray(SOS, jnp.float32), jnp.asarray(sos_lo))
    jout = []
    for i, (x, f) in enumerate(zip(blocks, frames)):
        if i == 2:
            mid = convert.tree_from_numpy(jax.tree.map(np.asarray, jstate))
        jstate, y = step(jstate, jnp.asarray(x), jnp.int32(f), *hi_lo)
        jout.append(np.asarray(y)[:, :f])
    assert all(set(st) == {"x_tail", "s", "s_lo"} for st in mid)
    tstate, tout = mid, []
    for x, f in zip(blocks[2:], frames[2:]):
        tstate, y = tbq.biquad_block(tstate, torch.from_numpy(x), f,
                                     torch.tensor(SOS, dtype=torch.float32),
                                     sections_lo=torch.from_numpy(sos_lo))
        tout.append(y.numpy()[:, :f])
    assert snr_db(np.concatenate(jout[2:], 1), np.concatenate(tout, 1)) >= 140
    assert tbq.Biquad(SOS, precision="extended")._extended

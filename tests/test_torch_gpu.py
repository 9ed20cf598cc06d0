"""Tests of the port that need a CUDA card (marker ``gpu``); they skip on
the CPU. The file imports no JAX, so it runs on a card machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py sets up JAX.) The CPU checks of
the kernel wrapper's input validation and of the kernel module's thread
safety run everywhere."""

import re
import sys
import threading

import numpy as np
import pytest
import torch

import pipe_tpu_torch
from pipe_tpu_torch import checkpoint, config, kernels, mock, ops
from pipe_tpu_torch.ops.biquad import (
    _biquad_section_ref,
    _iir_apply,
    _iir_assoc,
    _iir_plain,
    _iir_tiles,
    biquad_block,
    biquad_init_state,
    biquad_section_block,
)
from pipe_tpu_torch.ops.dynamics import _attack_oma, _decay_coef, envelope_block
from pipe_tpu_torch.signal import SignalProperties, snr_db


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _recurrence_inputs(device, C, B, seed=0):
    rng = np.random.default_rng(seed)
    sos = ops.design_peaking_eq(48000, 1000, 1.0, 3.0).astype(np.float32)
    v = torch.tensor(rng.standard_normal((C, B)), dtype=torch.float32, device=device)
    s = torch.tensor(rng.standard_normal((C, 2)), dtype=torch.float32, device=device)
    return v, s, torch.tensor(sos[4], device=device), torch.tensor(sos[5], device=device)


def _section_inputs(device, C, B, seed=0, row=None):
    rng = np.random.default_rng(seed)
    if row is None:
        row = ops.design_peaking_eq(48000, 1000, 1.0, 3.0)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return (t(rng.standard_normal((C, B))), t(rng.standard_normal((C, 2))),
            t(rng.standard_normal((C, 2))), t(row))


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the wrappers raise on what the kernels do not take."""
    with pytest.raises(ValueError, match="CUDA"):
        kernels.iir_tiles(*_recurrence_inputs("cpu", 8, 2048))
    x, x_tail, s, coefs = _section_inputs("cpu", 8, 2048)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.biquad_section(x, 2048, x_tail, s, coefs)


def test_kernel_wrappers_refuse_more_channel_groups_than_a_grid_holds():
    """The gate carries the grid's limit of 65,535 groups of 8 channels:
    524,280 channels pass it, 524,288 do not, and both wrappers refuse such
    a block naming the rule, before they look at its device."""
    assert kernels.section_gate(524280, 1)
    assert not kernels.section_gate(524288, 1)
    with pytest.raises(ValueError, match="multiple of 8 of at most 524280"):
        kernels.iir_tiles(*_recurrence_inputs("cpu", 524288, 1))
    x, x_tail, s, coefs = _section_inputs("cpu", 524288, 1)
    with pytest.raises(ValueError, match="multiple of 8 of at most 524280"):
        kernels.biquad_section(x, 1, x_tail, s, coefs)


def _recurrence_f64(v, s, a1, a2):
    """The recurrence step by step in float64 (float32 coefficients)."""
    a1, a2 = float(a1), float(a2)
    v = v.double().cpu().numpy()
    y = np.empty_like(v)
    y1, y2 = s[:, 0].double().cpu().numpy(), s[:, 1].double().cpu().numpy()
    for n in range(v.shape[1]):
        y[:, n] = v[:, n] - a1 * y1 - a2 * y2
        y1, y2 = y[:, n], y1
    return y


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 1000), (12, 2048), (8, 1024)],
                         ids=["B%256", "C%8", "B<2048"])
def test_kernel_wrapper_refuses_shapes_off_the_gate(cuda, shape):
    """Both wrappers refuse a channel count that is not a multiple of 8 and
    take the other two blocks (a partial last tile, fewer than 2048
    frames): ``iir_tiles`` >= 110 dB from its plain version (the bar of
    :func:`test_iir_kernel_matches_plain`) and >= 90 dB from float64."""
    args = _recurrence_inputs(cuda, *shape)
    x, x_tail, s, coefs = _section_inputs(cuda, *shape)
    if shape[0] % 8:
        with pytest.raises(ValueError, match="C must be a positive multiple of 8"):
            kernels.iir_tiles(*args)
        with pytest.raises(ValueError, match="C must be a positive multiple of 8"):
            kernels.biquad_section(x, shape[1], x_tail, s, coefs)
        return
    y = kernels.iir_tiles(*args)
    assert y.shape == shape
    assert snr_db(_iir_tiles(*args).cpu().numpy(), y.cpu().numpy()) > 110
    assert snr_db(_recurrence_f64(*args), y.cpu().numpy()) >= 90
    y, _, _ = kernels.biquad_section(x, shape[1], x_tail, s, coefs)
    assert y.shape == shape


@pytest.mark.gpu
def test_section_wrapper_refuses_bad_arguments(cuda):
    x, x_tail, s, coefs = _section_inputs(cuda, 8, 2048)
    for frames in (-1, 2049):
        with pytest.raises(ValueError, match="frames"):
            kernels.biquad_section(x, frames, x_tail, s, coefs)
    with pytest.raises(ValueError, match="x_tail"):
        kernels.biquad_section(x, 2048, x_tail.T.contiguous(), s, coefs)
    with pytest.raises(ValueError, match="coefs"):
        kernels.biquad_section(x, 2048, x_tail, s, coefs.double())
    with pytest.raises(ValueError, match="contiguous"):
        kernels.biquad_section(x.T.contiguous().T, 2048, x_tail, s, coefs)
    with pytest.raises(ValueError, match="B >= 1"):
        kernels.biquad_section(x[:, :0].contiguous(), 0, x_tail, s, coefs)


@pytest.mark.gpu
def test_fp32_pinned_on_the_card(cuda):
    """A float32 convolution and matmul on the card agree with float64 far
    beyond TF32's ~50 dB."""
    assert config.fp32_pinned()
    rng = np.random.default_rng(1)
    a = rng.standard_normal((4, 128, 200)).astype(np.float32)
    w = rng.standard_normal((128, 128, 3)).astype(np.float32)
    conv = torch.nn.functional.conv1d(torch.from_numpy(a).to(cuda),
                                      torch.from_numpy(w).to(cuda))
    ref = torch.nn.functional.conv1d(torch.from_numpy(a).double(),
                                     torch.from_numpy(w).double())
    assert snr_db(ref.numpy(), conv.cpu().numpy()) > 120
    m = torch.from_numpy(w[:, :, 0])
    mm = (m.to(cuda) @ m.to(cuda)).cpu()
    assert snr_db((m.double() @ m.double()).numpy(), mm.numpy()) > 120


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 4096), (16, 8192), (64, 10240)])
def test_iir_kernel_matches_plain(cuda, shape):
    """>= 110 dB against the plain version (the JAX suite's bar between
    its recurrence paths); the default path on a CUDA tensor launches the
    kernel exactly once."""
    args = _recurrence_inputs(cuda, *shape, seed=2)
    before = kernels.launch_counts()["iir_tiles"]
    y_kernel = _iir_apply(*args)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["iir_tiles"] == before + 1
    y_plain = _iir_tiles(*args)
    assert snr_db(y_plain.cpu().numpy(), y_kernel.cpu().numpy()) > 110


@pytest.mark.gpu
@pytest.mark.parametrize("refine", [True, False], ids=["refine", "plain"])
@pytest.mark.parametrize("shape", [(8, 4096), (16, 8192), (64, 10240)])
def test_section_kernel_matches_plain(cuda, shape, refine):
    """``kernels.biquad_section`` against the eager section on the card, for
    both EQ sections and blocks valid to B, 6824 (or B - 1), 1 and 0
    frames: the output >= 110 dB, the new ``x_tail`` exactly (it is
    copied), the new ``s`` exactly the kernel's own last two valid outputs
    (the carried state before them) and >= 110 dB from the eager
    section's, the output's own bar. One launch a call."""
    C, B = shape
    rows = (ops.design_peaking_eq(48000, 1000, 1.0, 3.0),
            ops.design_highshelf(48000, 8000, -2.0))
    for row in rows:
        x, x_tail, s, coefs = _section_inputs(cuda, C, B, seed=3, row=row)
        for frames in (B, 6824 if B > 6824 else B - 1, 1, 0):
            before = kernels.launch_counts()["biquad_section"]
            st, y = biquad_section_block({"x_tail": x_tail, "s": s}, x, frames,
                                         coefs, refine=refine)
            torch.cuda.synchronize()
            assert kernels.launch_counts()["biquad_section"] == before + 1
            ref_st, ref = _biquad_section_ref({"x_tail": x_tail, "s": s}, x,
                                              frames, coefs, refine=refine)
            assert snr_db(ref.cpu().numpy(), y.cpu().numpy()) >= 110
            assert torch.equal(st["x_tail"], ref_st["x_tail"])
            y_hist = torch.cat([s.flip(1), y], dim=1)
            assert torch.equal(st["s"], y_hist[:, frames: frames + 2].flip(1))
            assert snr_db(ref_st["s"].cpu().numpy(), st["s"].cpu().numpy()) >= 110
            assert all(v.is_contiguous() and v.shape == (C, 2) for v in st.values())


def _frame_edges(B):
    """Valid lengths at the edges of a block: 0, 1, 2, B - 37 and B."""
    return sorted(f for f in {0, 1, 2, B - 37, B} if 0 <= f <= B)


@pytest.mark.gpu
@pytest.mark.parametrize("refine", [True, False], ids=["refine", "plain"])
@pytest.mark.parametrize("shape", [(64, 640), (8, 1), (8, 37), (8, 255), (8, 257),
                                   (16, 1000), (64, 10240)], ids=str)
def test_section_kernel_partial_tiles_match_plain(cuda, shape, refine):
    """``biquad_section`` on blocks with a partial last tile (or less than
    one tile; B % 4 != 0 takes the scalar stores) and on whole tiles, both
    EQ sections, valid to each of :func:`_frame_edges`: exactly one launch
    a call, the output >= 110 dB from the plain version's, the new
    ``x_tail`` exactly, the new ``s`` exactly the kernel's own last two
    valid outputs and >= 110 dB from the plain version's."""
    C, B = shape
    rows = (ops.design_peaking_eq(48000, 1000, 1.0, 3.0),
            ops.design_highshelf(48000, 8000, -2.0))
    for row in rows:
        x, x_tail, s, coefs = _section_inputs(cuda, C, B, seed=B, row=row)
        for frames in _frame_edges(B):
            before = kernels.launch_counts()["biquad_section"]
            st, y = biquad_section_block({"x_tail": x_tail, "s": s}, x, frames,
                                         coefs, refine=refine)
            torch.cuda.synchronize()
            assert kernels.launch_counts()["biquad_section"] == before + 1
            ref_st, ref = _biquad_section_ref({"x_tail": x_tail, "s": s}, x,
                                              frames, coefs, refine=refine)
            assert y.shape == ref.shape == (C, B) and y.is_contiguous()
            assert snr_db(ref.cpu().numpy(), y.cpu().numpy()) >= 110, (row, frames)
            assert torch.equal(st["x_tail"], ref_st["x_tail"])
            y_hist = torch.cat([s.flip(1), y], dim=1)
            assert torch.equal(st["s"], y_hist[:, frames: frames + 2].flip(1))
            if not torch.equal(st["s"], ref_st["s"]):
                assert snr_db(ref_st["s"].cpu().numpy(), st["s"].cpu().numpy()) >= 110


def _direct_form_f64(x, sos_per_block, B):
    """A cascade in float64, sample by sample, with the port's state (the
    last two inputs and outputs of each section) carried across blocks and
    each block's rows in force for that block."""
    y = x.astype(np.float64)
    for k in range(sos_per_block[0].shape[0]):
        xs = np.zeros((x.shape[0], 2))
        ys = np.zeros((x.shape[0], 2))
        out = np.empty_like(y)
        for n in range(y.shape[1]):
            b0, b1, b2, _, a1, a2 = sos_per_block[n // B][k].astype(np.float64)
            v = b0 * y[:, n] + b1 * xs[:, 0] + b2 * xs[:, 1]
            out[:, n] = v - a1 * ys[:, 0] - a2 * ys[:, 1]
            xs = np.stack([y[:, n], xs[:, 0]], 1)
            ys = np.stack([out[:, n], ys[:, 0]], 1)
        y = out
    return y


@pytest.mark.gpu
def test_partial_tile_stream_with_retune_at_a_block_boundary(cuda):
    """16 blocks of (64, 640) through the two-section cascade on the card,
    the rows retuned from block 8 on: 2 ``biquad_section`` launches a block,
    >= 110 dB against the plain version on the CPU and >= 100 dB against the
    cascade in float64 with the same retune."""
    C, B, n = 64, 640, 16
    sos_a = np.stack([ops.design_peaking_eq(48000, 1000, 1.0, 3.0),
                      ops.design_highshelf(48000, 8000, -2.0)]).astype(np.float32)
    sos_b = np.stack([ops.design_peaking_eq(48000, 500, 1.5, -6.0),
                      ops.design_highshelf(48000, 6000, 2.0)]).astype(np.float32)
    rows = [sos_a if k < 8 else sos_b for k in range(n)]
    x = np.random.default_rng(15).standard_normal((C, n * B)).astype(np.float32)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        state, ys = biquad_init_state(C, 2, dev), []
        before = kernels.launch_counts()
        for k in range(n):
            xb = torch.from_numpy(x[:, k * B:(k + 1) * B]).to(dev)
            state, y = biquad_block(state, xb, B, torch.from_numpy(rows[k]).to(dev))
            ys.append(y.cpu().numpy())
        launched = kernels.launch_counts()["biquad_section"] - before["biquad_section"]
        assert launched == (2 * n if dev.type == "cuda" else 0)
        outs[dev.type] = np.concatenate(ys, 1)
    assert snr_db(outs["cpu"], outs["cuda"]) >= 110
    assert snr_db(_direct_form_f64(x, rows, B), outs["cuda"]) >= 100


@pytest.mark.gpu
def test_console64_pipe_at_588_frames_runs_the_section_kernel(cuda):
    """The live console's chain (64 channels: FIR(255) -> 160/147 resampler
    -> two EQ sections -> 64->2 mix) through ``Pipe`` at 588-frame blocks:
    every EQ block is (64, 640), so each block launches ``biquad_section``
    twice (once a section) on the line's thread and ``iir_tiles`` never, and
    the card's output agrees with the CPU's at >= 100 dB."""
    C, block, n = 64, 588, 24
    x = np.random.default_rng(16).standard_normal((C, n * block - 100)).astype(np.float32)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        got = []
        kernels.reset_counts()
        p = pipe_tpu_torch.Pipe(block, _slice_line(x, got, C), device=dev, lookahead=1)
        p.start()
        p.wait(120)
        by_thread = kernels.launch_counts(by_thread=True)
        if dev.type == "cuda":
            assert by_thread == {"pipe-exec-line0": {"biquad_section": 2 * n}}
        else:
            assert by_thread == {}
        outs[dev.type] = np.concatenate(got, 1)
    assert outs["cuda"].shape == outs["cpu"].shape
    assert snr_db(outs["cpu"], outs["cuda"]) > 100


@pytest.mark.gpu
def test_section_off_the_gate_runs_eager_on_the_card(cuda):
    """A CUDA block that fails the tile gate takes the eager section (the
    prefix-doubling recurrence) and launches no kernel."""
    x, x_tail, s, coefs = _section_inputs(cuda, 2, 512)
    before = kernels.launch_counts()
    st, y = biquad_section_block({"x_tail": x_tail, "s": s}, x, 500, coefs)
    ref_st, ref = _biquad_section_ref({"x_tail": x_tail, "s": s}, x, 500, coefs)
    assert kernels.launch_counts() == before
    assert torch.equal(y, ref) and torch.equal(st["s"], ref_st["s"])


@pytest.mark.gpu
def test_run_without_device_runs_on_the_card(cuda, monkeypatch):
    """With no ``device`` and no default set, ``run`` puts the line's state
    on ``cuda:0``, and ``process`` and ``make_flagship`` work there too."""
    from pipe_tpu_torch.flagship import make_flagship

    monkeypatch.setattr(config, "_default_device", None)
    assert pipe_tpu_torch.default_device() == torch.device("cuda", 0)
    routes = []
    eq = ops.Biquad(ops.design_peaking_eq(48000, 1000, 1.0, 3.0))

    def spy(mctx, block, props):
        proc = eq.processor()(mctx, block, props)
        routes.append(proc)
        return proc

    sink = mock.Sink()
    before = kernels.launch_counts()["biquad_section"]
    pipe_tpu_torch.run(2048, pipe_tpu_torch.Line(
        source=mock.Source(value=0.5, channels=8, limit=3 * 2048).source(),
        processors=[spy], sink=sink.sink()))
    assert kernels.launch_counts()["biquad_section"] == before + 3
    assert routes[0].state[0]["s"].device == torch.device("cuda", 0)
    assert sink.values.shape == (8, 3 * 2048)
    y = pipe_tpu_torch.process(np.ones((8, 4096), np.float32),
                               [eq.processor()], block_size=2048)
    assert y.shape == (8, 4096) and np.isfinite(y).all()
    fn, state, x = make_flagship(channels=8, chunk=147 * 4)
    assert x.device == state[0].device == torch.device("cuda", 0)
    assert fn(state, x)[1].device == torch.device("cuda", 0)


@pytest.mark.gpu
def test_kernel_streams_near_dc_section(cuda):
    """A 20 Hz q=0.5 section at 44.1 kHz over 16 blocks of (8, 2048)
    through the section kernel (1 launch a block): the kernels form the
    impulse responses in float64 as the plain version does, so the stream
    holds the 60 dB that tests/test_torch_biquad.py asks of the CPU path."""
    import scipy.signal

    sos = ops.design_peaking_eq(44100, 20.0, 0.5, 6.0)[None]
    sos = sos / sos[:, 3:4]
    x = np.random.default_rng(5).standard_normal((8, 16 * 2048)).astype(np.float32)
    ref = scipy.signal.sosfilt(sos, x.astype(np.float64), axis=1)
    coefs = torch.tensor(sos, dtype=torch.float32, device=cuda)
    state = biquad_init_state(8, 1, cuda)
    before = kernels.launch_counts()
    ys = []
    for t in range(16):
        xb = torch.from_numpy(x[:, t * 2048:(t + 1) * 2048]).to(cuda)
        state, y = biquad_block(state, xb, 2048, coefs)
        ys.append(y.cpu().numpy())
    after = kernels.launch_counts()
    assert after["biquad_section"] == before["biquad_section"] + 16
    assert after["iir_tiles"] == before["iir_tiles"]
    assert snr_db(ref, np.concatenate(ys, 1)) >= 60


@pytest.mark.gpu
def test_slice_line_on_card_matches_cpu(cuda):
    """The slice's line at 8 channels: the card's output (through the
    section kernel, 2 launches per block) agrees with the CPU's at >= 100
    dB."""
    C, block = 8, 2352
    x = np.random.default_rng(3).standard_normal((C, 3 * block + 500)).astype(np.float32)
    outs = {}
    for device in (cuda, torch.device("cpu")):
        pos, got = [0], []

        def feed(n):
            if pos[0] >= x.shape[1]:
                return None
            pos[0] += n
            return x[:, pos[0] - n: pos[0]]

        line = pipe_tpu_torch.Line(
            source=lambda m, b: pipe_tpu_torch.Source(
                output=SignalProperties(sample_rate=44100.0, channels=C), feed=feed),
            processors=[
                ops.FIR(ops.design_lowpass(255, 4000, 44100)).processor(),
                ops.Resampler(48000, 44100).processor(),
                ops.Biquad(np.stack([ops.design_peaking_eq(48000, 1000, 1.0, 3.0),
                                     ops.design_highshelf(48000, 8000, -2.0)])).processor(),
                ops.ChannelMix(np.ones((2, C)) / C).processor(),
            ],
            sink=lambda m, b, p: pipe_tpu_torch.Sink(receive=got.append),
        )
        before = kernels.launch_counts()
        pipe_tpu_torch.run(block, line, device=device)
        after = kernels.launch_counts()
        launched = after["biquad_section"] - before["biquad_section"]
        assert launched == (8 if device.type == "cuda" else 0)
        assert after["iir_tiles"] == before["iir_tiles"]
        outs[device.type] = np.concatenate(got, 1)
    assert outs["cuda"].shape == outs["cpu"].shape
    assert snr_db(outs["cpu"], outs["cuda"]) > 100


@pytest.mark.gpu
def test_ols_block_on_card_matches_cpu(cuda):
    """BASELINE config 4's OLS step at its shape, (16, 8192) with a
    65,536-tap IR (8 partitions): four chained blocks on the card agree
    with the CPU at >= 110 dB (both float32; cuFFT and the CPU FFT differ
    in rounding order), and the ring head is a host int."""
    from pipe_tpu_torch.ops.ols import ols_block, ols_init_state, partition_ir

    C, B = 16, 8192
    rng = np.random.default_rng(1)
    ir = rng.standard_normal(65536) * np.exp(-np.arange(65536) / 8000)
    spec = torch.from_numpy(partition_ir(ir, B))
    xs = [torch.tensor(rng.standard_normal((C, B)), dtype=torch.float32)
          for _ in range(4)]
    ys = {}
    for dev in (cuda, torch.device("cpu")):
        st, out = ols_init_state(C, B, spec.shape[1], dev), []
        for x in xs:
            st, y = ols_block(st, x.to(dev), B, spec.to(dev))
            out.append(y.cpu().numpy())
        assert isinstance(st["pos"], int) and st["pos"] == 4
        ys[dev.type] = np.concatenate(out, 1)
    assert snr_db(ys["cpu"], ys["cuda"]) > 110


@pytest.mark.gpu
def test_biquad_cascade_launches_twice_per_section(cuda):
    """A fused run of biquads (optimize.fuse -> BiquadCascade) launches the
    section kernel once per section and block (the name dates from the
    form with one launch for each of the forward and refinement passes)
    and agrees with the CPU at >= 100 dB."""
    from pipe_tpu_torch import optimize

    C, B, n_blocks = 16, 8192, 3
    rows = [ops.design_peaking_eq(44100, 1000, 1.0, 3.0),
            np.stack([ops.design_highshelf(44100, 8000, -2.0),
                      ops.design_lowshelf(44100, 200, 2.0)])]
    x = np.random.default_rng(4).standard_normal((C, n_blocks * B)).astype(np.float32)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        eqs = [ops.Biquad(r) for r in rows]
        line = optimize.fuse(pipe_tpu_torch.Line(
            source=None, sink=None, processors=[e.processor() for e in eqs]))
        assert len(line.processors) == 1
        got = []
        before = kernels.launch_counts()["biquad_section"]
        stream_line = pipe_tpu_torch.Line(
            source=lambda m, b: pipe_tpu_torch.Source(
                output=SignalProperties(44100.0, C),
                feed=_array_feed(x)),
            processors=line.processors,
            sink=lambda m, b, p: pipe_tpu_torch.Sink(receive=got.append))
        pipe_tpu_torch.run(B, stream_line, device=dev)
        launched = kernels.launch_counts()["biquad_section"] - before
        assert launched == (3 * n_blocks if dev.type == "cuda" else 0)
        outs[dev.type] = np.concatenate(got, 1)
    assert snr_db(outs["cpu"], outs["cuda"]) > 100


# -- the envelope kernel (compressor, limiter, noise gate) --------------------


SR = 44100.0
ENVELOPE_KINDS = ("gate", "compressor", "limiter")


def _envelope_op(kind, **over):
    """strip64's gate, compressor and limiter (``portbench/configs/
    strip64.json``), with ``over`` in place of their settings."""
    if kind == "gate":
        p = dict(threshold_db=-45.0, range_db=60.0, attack_ms=1.0, release_ms=200.0)
        return ops.NoiseGate(**{**p, **over})
    p = (dict(threshold_db=-18.0, ratio=4.0, attack_ms=3.0, release_ms=120.0, makeup_db=2.0)
         if kind == "compressor" else
         dict(threshold_db=-15.0, ratio=float("inf"), attack_ms=0.2, release_ms=60.0,
              makeup_db=0.0))
    return ops.Compressor(**{**p, **over})


def _envelope_params(op, device):
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in op._p.items()}


def _envelope_plain(op, x, frames, env, env_lo, params):
    """The op's step on the plain path: ``(y, new_env, new_env_lo)``."""
    new0, new_lo, e = envelope_block(
        env, torch.abs(x), frames, _decay_coef(params["release_ms"], SR),
        _attack_oma(params["attack_ms"], SR), env_lo)
    return x * op._gain(e, params), new0, new_lo


def _envelope_kernel(op, x, frames, env, env_lo, params):
    gate = op._kind == "gate"
    return kernels.envelope_block(x, frames, env, env_lo, params["attack_ms"],
                                  params["release_ms"], SR, gate, params["threshold_db"],
                                  params["range_db" if gate else "ratio"],
                                  params.get("makeup_db"))


def _bursts(rng, C, n, seg=300):
    """Noise whose level jumps every ``seg`` frames between -10, -30 and -80
    dBFS: the followers both rise and decay, and a gate both opens and
    closes."""
    levels = rng.choice([0.3, 0.03, 1e-4], size=(C, -(-n // seg)))
    return (rng.standard_normal((C, n)) * np.repeat(levels, seg, 1)[:, :n]).astype(np.float32)


def _gap_threshold(env_db, lo=-60.0, hi=-30.0, margin=1e-3):
    """A gate threshold in the widest gap between the levels ``env_db``
    takes within [lo, hi] dB, at least ``margin`` dB from every one of them.
    The two versions' envelopes differ by a few float32 ulps (~1e-5 dB at
    -45 dB), and log10f by as little: a margin of 1e-3 dB keeps one ulp from
    flipping the gate's branch at any sample."""
    v = np.sort(np.asarray(env_db, np.float64).ravel())
    v = np.concatenate([[lo], v[(v > lo) & (v < hi)], [hi]])
    i = int(np.argmax(np.diff(v)))
    thr = 0.5 * (v[i] + v[i + 1])
    assert 0.5 * (v[i + 1] - v[i]) >= margin, "no threshold keeps the margin"
    return thr


def _level_db(env):
    return 20.0 * np.log10(np.maximum(np.asarray(env, np.float64), 1e-8))


def _envelope_f64(x, settings, device, state=None, frames=None):
    """The op's release follower and smoothed envelope over ``x`` (C, N) in
    float64, one sample at a time: ``settings`` lists ``(first frame,
    params)``, each in force from its frame on; ``state`` is the carried
    (C, 2) (raw, env) (zeros if None); ``x`` counts as zero from ``frames``
    on. The coefficients are the float32 ones the op derives on ``device``
    (torch's exp / expm1 there, which the kernel repeats): on the card
    expf can sit an ulp from the correctly rounded value (it does for the
    gate's 200 ms release), and an ulp of r is k 6e-8 over a decay of k
    frames. What is held to float64 here is the recurrences. Returns
    ``(raw, env)``, both (C, N)."""
    def coefficients(p):
        t = {k: torch.tensor(p[k], dtype=torch.float32, device=device)
             for k in ("release_ms", "attack_ms")}
        return (_decay_coef(t["release_ms"], SR).item(),
                _attack_oma(t["attack_ms"], SR).item())

    x = np.abs(np.asarray(x, np.float64))
    C, N = x.shape
    if frames is not None:
        x[:, frames:] = 0.0
    raw_all, env = np.empty((C, N)), np.empty((C, N))
    raw, e = (np.zeros(C), np.zeros(C)) if state is None else np.asarray(state, np.float64).T
    bounds = [s[0] for s in settings[1:]] + [N]
    for (start, p), stop in zip(settings, bounds):
        r, a = coefficients(p)
        for n in range(start, stop):
            raw = np.maximum(x[:, n], r * raw)
            e = (1.0 - a) * e + a * raw
            raw_all[:, n], env[:, n] = raw, e
    return raw_all, env


def _gain_f64(kind, p, env):
    """The op's gain from its definition, in float64: a gate's 1 at the
    threshold or above, else ``-range_db`` dB; a compressor's hard knee,
    ``ratio`` inf limiting."""
    level = _level_db(env)
    if kind == "gate":
        return np.where(level >= p["threshold_db"], 1.0, 10.0 ** (-p["range_db"] / 20.0))
    slope = 1.0 - 1.0 / max(p["ratio"], 1.0)
    over = np.maximum(level - p["threshold_db"], 0.0)
    return 10.0 ** ((-over * slope + p["makeup_db"]) / 20.0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _envelope_bad_arguments():
    """``(message, arguments)`` cases, each with its id: arguments of
    ``kernels.envelope_block`` with one thing wrong, on the CPU."""
    C, B = 8, 64

    def args(**over):
        a = dict(x=torch.zeros(C, B), frames=B, env=torch.zeros(C, 2),
                 env_lo=torch.zeros(C), attack_ms=torch.tensor(1.0),
                 release_ms=torch.tensor(20.0), sample_rate=SR, gate=False,
                 threshold_db=torch.tensor(-18.0), amount=torch.tensor(4.0),
                 makeup_db=torch.tensor(0.0))
        a.update(over)
        return a

    return [
        pytest.param("must be a CUDA tensor", args(), id="cpu_tensor"),
        pytest.param("float32", args(x=torch.zeros(C, B, dtype=torch.float64)), id="float64_block"),
        pytest.param("contiguous", args(x=torch.zeros(B, C).T), id="non_contiguous_block"),
        pytest.param("release_ms", args(release_ms=torch.zeros(2)), id="param_size"),
        pytest.param("threshold_db", args(threshold_db=torch.zeros(3)), id="gain_param_size"),
        pytest.param("env_lo", args(env_lo=torch.zeros(C + 1)), id="env_lo_size"),
        pytest.param("env", args(env=torch.zeros(2, C)), id="env_shape"),
        pytest.param("must be [(]C, B[)]", args(x=torch.zeros(B)), id="one_dimensional_block"),
        pytest.param("C and B must be >= 1", args(x=torch.zeros(C, 0), frames=0), id="empty_block"),
        pytest.param("takes no makeup_db", args(gate=True), id="gate_with_makeup"),
        pytest.param("needs one", args(makeup_db=None), id="compressor_without_makeup"),
    ]


@pytest.mark.parametrize("message, arguments", _envelope_bad_arguments())
def test_envelope_wrapper_refuses_bad_arguments(message, arguments):
    """No fallback: ``kernels.envelope_block`` raises on what its kernel does
    not take, naming it: the block's shape, each tensor's type, layout and
    size, then the device (a CPU block)."""
    with pytest.raises(ValueError, match=message):
        kernels.envelope_block(**arguments)


@pytest.mark.parametrize("kind", ENVELOPE_KINDS)
def test_envelope_ops_on_the_cpu_take_the_plain_path(kind):
    """On CPU tensors the gate, compressor and limiter run the plain
    ``envelope_block`` and gain (bit for bit, through ``run`` with a partial
    last block) and launch nothing."""
    C, B = 4, 256
    x = _bursts(np.random.default_rng(21), C, 5 * B + 100)
    kernels.reset_counts()
    got = []
    line = pipe_tpu_torch.Line(
        source=lambda m, b: pipe_tpu_torch.Source(output=SignalProperties(SR, C),
                                                  feed=_array_feed(x)),
        processors=[_envelope_op(kind).processor()],
        sink=lambda m, b, p: pipe_tpu_torch.Sink(receive=got.append))
    pipe_tpu_torch.run(B, line, device="cpu")
    assert kernels.launch_counts()["envelope_block"] == 0
    op, cpu = _envelope_op(kind), torch.device("cpu")
    params = _envelope_params(op, cpu)
    env, env_lo, want = torch.zeros(C, 2), torch.zeros(C), []
    for k in range(0, x.shape[1], B):
        blk = torch.zeros(C, B)
        n = min(B, x.shape[1] - k)
        blk[:, :n] = torch.from_numpy(x[:, k:k + n])
        y, env, env_lo = _envelope_plain(op, blk, n, env, env_lo, params)
        want.append(y[:, :n].numpy())
    np.testing.assert_array_equal(np.concatenate(got, 1), np.concatenate(want, 1))


@pytest.mark.gpu
def test_envelope_wrapper_refuses_bad_arguments_on_the_card(cuda):
    C, B = 8, 64
    op = _envelope_op("compressor")
    params = _envelope_params(op, cuda)
    x, env, env_lo = (torch.zeros(C, B, device=cuda), torch.zeros(C, 2, device=cuda),
                      torch.zeros(C, device=cuda))
    for frames in (-1, B + 1):
        with pytest.raises(ValueError, match="frames"):
            _envelope_kernel(op, x, frames, env, env_lo, params)
    with pytest.raises(ValueError, match="env_lo must be on"):
        _envelope_kernel(op, x, B, env, env_lo.cpu(), params)
    params["ratio"] = params["ratio"].cpu()
    with pytest.raises(ValueError, match="amount must be on"):
        _envelope_kernel(op, x, B, env, env_lo, params)


# The plain path's release follower multiplies powers r^(2^j) that compound
# the rounding of r: over a decay of one block (9,408 frames) it reads up to
# 3.05e-5 against float64 at strip64's settings (measured on the CPU on these
# inputs); the kernel walks it in float64 and rounds once a frame. So the
# kernel is held to float64 at 4e-6 and to the plain path at 1e-4.
PLAIN_RTOL = 1e-4
F64_RTOL = 4e-6


def _envelope_block_inputs(C, B, seed):
    rng = np.random.default_rng(seed)
    x = _bursts(rng, C, B)
    env = rng.uniform(0.0, 0.3, (C, 2)).astype(np.float32)
    env_lo = (rng.uniform(-1, 1, C) * 1e-9).astype(np.float32)
    return x, env, env_lo


@pytest.mark.gpu
@pytest.mark.parametrize("partial", [False, True], ids=["whole", "frames<B"])
@pytest.mark.parametrize("shape", [(64, 9408), (64, 588), (8, 1), (3, 1000)])
@pytest.mark.parametrize("kind", ENVELOPE_KINDS)
def test_envelope_kernel_matches_plain(cuda, kind, shape, partial):
    """One block from a carried state (env, env_lo), the kernel against the
    op's float64 recurrences (:func:`_envelope_f64`) and against the plain
    path on the card. The
    output within ``F64_RTOL`` of each sample of ``x`` times the float64
    gain: a float32 envelope a few ulps (1.2e-7 each) from the exact one
    moves a compressor's gain by at most its slope times as much, and
    log10f / powf add theirs; the carried raw and smoothed envelope (eh +
    el) within ``F64_RTOL`` too. Against the plain path ``PLAIN_RTOL`` (its
    follower's rounding, above). The gate's threshold keeps 1e-3 dB from
    every level the float64 envelope takes (:func:`_gap_threshold`), over
    eight times the plain path's 2.6e-4 dB, so its branch is the same at
    every sample in all three."""
    C, B = shape
    frames = (B * 2) // 3 if partial else B
    x, env0, lo0 = _envelope_block_inputs(C, B, C * 100003 + B + partial)
    op = _envelope_op(kind)
    p64 = dict(op._p)
    state64 = np.stack([env0[:, 0], env0[:, 1].astype(np.float64) + lo0], 1)
    raw64, env64 = _envelope_f64(x, [(0, p64)], cuda, state64, frames)
    if kind == "gate":
        p64["threshold_db"] = _gap_threshold(_level_db(env64))
    want = x * _gain_f64(kind, p64, env64)
    last = min(max(frames - 1, 0), B - 1)
    params = _envelope_params(op, cuda)
    params["threshold_db"].fill_(p64["threshold_db"])
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    kernels.reset_counts()
    y, new_env, new_lo = _envelope_kernel(op, t(x), frames, t(env0), t(lo0), params)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["envelope_block"] == 1
    y_p, env_p, lo_p = _envelope_plain(op, t(x), frames, t(env0), t(lo0), params)
    y, y_p = y.cpu().double().numpy(), y_p.cpu().double().numpy()
    new_env, env_p = new_env.cpu().double().numpy(), env_p.cpu().double().numpy()
    whole = new_env[:, 1] + new_lo.cpu().double().numpy()
    whole_p = env_p[:, 1] + lo_p.cpu().double().numpy()
    assert np.all(np.abs(y - want) <= F64_RTOL * np.abs(want))
    np.testing.assert_allclose(new_env[:, 0], raw64[:, last], rtol=F64_RTOL, atol=0)
    np.testing.assert_allclose(whole, env64[:, last], rtol=F64_RTOL, atol=0)
    assert np.all(np.abs(y - y_p) <= PLAIN_RTOL * np.abs(y_p))
    np.testing.assert_allclose(new_env, env_p, rtol=PLAIN_RTOL, atol=0)
    np.testing.assert_allclose(whole, whole_p, rtol=PLAIN_RTOL, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ENVELOPE_KINDS)
def test_envelope_kernel_stream_with_a_retune(cuda, kind):
    """20 blocks of (64, 588), the last one partial, through the op's step on
    the card (the kernel), and the same on the plain path on the card;
    ``op.set`` retunes threshold, attack and release between blocks 9 and
    10. After every block the kernel's carried state is within ``F64_RTOL``
    of the float64 recurrences' at the block's last valid frame, and within
    ``PLAIN_RTOL`` of the plain path's; the kernel's whole stream within
    ``F64_RTOL`` of each sample of the float64 output. The gate's
    thresholds keep 1e-3 dB from the float64 envelope in force."""
    from pipe_tpu_torch import mutable

    C, B, n_blocks, at = 64, 588, 20, 10
    N = n_blocks * B - 200
    x = _bursts(np.random.default_rng(31), C, N)
    retune = dict(attack_ms=0.5, release_ms=40.0,
                  threshold_db={"gate": -50.0, "compressor": -24.0, "limiter": -12.0}[kind])
    first = dict(_envelope_op(kind)._p)
    second = {**first, **retune}
    raw64, env64 = _envelope_f64(x, [(0, first), (at * B, second)], cuda)
    if kind == "gate":
        first["threshold_db"] = _gap_threshold(_level_db(env64[:, :at * B]))
        second["threshold_db"] = retune["threshold_db"] = _gap_threshold(
            _level_db(env64[:, at * B:]))
    want = x * np.concatenate([_gain_f64(kind, first, env64[:, :at * B]),
                               _gain_f64(kind, second, env64[:, at * B:])], 1)
    props = SignalProperties(SR, C, cuda)
    outs, states = {}, {}
    for path in ("kernel", "plain"):
        op = _envelope_op(kind, **first)
        comp = op.processor()(mutable.mutable(), B, props)
        step = (comp.step if path == "kernel" else
                lambda st, p, sig, op=op: _plain_step(op, st, p, sig))
        state, ys, states[path] = comp.state, [], []
        for k in range(n_blocks):
            if k == at:
                op.set(**retune).apply()
            frames = min(B, N - k * B)
            blk = torch.zeros(C, B, device=cuda)
            blk[:, :frames] = torch.from_numpy(x[:, k * B:k * B + frames]).to(cuda)
            state, sig = step(state, comp.params, pipe_tpu_torch.Signal(blk, frames))
            ys.append(sig.data[:, :frames].cpu().numpy())
            env, lo = state["env"].cpu().double().numpy(), state["env_lo"].cpu().double().numpy()
            states[path].append(np.stack([env[:, 0], env[:, 1] + lo], 1))
        outs[path] = np.concatenate(ys, 1)
    for k in range(n_blocks):
        last = min(N, (k + 1) * B) - 1
        np.testing.assert_allclose(states["kernel"][k][:, 0], raw64[:, last],
                                   rtol=F64_RTOL, atol=0, err_msg=f"block {k}")
        np.testing.assert_allclose(states["kernel"][k][:, 1], env64[:, last],
                                   rtol=F64_RTOL, atol=0, err_msg=f"block {k}")
        np.testing.assert_allclose(states["kernel"][k], states["plain"][k],
                                   rtol=PLAIN_RTOL, atol=0, err_msg=f"block {k}")
    assert np.all(np.abs(outs["kernel"] - want) <= F64_RTOL * np.abs(want))
    assert _rel(outs["plain"], want) < 1e-5


def _plain_step(op, state, params, sig):
    y, new0, new_lo = _envelope_plain(op, sig.data, sig.frames, state["env"],
                                      state["env_lo"], params)
    return {"env": new0, "env_lo": new_lo}, sig.with_data(y)


# the name rule of the benchmark's ``biquad_section_roofline``: every
# device kernel it reads
BIQUAD_KERNEL = re.compile(r"(^|::)biquad_")


def _strip64_line(source, sink):
    """The benchmark's strip64 line at its settings (the compressor's
    threshold one of its draws): gate -> 120 Hz low shelf +1.5 dB -> 2 kHz
    peak +3 dB (two ``Biquad`` ops, which ``optimize.fuse`` makes one
    cascade) -> compressor -> limiter -> feedback echo."""
    procs = [
        _envelope_op("gate").processor(),
        ops.Biquad(ops.design_lowshelf(SR, 120.0, 1.5, 1.0).astype(np.float32)).processor(),
        ops.Biquad(ops.design_peaking_eq(SR, 2000.0, 1.0, 3.0).astype(np.float32)).processor(),
        _envelope_op("compressor", threshold_db=-17.0).processor(),
        _envelope_op("limiter").processor(),
        ops.Delay(11025, feedback=0.35, wet=0.25, dry=1.0).processor(),
    ]
    return pipe_tpu_torch.optimize.fuse(
        pipe_tpu_torch.Line(source=source, processors=procs, sink=sink))


@pytest.mark.gpu
def test_strip64_line_launches_the_envelope_kernel_three_times_a_block(cuda):
    """The strip64 cell's line (:func:`_strip64_line`: gate, fused EQ,
    compressor, limiter, echo) on the card: 3 ``envelope_block`` launches a
    block and the fused cascade's 2 ``biquad_section``; in the profiler's
    kernel names the envelope kernel is never one that
    ``biquad_section_roofline``'s rule reads. Its output is within 1e-5 of
    the same line on the CPU: the card's section kernel and the CPU's eager
    section round the 120 Hz shelf's recurrence apart (that shelf sets the
    cell's 3e-5 against float64), the envelope ops differ by their ulps."""
    C, B, n_blocks = 64, 9408, 6
    x = (np.random.default_rng(21).standard_normal((C, n_blocks * B)) * 0.1).astype(np.float32)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        got = []
        line = _strip64_line(
            lambda m, b: pipe_tpu_torch.Source(output=SignalProperties(SR, C),
                                                  feed=_array_feed(x)),
            lambda m, b, p: pipe_tpu_torch.Sink(receive=got.append))
        kernels.reset_counts()
        if dev.type == "cuda":
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                pipe_tpu_torch.run(B, line, device=dev)
                torch.cuda.synchronize()
            counts = kernels.launch_counts()
            assert counts == {"iir_tiles": 0, "biquad_section": 2 * n_blocks,
                              "envelope_block": 3 * n_blocks}
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            envelope = [n for n in names if "envelope_block_kernel" in n]
            assert len(envelope) == 3 * n_blocks
            assert not any(BIQUAD_KERNEL.search(n) for n in envelope)
            assert sum(bool(BIQUAD_KERNEL.search(n)) for n in names) == 3 * 2 * n_blocks
        else:
            pipe_tpu_torch.run(B, line, device=dev)
            assert kernels.launch_counts()["envelope_block"] == 0
        outs[dev.type] = np.concatenate(got, 1)
    assert outs["cuda"].shape == outs["cpu"].shape == x.shape
    assert _rel(outs["cuda"], outs["cpu"]) < 1e-5


def _array_feed(x):
    pos = [0]

    def feed(n):
        if pos[0] >= x.shape[1]:
            return None
        pos[0] += n
        return x[:, pos[0] - n: pos[0]]

    return feed


# -- the kernel module under threads ------------------------------------------


def test_library_builds_once_under_threads(monkeypatch):
    """8 threads asking for the library at once: one build, one load, one
    library object (``build`` and ``CDLL`` stubbed)."""
    builds, loads = [], []

    class FakeLib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    def fake_build():
        builds.append(threading.current_thread().name)
        threading.Event().wait(0.05)  # a slow compiler widens the race
        return kernels.BUILD_DIR / "fake.so"

    def fake_cdll(path):
        loads.append(path)
        return FakeLib()

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "build", fake_build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", fake_cdll)
    got, start = [], threading.Barrier(8)

    def worker():
        start.wait(10)
        got.append(kernels._library())

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(loads) == 1
    assert len(got) == 8 and all(g is got[0] for g in got)


def test_launch_counts_exact_under_threads():
    """9 threads counting 2,000 launches each with a short switch interval,
    a third of them of each kernel: no increment is lost, in total or per
    thread, and each kernel keeps its own count."""
    kernels.reset_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda k=kernels.KERNELS[i % 3]: [
                kernels._count(k) for _ in range(2000)],
            name=f"counter{i}") for i in range(9)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert kernels.launch_counts() == {"iir_tiles": 6000, "biquad_section": 6000,
                                       "envelope_block": 6000}
    assert kernels.launch_counts(by_thread=True) == {
        f"counter{i}": {kernels.KERNELS[i % 3]: 2000} for i in range(9)}
    kernels.reset_counts()
    assert kernels.launch_counts() == {"iir_tiles": 0, "biquad_section": 0,
                                       "envelope_block": 0}
    assert kernels.launch_counts(by_thread=True) == {}


@pytest.mark.gpu
def test_kernel_from_two_threads(cuda):
    """Two threads launching both kernels at once (each call has scratch of
    its own): the exact launch counts, and outputs equal to the same
    launches from one thread."""
    args = [_recurrence_inputs(cuda, 64, 10240, seed=s) for s in (4, 5)]
    sec = [_section_inputs(cuda, 64, 10240, seed=s) for s in (6, 7)]

    def both(i):
        x, x_tail, s, coefs = sec[i]
        return torch.cat([kernels.iir_tiles(*args[i]),
                          kernels.biquad_section(x, 10000, x_tail, s, coefs)[0]])

    single = [both(i) for i in range(2)]
    torch.cuda.synchronize()
    kernels.reset_counts()
    outs = {}

    def worker(i):
        outs[i] = [both(i) for _ in range(20)]

    threads = [threading.Thread(target=worker, args=(i,), name=f"k{i}")
               for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    torch.cuda.synchronize()
    assert not any(t.is_alive() for t in threads)
    assert kernels.launch_counts() == {"iir_tiles": 40, "biquad_section": 40,
                                       "envelope_block": 0}
    assert kernels.launch_counts(by_thread=True) == {
        f"k{i}": {"iir_tiles": 20, "biquad_section": 20} for i in range(2)}
    for i in range(2):
        for y in outs[i]:
            assert torch.equal(y, single[i])


# -- the runtime on the card --------------------------------------------------


def _slice_line(x, out, C, stop=None, start=0):
    pos = [start]
    end = x.shape[1] if stop is None else stop

    def feed(n):
        if pos[0] >= end:
            return None
        c = x[:, pos[0]: min(pos[0] + n, end)]
        pos[0] += c.shape[1]
        return c

    return pipe_tpu_torch.Line(
        source=lambda m, b: pipe_tpu_torch.Source(
            output=SignalProperties(sample_rate=44100.0, channels=C), feed=feed),
        processors=[
            ops.FIR(ops.design_lowpass(255, 4000, 44100)).processor(),
            ops.Resampler(48000, 44100).processor(),
            ops.Biquad(np.stack([ops.design_peaking_eq(48000, 1000, 1.0, 3.0),
                                 ops.design_highshelf(48000, 8000, -2.0)])).processor(),
            ops.ChannelMix(np.ones((2, C)) / C).processor(),
        ],
        sink=lambda m, b, p: pipe_tpu_torch.Sink(receive=out.append),
    )


@pytest.mark.gpu
def test_run_knobs_on_card_match_lookahead_1(cuda):
    """The slice at 64 channels through ``run`` with ``lookahead=4`` and
    ``batch_blocks=4`` equals the one-block-in-flight run (the pinned
    buffers are never reused under a pending copy)."""
    C, block = 64, 147 * 64
    x = np.random.default_rng(6).standard_normal((C, 12 * block + 999)).astype(np.float32)
    outs = {}
    for la, bb in ((1, 1), (4, 4), (4, 1)):
        got = []
        pipe_tpu_torch.run(block, _slice_line(x, got, C), device=cuda,
                           lookahead=la, batch_blocks=bb)
        outs[la, bb] = np.concatenate(got, 1)
    base = outs[1, 1]
    for key in ((4, 4), (4, 1)):
        diff = float(np.max(np.abs(outs[key] - base)))
        print(f"lookahead/batch {key} vs (1, 1): max abs diff {diff:.3g}")
        assert outs[key].shape == base.shape
        assert snr_db(base, outs[key]) >= 120


@pytest.mark.gpu
def test_card_checkpoint_continues_on_cpu(cuda, tmp_path):
    """A checkpoint of a Pipe on the card restores into a CPU Pipe of the
    same lines, which continues the stream to >= 100 dB of the card's own
    continuation."""
    C, block = 8, 2352
    x = np.random.default_rng(8).standard_normal((C, 7 * block + 500)).astype(np.float32)
    head, tail_card = [], []
    stop = 3 * block
    p = pipe_tpu_torch.Pipe(block, _slice_line(x, head, C, stop=stop),
                            device=cuda, lookahead=4)
    p.start()
    p.wait(120)
    path = tmp_path / "card.ckpt.npz"
    checkpoint.snapshot(p).save(str(path))
    p2 = pipe_tpu_torch.Pipe(block, _slice_line(x, tail_card, C, start=stop),
                             device=cuda)
    checkpoint.restore(p2, checkpoint.load(str(path)))
    p2.start()
    p2.wait(120)
    tail_cpu = []
    p3 = pipe_tpu_torch.Pipe(block, _slice_line(x, tail_cpu, C, start=stop),
                             device="cpu")
    checkpoint.restore(p3, checkpoint.load(str(path)))
    assert p3.routes[0].processors[0].state["tail"].device.type == "cpu"
    p3.start()
    p3.wait(120)
    card, cpu = np.concatenate(tail_card, 1), np.concatenate(tail_cpu, 1)
    assert card.shape == cpu.shape
    assert snr_db(card, cpu) >= 100


@pytest.mark.gpu
@pytest.mark.parametrize("lookahead,batch_blocks", [(8, 1), (2, 4)])
def test_pinned_buffers_not_reused_in_flight(cuda, lookahead, batch_blocks):
    """A device slower than the host (each block spins ~1 ms on the card
    first) keeps copies queued behind the host: a pinned staging buffer
    handed out again before its copy ran would corrupt a block. The output
    must equal the input exactly."""
    C, block, n_blocks = 8, 4096, 48
    x = np.random.default_rng(9).standard_normal((C, n_blocks * block)).astype(np.float32)

    def slow(mctx, b, props):
        def step(state, params, sig):
            torch.cuda._sleep(2_000_000)
            return state, sig

        return pipe_tpu_torch.Processor(output=props, step=step)

    out, pos = [], [0]

    def feed(n):
        if pos[0] >= x.shape[1]:
            return None
        pos[0] += n
        return x[:, pos[0] - n: pos[0]]

    pipe_tpu_torch.run(block, pipe_tpu_torch.Line(
        source=lambda m, b: pipe_tpu_torch.Source(
            output=SignalProperties(sample_rate=1.0, channels=C), feed=feed),
        processors=[slow],
        sink=lambda m, b, p: pipe_tpu_torch.Sink(receive=out.append)),
        device=cuda, lookahead=lookahead, batch_blocks=batch_blocks)
    np.testing.assert_array_equal(np.concatenate(out, 1), x)


PRECISIONS = ("highest", "high", "mixed", "default")


@pytest.mark.gpu
def test_precision_knob_does_not_move_the_biquad_on_the_card(cuda):
    """The recursive paths stay IEEE FP32 (or float64) under every precision
    name: the plain tile version, the prefix path, the eager section, the
    extended path and both kernels give the same bits."""
    from pipe_tpu_torch.ops.biquad import (
        biquad_section_block_extended,
        split_f32_pair,
    )

    x, x_tail, s, coefs = _section_inputs(cuda, 8, 2560, seed=5)
    sos = ops.design_peaking_eq(48000, 1000, 1.0, 3.0)
    hi, lo = (torch.tensor(a, device=cuda) for a in split_f32_pair(sos))
    paths = {
        "tiles": lambda: _iir_tiles(x, s, coefs[4], coefs[5]),
        "assoc": lambda: _iir_assoc(x, s, coefs[4], coefs[5]),
        "kernel": lambda: _iir_apply(x, s, coefs[4], coefs[5]),
        "section_ref": lambda: _biquad_section_ref(
            {"x_tail": x_tail, "s": s}, x, 2560, coefs)[1],
        "section_kernel": lambda: kernels.biquad_section(
            x, 2560, x_tail, s, coefs)[0],
        "extended": lambda: biquad_section_block_extended(
            {"x_tail": x_tail, "s": s, "s_lo": torch.zeros_like(s)}, x, 2560,
            hi, lo)[1],
    }
    for what, fn in paths.items():
        outs = []
        for name in PRECISIONS:
            with config.matmul_precision_scope(name):
                outs.append(fn())
        assert all(torch.equal(out, outs[0]) for out in outs[1:]), what
    assert config.fp32_pinned()
    # while a plain float32 product does follow the knob
    a = torch.randn(256, 256, device=cuda)
    with config.matmul_precision_scope("default"):
        tf32 = a @ a
    assert not torch.equal(tf32, a @ a)


@pytest.mark.gpu
def test_high_precision_clears_100_db_on_the_slice(cuda):
    """FIR(255) -> resampler -> EQ -> 64->2 mix at the slice's width: the
    three TF32 products of 'high' stay above 100 dB against float64, and one
    TF32 product ('default') does not."""
    import scipy.signal

    C, block, n_blocks = 64, 9408, 6
    rng = np.random.default_rng(6)
    x = rng.standard_normal((C, n_blocks * block)).astype(np.float32)
    h = ops.design_lowpass(255, 4000, 44100)
    sos = ops.design_peaking_eq(48000, 1000, 1.0, 3.0)

    def f32(a):
        return np.asarray(a, np.float32).astype(np.float64)

    y = scipy.signal.lfilter(f32(h), [1.0], x.astype(np.float64), axis=1)
    y = scipy.signal.upfirdn(f32(ops.polyphase_design(160, 147, 32)).T.reshape(-1),
                             y, up=160, down=147, axis=1)[:, : x.shape[1] * 160 // 147]
    y = scipy.signal.sosfilt(f32(sos)[None, :], y, axis=1)
    oracle = f32(np.ones((2, C)) / C) @ y

    def run():
        return pipe_tpu_torch.process(
            x, [ops.FIR(h).processor(), ops.Resampler(48000, 44100).processor(),
                ops.Biquad(sos).processor(),
                ops.ChannelMix(np.ones((2, C)) / C).processor()],
            block_size=block, device=cuda)

    db = {}
    for name in PRECISIONS:
        with config.matmul_precision_scope(name):
            db[name] = snr_db(oracle, run())
    assert db["highest"] >= 100 and db["high"] >= 100 and db["mixed"] >= 100, db
    assert db["default"] < db["high"], db


def _routed_sites():
    """Every site of the port that goes through ``config.matmul``/``einsum``/
    ``conv1d``, as a function of the cast that makes its tensors."""
    from pipe_tpu_torch.ops import channelizer, fir, fused, mix, resample

    rng = np.random.default_rng(7)
    C, B = 64, 147 * 64
    d = {"x": rng.standard_normal((C, B)), "tail": rng.standard_normal((C, 254)),
         "h": fir.design_lowpass(255, 4000.0, 44100.0),
         "h_short": rng.standard_normal(9), "h_pc": rng.standard_normal((C, 33)),
         "hp": resample.polyphase_design(160, 147, 32),
         "m": rng.standard_normal((2, C)),
         "gp": channelizer.polyphase_branches(channelizer.design_prototype(8, 5), 8)}
    d = {k: np.asarray(v, np.float32) for k, v in d.items()}
    return {
        "mix": lambda t: mix.channel_mix_block(t(d["x"]), t(d["m"])),
        "fir.shared_short": lambda t: fir.fir_apply(
            t(d["tail"][:, :8]), t(d["x"]), t(d["h_short"])),
        "fir.per_channel": lambda t: fir.fir_apply(
            t(d["tail"][:, :32]), t(d["x"]), t(d["h_pc"])),
        "fir.toeplitz": lambda t: fir.fir_apply(t(d["tail"]), t(d["x"]), t(d["h"])),
        "resample.apply": lambda t: resample.resample_apply(
            t(d["tail"][:, :31]), t(d["x"]), t(d["hp"]), 160, 147),
        "resample.gather": lambda t: resample.resample_gather(
            t(d["tail"][:, :31]), 7, 9000, t(d["x"]), t(d["hp"]), 160, 147,
            B * 160 // 147 + 1)[0],
        "fused.combine_bank": lambda t: fused.combine_bank(t(d["h"]), t(d["hp"])),
        "fused.cascade_taps.shared": lambda t: fused.cascade_taps(
            [t(d["h"]), t(d["h_short"])]),
        "fused.cascade_taps.per_channel": lambda t: fused.cascade_taps(
            [t(d["h_pc"]), t(d["h_short"])]),
        "channelizer": lambda t: torch.cat(channelizer.channelize_block(
            t(d["tail"][:, :40]), t(d["x"][:, :8192]), t(d["gp"]), 8), dim=1),
    }


@pytest.mark.gpu
def test_mixed_clears_100_db_and_is_no_worse_than_high_on_the_card(cuda):
    """At every routed site on the card, ``'mixed'`` (five TF32 products)
    stays above 100 dB against float64 and no lower than ``'high'`` (three),
    and differs from ``'high'``: the split of the first operand into three
    terms is on the path."""
    for site, fn in _routed_sites().items():
        ref = fn(lambda a: torch.tensor(a, dtype=torch.float64)).numpy()
        out, db = {}, {}
        for name in ("high", "mixed"):
            with config.matmul_precision_scope(name):
                out[name] = fn(lambda a: torch.tensor(a, device=cuda)).cpu().numpy()
            db[name] = snr_db(ref, out[name])
        assert db["mixed"] >= 100 and db["mixed"] >= db["high"], (site, db)
        assert not np.array_equal(out["mixed"], out["high"]), site


@pytest.mark.gpu
def test_a_highest_line_never_drops_to_single_tf32_products(cuda):
    """Another thread's ``'high'`` sets torch's process-wide flags to TF32.
    A product bound to ``'highest'`` then takes the three products of
    ``'high'`` (equal to them bit for bit), not one TF32 product; and a
    pipe started under ``'highest'`` stays above 100 dB against float64
    when the main thread sets ``'high'`` after block 3."""
    import scipy.signal

    rng = np.random.default_rng(7)
    a = torch.tensor(rng.standard_normal((256, 256)), dtype=torch.float32,
                     device=cuda)
    ref = (a.double() @ a.double()).cpu().numpy()
    config.set_matmul_precision("high")
    try:
        assert not config.fp32_pinned()
        with config.precision_bound("highest"):
            kept = config.matmul(a, a)
        with config.precision_bound("high"):
            high = config.matmul(a, a)
        single = a @ a
    finally:
        config.set_matmul_precision("highest")
    assert torch.equal(kept, high)
    db_kept, db_single = (snr_db(ref, t.cpu().numpy()) for t in (kept, single))
    assert db_kept > db_single + 20, (db_kept, db_single)

    C, block, n_blocks = 16, 4096, 8
    x = rng.standard_normal((C, block * n_blocks)).astype(np.float32)
    h = ops.design_lowpass(255, 4000, 44100)
    m = rng.standard_normal((2, C)).astype(np.float32)
    hold, reached = threading.Event(), threading.Event()
    pos, out = [0], []

    def feed(n):
        if pos[0] == 3 * block:
            reached.set()
            hold.wait(30)
        if pos[0] >= x.shape[1]:
            return None
        pos[0] += n
        return x[:, pos[0] - n:pos[0]]

    p = pipe_tpu_torch.Pipe(block, pipe_tpu_torch.Line(
        source=lambda c, b: pipe_tpu_torch.Source(
            output=SignalProperties(44100.0, C), feed=feed),
        processors=[ops.FIR(h).processor(), ops.ChannelMix(m).processor()],
        sink=lambda c, b, pr: pipe_tpu_torch.Sink(receive=out.append)),
        device=cuda)
    p.start()
    try:
        assert reached.wait(30)
        config.set_matmul_precision("high")
        hold.set()
        p.wait(60)
    finally:
        hold.set()
        config.set_matmul_precision("highest")
    y = np.concatenate(out, axis=1)
    f64 = np.asarray(h, np.float32).astype(np.float64)
    oracle = m.astype(np.float64) @ scipy.signal.lfilter(
        f64, [1.0], x.astype(np.float64), axis=1)
    assert snr_db(oracle, y) > 100


@pytest.mark.gpu
def test_sharded_biquad_stage_launches_the_tile_kernel(cuda):
    """A 1x1 ShardedChain with a BiquadStage on the card launches
    ``iir_tiles`` twice a chunk (the zero-state pass and the defect pass)
    and agrees with the same chain over the plain tile version."""
    from pipe_tpu_torch import parallel
    from pipe_tpu_torch.parallel import chain as chain_mod

    sos = ops.design_peaking_eq(48000, 1000, 1.0, 3.0)
    x = np.random.default_rng(7).standard_normal((16, 3 * 4096)).astype(np.float32)
    mesh = parallel.make_mesh(1, 1)
    chain = parallel.ShardedChain(mesh, [parallel.BiquadStage(sos)], 16, 4096,
                                  device=cuda)
    kernels.reset_counts()
    y = chain.process(x)
    assert kernels.launch_counts() == {"iir_tiles": 6, "biquad_section": 0,
                                       "envelope_block": 0}

    plain = parallel.ShardedChain(mesh, [parallel.BiquadStage(sos)], 16, 4096,
                                  device=cuda)
    real = chain_mod._iir_apply
    chain_mod._iir_apply = _iir_plain
    try:
        kernels.reset_counts()
        y_plain = plain.process(x)
        assert kernels.launch_counts()["iir_tiles"] == 0
    finally:
        chain_mod._iir_apply = real
    assert snr_db(y_plain, y) >= 110
    import scipy.signal

    ref = scipy.signal.sosfilt(sos[None, :], x.astype(np.float64), axis=1)
    assert snr_db(ref, y) >= 100
    # a chunk of any length takes the kernel too: 1000 frames, a partial
    # last tile, launch it twice
    small = parallel.ShardedChain(mesh, [parallel.BiquadStage(sos)], 16, 1000,
                                  device=cuda)
    kernels.reset_counts()
    y_small = small.step(x[:, :1000])
    assert kernels.launch_counts()["iir_tiles"] == 2
    assert snr_db(ref[:, :1000], y_small.cpu().numpy()) >= 100


def _sharded_cases():
    """name -> (stages of parallel, channels, chunk, input kind)."""
    from pipe_tpu_torch import parallel

    rng = np.random.default_rng(11)
    ir = rng.standard_normal(3000) * np.exp(-np.arange(3000) / 600.0)
    lp = ops.design_lowpass(63, 4000, 48000)
    return {
        "ols-single-fft": (lambda: [parallel.OLSStage(ir[:300])], 8, 2048, "noise"),
        "ols-partitioned": (lambda: [parallel.OLSGainStage(ir, 0.5)], 8, 1024, "noise"),
        "compressor": (lambda: [parallel.CompressorStage(-12.0, 3.0, 2.0, 60.0)],
                       8, 2048, "noise"),
        "limiter-gate": (lambda: [parallel.LimiterStage(-6.0, 0.5, 40.0),
                                  parallel.GateStage(-60.0, 60.0, 1.0, 5.0)],
                         8, 2048, "noise"),
        "delay-ladder": (lambda: [parallel.DelayStage(300, feedback=0.6, wet=0.8,
                                                      dry=0.5)], 8, 2048, "noise"),
        "delay-ring": (lambda: [parallel.DelayStage(3000, feedback=0.6, wet=0.8,
                                                    dry=0.5)], 8, 2048, "noise"),
        "delay-pure": (lambda: [parallel.DelayStage(300, wet=1.0, dry=0.25)],
                       8, 2048, "noise"),
        "spectral": (lambda: [parallel.SpectralGainStage(
            256, 64, np.linspace(1.0, 0.1, 129)),
            parallel.SpectralGateStage(256, 64, 8.0, -40.0)], 8, 2048, "noise"),
        "channelizer": (lambda: [parallel.ChannelizerStage(8, 8)], 8, 2048, "noise"),
        "fm-receiver": (lambda: [parallel.IQMixStage(10000.0, 48000.0),
                                 parallel.FIRStage(lp),
                                 parallel.FMDiscriminatorStage()], 8, 2048, "fm"),
        "am-receiver": (lambda: [parallel.IQMixStage(10000.0, 48000.0),
                                 parallel.FIRStage(lp),
                                 parallel.EnvelopeDetectorStage()], 8, 2048, "fm"),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "ols-single-fft", "ols-partitioned", "compressor", "limiter-gate",
    "delay-ladder", "delay-ring", "delay-pure", "spectral", "channelizer",
    "fm-receiver", "am-receiver"])
def test_sharded_stages_on_card_match_cpu(cuda, name):
    """Every stage beyond the main path, on a 1x1 mesh: the chain on the
    card against the same chain on the CPU at >= 100 dB over three chunks,
    its carries back on the host with the CPU chain's shapes and dtypes, and
    no biquad kernel launched."""
    from pipe_tpu_torch import parallel

    stages, C, chunk, kind = _sharded_cases()[name]
    n = 3 * chunk
    if kind == "fm":
        t = np.arange(n) / 48000.0
        x = np.cos(2 * np.pi * 10000.0 * t + 2.0 * np.sin(2 * np.pi * 1000.0 * t))
        x = (np.linspace(0.5, 1.0, C)[:, None] * x).astype(np.float32)
    else:
        x = (0.5 * np.random.default_rng(12).standard_normal((C, n))).astype(
            np.float32)
    mesh = parallel.make_mesh(1, 1)
    on_card = parallel.ShardedChain(mesh, stages(), C, chunk, device=cuda)
    on_cpu = parallel.ShardedChain(mesh, stages(), C, chunk, device="cpu")
    kernels.reset_counts()
    y, y_cpu = on_card.process(x), on_cpu.process(x)
    assert sum(kernels.launch_counts().values()) == 0
    assert y.shape == y_cpu.shape and np.isfinite(y).all()
    assert snr_db(y_cpu, y) >= 100, snr_db(y_cpu, y)
    for got, want in zip(on_card.global_carries(), on_cpu.global_carries()):
        for k in (want if isinstance(want, dict) else ()):
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype


@pytest.mark.gpu
def test_precision_knob_reaches_the_sharded_ols_delay_line(cuda):
    """The partitioned OLS stage's multiply-accumulate goes through
    ``config.einsum``: under ``'high'`` it is three products, so its bits
    move, and it stays above 100 dB against float64 under every name. (Under
    ``'default'`` cuBLAS may or may not take TF32 for this batched
    matrix-vector product of depth K+1: on an H100 with torch 2.11 it read
    the bits of ``'highest'``; no claim is made either way.) The single-FFT
    regime and the recursive stages do not move with the knob."""
    import scipy.signal

    from pipe_tpu_torch import parallel

    rng = np.random.default_rng(13)
    ir = rng.standard_normal(6000) * np.exp(-np.arange(6000) / 1200.0)
    x = rng.standard_normal((8, 4 * 1024)).astype(np.float32)
    ref = scipy.signal.fftconvolve(x.astype(np.float64), ir[None, :],
                                   axes=1)[:, : x.shape[1]]
    mesh = parallel.make_mesh(1, 1)
    db, fixed = {}, {}
    for name in PRECISIONS:
        with config.matmul_precision_scope(name):
            db[name] = snr_db(ref, parallel.ShardedChain(
                mesh, [parallel.OLSStage(ir)], 8, 1024, device=cuda).process(x))
            fixed[name] = parallel.ShardedChain(
                mesh, [parallel.OLSStage(ir[:300]),
                       parallel.CompressorStage(-12.0, 3.0),
                       parallel.DelayStage(300, feedback=0.5)], 8, 1024,
                device=cuda).process(x)
    assert db["highest"] >= 100 and db["high"] >= 100 and db["mixed"] >= 100, db
    assert db["high"] != db["highest"], db  # the knob reaches the delay line
    assert np.isfinite(db["default"]) and db["default"] <= db["highest"] + 0.5, db
    for name in ("high", "mixed", "default"):
        np.testing.assert_array_equal(fixed[name], fixed["highest"])


@pytest.mark.gpu
def test_mesh_pipe_launches_the_tile_kernel_and_equals_the_chain(cuda):
    """``Pipe(mesh=1x1)`` of ``sharded.FIR -> Biquad -> Mix`` at (64, 10240):
    every sharded ``Biquad`` block on the tile gate launches ``iir_tiles``
    exactly twice (2 a section and block), never the one-section kernel, and
    the sink holds the bits of the ``ShardedChain`` of the same stages. A
    ``set_sos`` pushed ``at_block=2`` first changes sample ``2 * 10240``."""
    from pipe_tpu_torch import parallel

    C, B, n = 64, 10240, 4
    x = np.random.default_rng(19).standard_normal((C, n * B)).astype(np.float32)
    h = ops.design_lowpass(63, 4000, 48000)
    sos = ops.design_peaking_eq(48000, 1000, 1.0, 3.0)
    mixm = np.ones((2, C)) / C
    mesh = parallel.make_mesh(1, 1)
    chain = parallel.ShardedChain(
        mesh, [parallel.FIRStage(h), parallel.BiquadStage(sos),
               parallel.MixStage(mixm)], C, B, device=cuda)
    want = chain.process(x)

    def run(push_at=None):
        sh = parallel.sharded
        bq = sh.Biquad(sos)
        pos, out, gate = [0], [], threading.Event()

        def feed(k):
            gate.wait(60)
            if pos[0] >= x.shape[1]:
                return None
            pos[0] += k
            return x[:, pos[0] - k: pos[0]]

        p = pipe_tpu_torch.Pipe(B, pipe_tpu_torch.Line(
            source=lambda m, b: pipe_tpu_torch.Source(
                output=SignalProperties(48000.0, C), feed=feed),
            processors=[sh.FIR(h).processor(), bq.processor(),
                        sh.Mix(mixm).processor()],
            sink=lambda m, b, pr: pipe_tpu_torch.Sink(receive=out.append)),
            mesh=mesh, device=cuda)
        kernels.reset_counts()
        p.start()
        if push_at is not None:
            p.push(bq.set_sos(ops.design_peaking_eq(48000, 1000, 1.0, -3.0)),
                   at_block=push_at)
            dest = p._executors[0].dest
            while dest.pending_targets() != [push_at]:
                threading.Event().wait(0.001)
        gate.set()
        p.wait(120)
        return np.concatenate(out, axis=1), kernels.launch_counts()

    y, launches = run()
    assert launches["iir_tiles"] == 2 * n and launches["biquad_section"] == 0
    assert y.shape == want.shape
    np.testing.assert_array_equal(y, want)
    y_push, launches = run(push_at=2)
    assert launches["iir_tiles"] == 2 * n
    changed = np.flatnonzero(np.any(y_push != y, axis=0))
    assert changed[0] == 2 * B

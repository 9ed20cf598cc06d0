"""Tests of the port that need a CUDA card (marker ``gpu``); they skip on
the CPU. The file imports no JAX, so it runs on a card machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py sets up JAX.) The CPU checks of
the kernel wrapper's input validation and of the kernel module's thread
safety run everywhere."""

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
    biquad_block,
    biquad_init_state,
    biquad_section_block,
)
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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 1000), (12, 2048), (8, 1024)],
                         ids=["B%256", "C%8", "B<2048"])
def test_kernel_wrapper_refuses_shapes_off_the_gate(cuda, shape):
    with pytest.raises(ValueError):
        kernels.iir_tiles(*_recurrence_inputs(cuda, *shape))
    x, x_tail, s, coefs = _section_inputs(cuda, *shape)
    with pytest.raises(ValueError):
        kernels.biquad_section(x, shape[1], x_tail, s, coefs)


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
    before = kernels.iir_tiles_launches
    y_kernel = _iir_apply(*args)
    torch.cuda.synchronize()
    assert kernels.iir_tiles_launches == before + 1
    y_plain = _iir_apply(*args, force="tiles")
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
    """8 threads counting 2,000 launches each with a short switch interval,
    half of them of each kernel: no increment is lost, in total or per
    thread, and each kernel keeps its own count."""
    kernels.reset_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda k=kernels.KERNELS[i % 2]: [
                kernels._count(k) for _ in range(2000)],
            name=f"counter{i}") for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert kernels.launch_counts() == {"iir_tiles": 8000, "biquad_section": 8000}
    assert kernels.iir_tiles_launches == 8000
    assert kernels.launch_counts(by_thread=True) == {
        f"counter{i}": {kernels.KERNELS[i % 2]: 2000} for i in range(8)}
    kernels.reset_counts()
    assert kernels.launch_counts() == {"iir_tiles": 0, "biquad_section": 0}
    assert kernels.iir_tiles_launches == 0
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
    assert kernels.launch_counts() == {"iir_tiles": 40, "biquad_section": 40}
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


PRECISIONS = ("highest", "high", "default")


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
        "tiles": lambda: _iir_apply(x, s, coefs[4], coefs[5], force="tiles"),
        "assoc": lambda: _iir_apply(x, s, coefs[4], coefs[5], force="assoc"),
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
        assert torch.equal(outs[1], outs[0]) and torch.equal(outs[2], outs[0]), what
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
    assert db["highest"] >= 100 and db["high"] >= 100, db
    assert db["default"] < db["high"], db


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
    assert kernels.launch_counts() == {"iir_tiles": 6, "biquad_section": 0}

    plain = parallel.ShardedChain(mesh, [parallel.BiquadStage(sos)], 16, 4096,
                                  device=cuda)
    real = chain_mod._iir_apply
    chain_mod._iir_apply = lambda v, s, a1, a2: real(
        v, s, a1, a2, force="tiles" if kernels.tile_gate(*v.shape) else None)
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
    # a chunk off the tile gate takes the prefix path: no launch, no error
    small = parallel.ShardedChain(mesh, [parallel.BiquadStage(sos)], 16, 1000,
                                  device=cuda)
    kernels.reset_counts()
    small.step(x[:, :1000])
    assert kernels.launch_counts()["iir_tiles"] == 0


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
    assert db["highest"] >= 100 and db["high"] >= 100, db
    assert db["high"] != db["highest"], db  # the knob reaches the delay line
    assert np.isfinite(db["default"]) and db["default"] <= db["highest"] + 0.5, db
    for name in ("high", "default"):
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

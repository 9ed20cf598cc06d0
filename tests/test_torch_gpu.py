"""Tests of the port that need a CUDA card (marker ``gpu``); they skip on
the CPU. The file imports no JAX, so it runs on a card machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest`` because tests/conftest.py sets up JAX.) The CPU checks of
the kernel wrapper's input validation run everywhere."""

import numpy as np
import pytest
import torch

import pipe_tpu_torch
from pipe_tpu_torch import config, kernels, ops
from pipe_tpu_torch.ops.biquad import _iir_apply
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


def test_kernel_wrapper_refuses_cpu_tensors():
    """No fallback: the wrapper raises on what the kernel does not take."""
    with pytest.raises(ValueError, match="CUDA"):
        kernels.iir_tiles(*_recurrence_inputs("cpu", 8, 2048))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 1000), (12, 2048), (8, 1024)],
                         ids=["B%256", "C%8", "B<2048"])
def test_kernel_wrapper_refuses_shapes_off_the_gate(cuda, shape):
    with pytest.raises(ValueError):
        kernels.iir_tiles(*_recurrence_inputs(cuda, *shape))


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
@pytest.mark.parametrize("shape", [(8, 4096), (64, 10240)])
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
def test_slice_line_on_card_matches_cpu(cuda):
    """The slice's line at 8 channels: the card's output (through the
    kernel, 4 launches per block) agrees with the CPU's at >= 100 dB."""
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
        before = kernels.iir_tiles_launches
        pipe_tpu_torch.run(block, line, device=device)
        launched = kernels.iir_tiles_launches - before
        assert launched == (16 if device.type == "cuda" else 0)
        outs[device.type] = np.concatenate(got, 1)
    assert outs["cuda"].shape == outs["cpu"].shape
    assert snr_db(outs["cpu"], outs["cuda"]) > 100

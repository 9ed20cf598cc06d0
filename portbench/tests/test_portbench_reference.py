"""The frozen reference against the port on the CPU, op by op at tiny
sizes, and the CPU rehearsal of every cell through the harness."""

import io
import json

import numpy as np
import pytest

from conftest import SMALL, small_cell
from portbench import reference


def rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def test_polyphase_bank_is_the_ports_design():
    from pipe_tpu_torch.ops.resample import polyphase_design

    for up, down, k in ((160, 147, 32), (3, 2, 16), (147, 160, 8)):
        np.testing.assert_allclose(reference.polyphase_bank(up, down, k),
                                   polyphase_design(up, down, k), rtol=0, atol=1e-12)


def test_tf32_rounds_to_ten_mantissa_bits():
    x = np.array([1.0 + 2.0 ** -12, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0 - 2.0 ** -9, 0.0])
    np.testing.assert_array_equal(reference.tf32(x), [1.0, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -9, 0.0])


def test_ops_against_the_port(cpu_port):
    import torch

    from pipe_tpu_torch.ops.biquad import biquad_block, biquad_init_state
    from pipe_tpu_torch.ops.fir import fir_apply
    from pipe_tpu_torch.ops.ols import ols_block, ols_init_state, partition_ir
    from pipe_tpu_torch.ops.resample import resample_apply
    from portbench.design import f32, lowpass, peaking

    rng = np.random.default_rng(5)
    x = f32(rng.standard_normal((8, 2940)))
    xt = torch.from_numpy(x.astype(np.float32))
    taps = f32(lowpass(255, 4000, 44100))
    y = fir_apply(torch.zeros(8, 254), xt, torch.tensor(taps, dtype=torch.float32))
    assert rel(y.numpy(), reference.convolve(x, taps)) < 1e-5

    bank = f32(reference.polyphase_bank(160, 147, 32))
    z = resample_apply(torch.zeros(8, 31), xt, torch.tensor(bank, dtype=torch.float32), 160, 147)
    assert rel(z.numpy(), reference.resample(x, bank, 160, 147)) < 1e-5

    sos = f32(np.stack([peaking(48000, 1000, 1.0, 6.0), peaking(48000, 300, 0.7, -4.0)]))
    st = biquad_init_state(8, 2)
    outs = []
    for k in range(0, 2940, 588):
        st, o = biquad_block(st, xt[:, k:k + 588], 588, torch.tensor(sos, dtype=torch.float32))
        outs.append(o.numpy())
    assert rel(np.concatenate(outs, 1), reference.biquad_cascade(x, sos, 588)) < 1e-5

    ir = f32(rng.standard_normal(1500) * np.exp(-np.arange(1500) / 300))
    spec = torch.from_numpy(partition_ir(ir, 588))
    st = ols_init_state(8, 588, spec.shape[1])
    outs = []
    for k in range(0, 2940, 588):
        st, o = ols_block(st, xt[:, k:k + 588], 588, spec)
        outs.append(o.numpy())
    assert rel(np.concatenate(outs, 1), reference.convolve(x, ir)) < 1e-5


def test_a_retune_switches_the_rows_at_the_block_boundary():
    from portbench.design import peaking

    x = np.random.default_rng(2).standard_normal((2, 400))
    a, b = peaking(48000, 900, 1.0, 6.0), peaking(48000, 900, 1.0, -6.0)
    sched = np.stack([[a], [a], [b], [b]])
    y = reference.biquad_cascade(x, sched, 100)
    np.testing.assert_allclose(y[:, :200], reference.biquad_cascade(x[:, :200], [a], 100))
    assert not np.allclose(y[:, 200:], reference.biquad_cascade(x, [a], 100)[:, 200:])


def test_a_stretch_from_its_lead_equals_the_whole_stream():
    """The lead that the check runs before a stretch is long enough: the
    same samples computed from the stream's start agree to rounding."""
    from portbench import spec

    for name in ("console64", "reverb16"):
        cell = spec.cell(f"{name}-render", False)
        cfg, mod = cell.config, cell.module
        cfg = dict(cfg, channels=2)
        if "ir" in cfg:
            cfg["ir"] = dict(cfg["ir"], taps=8192)
        block = 9408 if name == "console64" else 8192
        rng = np.random.default_rng(9)
        d = mod.design(cfg, 9, lambda n: rng.standard_normal(n))
        lead = -(-cfg["lead_frames"] // block)
        n_blocks = lead + 4
        x = rng.standard_normal((2, n_blocks * block)) * 0.1
        sos = np.stack([mod.retuned_sos(cfg, d, 0)] * n_blocks)
        whole = mod.reference_output(cfg, d, x, sos, block)
        w = mod.out_width(cfg, block)
        part = mod.reference_output(cfg, d, x[:, 2 * block:], sos[2:], block)
        start = (lead + 2) * w
        assert rel(part[:, start - 2 * w:], whole[:, start:]) < 1e-12


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("trace", [False, True])
def test_cpu_rehearsal_prints_one_result_line(name, trace, cpu_port):
    from portbench import harness

    cell = small_cell(name, trace)
    rc, line, notes = harness.run_cell(name, 2 ** 31 + 11, 0.6, trace, cpu=True, cell=cell)
    out, err = io.StringIO(), io.StringIO()
    harness.emit(line, notes, out, err)
    assert rc == 0
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["failed"] == 0 and last["attempted"] > 0
    assert last["device"]["platform"] == "cpu"
    assert last["checks"]["err"]["value"] < last["checks"]["err"]["limit"]
    tail = err.getvalue().strip().splitlines()[-len(last["checks"]):]
    assert all(t.startswith("check ") for t in tail)
    if trace:
        assert last["device"]["window_s"] > 0  # the stretch was captured
    else:
        assert "setup_s" in last["metrics"]


def test_a_live_cell_behind_real_time_delivers_every_due_block(monkeypatch, cpu_port):
    """Slowed to about two thirds of real time, the open loop still hands
    over every block due in the window, late: none is lost, and the rate
    reads what the program kept up, below the stream's."""
    import time

    from pipe_tpu_torch.runtime.executor import LineExecutor
    from portbench import harness

    cell = small_cell("console64-live")
    fs, block = cell.config["sample_rate_hz"], cell.traffic["block_frames"]
    stage = LineExecutor._stage

    def slow(self, sig, eof):
        time.sleep(1.5 * block / fs)
        return stage(self, sig, eof)

    monkeypatch.setattr(LineExecutor, "_stage", slow)
    seconds = 0.6
    rc, line, _ = harness.run_cell(cell.name, 2 ** 31 + 13, seconds, False, cpu=True, cell=cell)
    assert rc == 0 and line["correct"] is True
    assert line["attempted"] == int(seconds * fs / block) and line["failed"] == 0
    realtime = cell.config["channels"] * fs / 1e6
    assert line["metrics"]["throughput"]["value"] < 0.8 * realtime

"""Each example of ``examples/`` against its port in ``examples/torch/``:
both scripts run on the same inputs (the JAX one in the environment of
``tests/test_examples_smoke.py``, the port's with ``--cpu``), and every
printed number that does not follow the wall clock must agree. Rates,
``StatsRecorder`` reports and the levels that a timed push leaves are
checked for presence only."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
MESH_SCRIPTS = ("sharded_flagship.py", "odd_shapes_and_fusion.py",
                "bursty_network_stream.py")


def _jax_cmd(script, extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["JAX_PLATFORMS"] = "cpu"
    if script in MESH_SCRIPTS:
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    args = [sys.executable, os.path.join(REPO, "examples", script)]
    if script != "multihost_stream.py":  # it forces the CPU itself
        args.append("--cpu")
    return args + extra, env


def _port_cmd(script, extra):
    args = [sys.executable, os.path.join(REPO, "examples", "torch", script), "--cpu"]
    if script == "sharded_flagship.py":
        args += ["--ranks", "8"]
    return args + extra, None


def both(script, tmp_path, jax_extra=(), port_extra=()):
    """Run the JAX example and its port side by side; returns their stdout."""
    procs = {}
    for side, (args, env) in (("jax", _jax_cmd(script, list(jax_extra))),
                              ("port", _port_cmd(script, list(port_extra)))):
        procs[side] = subprocess.Popen(args, env=env, cwd=str(tmp_path), text=True,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    try:
        for side, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            assert p.returncode == 0, (side, stdout, stderr)
            out[side] = stdout
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out["jax"], out["port"]


def grab(pattern, text, cast=float):
    m = re.search(pattern, text)
    assert m, (pattern, text)
    return tuple(cast(g) for g in m.groups()) if len(m.groups()) > 1 else cast(m.group(1))


def test_fm_receiver(tmp_path):
    j, t = both("fm_receiver.py", tmp_path)
    line = r"subband rate (\d+) Hz, (\d+) demodulated samples"
    assert grab(line, j, int) == grab(line, t, int)
    dev = r"recovered deviation ~(\d+) Hz"
    assert abs(grab(dev, j) - grab(dev, t)) <= 1
    corr = r"message correlation ([\d.]+)"
    assert abs(grab(corr, j) - grab(corr, t)) <= 1e-3


def test_reverb_file(tmp_path):
    """The same ``in.wav`` through both scripts: the same frame count
    written, and the two outputs >= 90 dB apart (the 64k-tap OLS bar of
    ``tests/test_ops.py``)."""
    import scipy.io.wavfile

    from pipe_tpu_torch import native
    from pipe_tpu_torch.signal import snr_db

    sr = 44100
    t = np.arange(2 * sr) / sr
    x = 0.5 * np.sin(2 * np.pi * 440.0 * t) * np.exp(-t * 2.0)
    w = native.WavWriter(str(tmp_path / "in.wav"), 2, sr, 32)
    w.write(np.ascontiguousarray(np.stack([x, 0.8 * x]).astype(np.float32).T))
    w.close()
    paths = [str(tmp_path / "in.wav")]
    j, p = both("reverb_file.py", tmp_path, paths + [str(tmp_path / "jax.wav")],
                paths + [str(tmp_path / "port.wav")])
    frames = r"wrote (\d+) frames"
    assert grab(frames, j, int) == grab(frames, p, int) == 2 * sr
    assert "blocks x 4096 frames x 2ch" in j and "blocks x 4096 frames x 2ch" in p
    _, yj = scipy.io.wavfile.read(tmp_path / "jax.wav")
    _, yp = scipy.io.wavfile.read(tmp_path / "port.wav")
    assert yj.shape == yp.shape == (2 * sr, 2)
    db = snr_db(yj.astype(np.float64), yp)
    assert db >= 90, db


def test_mastering_chain(tmp_path):
    j, t = both("mastering_chain.py", tmp_path)
    frames = r"processed (\d+) frames"
    assert grab(frames, j, int) == grab(frames, t, int) == 88200
    for text in (j, t):
        assert "peak after limiter:" in text and "gated tail peak:" in text


def test_live_mixing_desk(tmp_path):
    j, t = both("live_mixing_desk.py", tmp_path)
    for line in (r"line A: (\d+) frames", r"line B: (\d+) frames",
                 r"line C \(added live\): (\d+) frames"):
        assert grab(line, j, int) == grab(line, t, int)
    assert grab(r"line C \(added live\): (\d+) frames", t, int) == 44100
    for text in (j, t):
        assert "levels seen:" in text and "--- throughput ---" in text


def test_sharded_flagship(tmp_path):
    j, t = both("sharded_flagship.py", tmp_path)
    shape = r"out shape \((\d+), (\d+)\)"
    assert grab(shape, j, int) == grab(shape, t, int) == (2, 20480)
    assert "output delta: True" in j and "output delta: True" in t
    assert "Msamples/s" in t


def test_odd_shapes_and_fusion(tmp_path):
    j, t = both("odd_shapes_and_fusion.py", tmp_path)
    for line in (r"block aggregation: (\d+) user", r"stages after fusion: (\d+)",
                 r"out \((\d+), (\d+)\)"):
        assert grab(line, j, int) == grab(line, t, int)
    snr = r"SNR vs oracle: ([\d.]+) dB"
    assert grab(snr, j) >= 100 and grab(snr, t) >= 100


def test_bursty_network_stream(tmp_path):
    j, t = both("bursty_network_stream.py", tmp_path)
    for line in (r"into (\d+) dispatch chunks", r"landed at chunk (\d+)",
                 r"out \((\d+), (\d+)\)"):
        assert grab(line, j, int) == grab(line, t, int)
    snr = r"SNR vs float64 oracle: ([\d.]+) dB"
    assert grab(snr, j) >= 100 and grab(snr, t) >= 100
    assert "packets re-chunked" in t


def test_multihost_stream(tmp_path):
    j, t = both("multihost_stream.py", tmp_path)
    line = re.compile(r"host (\d): (\d+) chunks streamed, SNR ([\d.]+) dB")
    jhosts, thosts = line.findall(j), line.findall(t)
    assert sorted(h for h, _, _ in jhosts) == ["0", "1"], j
    assert sorted(h for h, _, _ in thosts) == ["0", "0", "1", "1"], t
    for _, chunks, snr in jhosts + thosts:
        assert int(chunks) == 200 and float(snr) > 100

"""The strip64 deployment on the CPU: the benchmark's float64 reference of the
mastering strip (``portbench/reference/strip.py``) against loops over single
samples, the port's fused strip against that reference, CPU rehearsals of
the cells ``strip64-render`` and ``reverb16-live`` through the harness, the
envelope ops' span names, and the reference's freedom from the program."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import pipe_tpu_torch
from pipe_tpu_torch import profiling

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.configs import strip64  # noqa: E402
from portbench.reference import strip  # noqa: E402

FS = 44100.0


def rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def config(channels=8):
    with open(os.path.join(ROOT, "portbench", "configs", "strip64.json")) as f:
        cfg = json.load(f)
    cfg["channels"] = channels
    return cfg


# -- (a) the reference's blocked forms against loops over single samples -------


def _signal(n, seed):
    """Noise with bursts and runs of zeros (a closed gate, digital silence)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, n)) * np.repeat(rng.uniform(0, 1, (3, n // 97 + 1)), 97, 1)[:, :n]
    x[:, n // 3:n // 3 + 700] = 0.0
    return x


def test_follower_is_its_recurrence():
    x = np.abs(_signal(3 * strip.FOLLOW + 333, 1))
    for r in (strip64.coefficients(200.0, FS)[0], strip64.coefficients(0.05, FS)[0]):
        want = np.zeros_like(x)
        env = np.zeros(x.shape[0])
        for n in range(x.shape[1]):
            env = np.maximum(x[:, n], r * env)
            want[:, n] = env
        # the loop's own rounding grows an ulp a step while it decays over a
        # run of zeros: 1e-12 covers 700 steps
        np.testing.assert_allclose(strip.follower(x, r), want, rtol=1e-12, atol=0)


def test_one_pole_is_its_recurrence():
    u = np.abs(_signal(9 * strip.SMOOTH + 17, 2))
    for a in (strip64.coefficients(3.0, FS)[1], strip64.coefficients(0.2, FS)[1]):
        want = np.zeros_like(u)
        e = np.zeros(u.shape[0])
        for n in range(u.shape[1]):
            e = (1.0 - a) * e + a * u[:, n]
            want[:, n] = e
        np.testing.assert_allclose(strip.one_pole(u, a), want, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("delay", [1, 7, 250])
def test_echo_is_its_recurrence(delay):
    x = _signal(1003, 3)
    fb, wet, dry = 0.35, 0.25, 1.0
    s = np.zeros((x.shape[0], x.shape[1] + delay))  # s[:, n + delay] is s[n]
    want = np.zeros_like(x)
    for n in range(x.shape[1]):
        s[:, n + delay] = x[:, n] + fb * s[:, n]
        want[:, n] = dry * x[:, n] + wet * s[:, n]
    np.testing.assert_allclose(strip.echo(x, delay, fb, wet, dry), want, rtol=1e-14, atol=1e-16)


def test_gains_are_their_definitions():
    env = np.array([[0.0, 1e-9, 0.001, 0.05, 0.2, 0.9]])
    db = 20 * np.log10(np.maximum(env, 1e-8))
    comp = 10 ** ((-np.maximum(db + 18.0, 0) * 0.75 + 2.0) / 20)
    np.testing.assert_allclose(strip.compressor_gain(env, -18.0, 4.0, 2.0), comp, rtol=1e-14)
    np.testing.assert_allclose(strip.compressor_gain(env, -6.0, np.inf, 0.0),
                               np.minimum(1.0, 10 ** (-6 / 20) / np.maximum(env, 1e-8)),
                               rtol=1e-13)
    np.testing.assert_array_equal(strip.gate_gain(env, -45.0, 60.0),
                                  np.where(db >= -45.0, 1.0, 10 ** -3))


# -- (b) the port's fused strip against the reference ----------------------------


def _run_port(line_of, x, block):
    pos, out = [0], []

    def feed(n):
        if pos[0] >= x.shape[1]:
            return None
        pos[0] += n
        return x[:, pos[0] - n:pos[0]]

    src = lambda m, b: pipe_tpu_torch.Source(  # noqa: E731
        output=pipe_tpu_torch.SignalProperties(FS, x.shape[0]), feed=feed)
    snk = lambda m, b, p: pipe_tpu_torch.Sink(receive=out.append)  # noqa: E731
    pipe_tpu_torch.run(block, line_of(src, snk))
    return np.concatenate(out, 1).astype(np.float64)


def _strip_input(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((8, n)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("stage", ["gate", "gate_closing", "compressor", "limiter", "echo"])
def test_each_stage_of_the_port_against_the_reference(stage):
    """Each nonlinear stage alone, from a zero state over several blocks,
    is within 1e-5 of the float64 reference; ``gate_closing`` feeds the
    gate stretches at -80 dBFS, where it closes (the cell's noise keeps it
    open)."""
    from pipe_tpu_torch import ops

    cfg, block = config(), 1024
    d = strip64.design(cfg, 11)
    x = _strip_input(11, 13 * block + 300)
    if stage == "gate_closing":  # the 200 ms release needs ~0.8 s to fall 36 dB
        x = _strip_input(11, 80 * block)
        x[:, 8000:60000] *= 1e-3
        stage = "gate"
        gain = strip64._dynamics_gain(d["gate"], x.astype(np.float64))
        assert (gain < 1).mean() > 0.1 and (gain == 1).mean() > 0.3
    if stage == "echo":
        e = d["echo"]  # shortened to 2,205 frames: still the ring path at this block
        op = ops.Delay(delay_frames=2205, feedback=e["feedback"], wet=e["wet"], dry=e["dry"])
        want = strip.echo(x, 2205, e["feedback"], e["wet"], e["dry"])
    else:
        p = d[stage]
        knobs = strip64.GATE if stage == "gate" else strip64.COMP
        op = (ops.NoiseGate if stage == "gate" else ops.Compressor)(**strip64._knobs(p, knobs))
        want = x * strip64._dynamics_gain(p, x.astype(np.float64))
    got = _run_port(lambda s, k: pipe_tpu_torch.Line(source=s, processors=[op.processor()],
                                                     sink=k), x, block)
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 5])
def test_the_fused_strip_against_the_reference(seed):
    """The whole line, as the cell builds it, on seeded inputs and
    thresholds. Its error is the 120 Hz shelf's: the float32 pole recurrence
    of a section that close to DC reads about 3e-5 alone, so the bound here
    is 5e-5, and each nonlinear stage is held to 1e-5 above."""
    cfg, block = config(), 1024
    d = strip64.design(cfg, seed)
    x = _strip_input(seed, 16 * block)
    got = _run_port(lambda s, k: strip64.line(pipe_tpu_torch, cfg, d, s, k)[0], x, block)
    want = strip64.reference_output(cfg, d, x.astype(np.float64),
                                    np.stack([d["sos"]] * 16), block)
    assert rel(got, want) < 5e-5
    assert rel(strip64.reference_output(cfg, d, x, np.stack([d["sos"]] * 16), block,
                                        tf32=True), want) > 2e-4


def test_a_stretch_from_its_lead_equals_the_whole_stream():
    """The lead the check runs before a stretch is long enough: the echo's
    zero start has decayed and the envelopes have met the stream's."""
    cfg = config(channels=1)
    d = strip64.design(cfg, 9)
    block = 9408
    lead = -(-cfg["lead_frames"] // block)
    x = np.random.default_rng(9).standard_normal((1, (lead + 3) * block)) * 0.1
    sos = np.stack([d["sos"]] * (lead + 3))
    whole = strip64.reference_output(cfg, d, x, sos, block)
    part = strip64.reference_output(cfg, d, x[:, block:], sos[1:], block)
    start = (lead + 1) * block
    assert rel(part[:, start - block:], whole[:, start:]) < 1e-7


# -- (c), (d) CPU rehearsals of the cells through the harness --------------------


@pytest.fixture(scope="module")
def rehearsals():
    """The cells' CPU rehearsals, run once in a fresh process
    (``tests/torch_strip64_rehearsal.py``): the harness refuses a run whose
    process has loaded JAX, as this one has."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "torch_strip64_rehearsal.py"), "0.6"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    runs = {}
    for text in proc.stdout.splitlines():
        d = json.loads(text)
        runs[tuple(d["case"])] = d
    return runs, proc


def _run(rehearsals, *case):
    runs, proc = rehearsals
    assert case in runs, proc.stderr[-3000:]
    r = runs[case]
    assert r["rc"] == 0, r["notes"]
    return r["line"], r["notes"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", ["strip64-render", "reverb16-live"])
def test_cpu_rehearsal_is_correct(name, trace, rehearsals):
    line, notes = _run(rehearsals, name, None, None, trace)
    assert line["correct"] is True, notes
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["checks"]["err"]["value"] < line["checks"]["err"]["limit"]
    if trace:
        assert line["device"]["window_s"] > 0, notes  # the stretch was captured
        assert 0 <= line["device"]["busy_s"] <= line["device"]["window_s"]
        assert "launches_per_block" not in line["metrics"]  # no CUDA call on the CPU
    else:
        assert set(line["metrics"]) == {"throughput", "setup_s"}


@pytest.mark.parametrize("name", ["strip64-render", "reverb16-live"])
def test_the_tf32_reference_control_is_not_correct(name, rehearsals):
    line, _ = _run(rehearsals, name, "reference_tf32", None, False)
    assert line["correct"] is False
    assert line["checks"]["err"]["value"] > line["checks"]["err"]["limit"]


def test_envelope_state_not_carried_is_not_correct(rehearsals):
    """A fault planted under the timed path: the gate, compressor and
    limiter start every block from a zero envelope."""
    line, _ = _run(rehearsals, "strip64-render", None, "envelope_not_carried", False)
    assert line["correct"] is False
    assert line["checks"]["err"]["value"] > line["checks"]["err"]["limit"]


# -- (e) span names ----------------------------------------------------------------


def test_the_strips_spans_name_each_op():
    """A recorder on a pipe over the strip names the gate, the compressor
    (the limiter included), the fused EQ and the echo; no span carries the
    envelope ops' shared base."""
    cfg, block = config(), 1024
    d = strip64.design(cfg, 5)
    x = _strip_input(5, 6 * block)
    pos, out = [0], []

    def feed(n):
        if pos[0] >= x.shape[1]:
            return None
        pos[0] += n
        return x[:, pos[0] - n:pos[0]]

    src = lambda m, b: pipe_tpu_torch.Source(  # noqa: E731
        output=pipe_tpu_torch.SignalProperties(FS, 8), feed=feed)
    snk = lambda m, b, p: pipe_tpu_torch.Sink(receive=out.append)  # noqa: E731
    stats = profiling.StatsRecorder()
    pipe_tpu_torch.run(block, strip64.line(pipe_tpu_torch, cfg, d, src, snk)[0], stats=stats)
    ops = [s.name for s in stats.spans() if s.name.startswith("op.")]
    assert set(ops) == {"op.NoiseGate", "op.BiquadCascade", "op.Compressor", "op.Delay"}
    assert ops.count("op.Compressor") == 2 * ops.count("op.NoiseGate") == 2 * 6


# -- the reference stays free of the program ----------------------------------------


def _imported_tops(path):
    tree = ast.parse(open(path).read(), filename=path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path, torch_too", [("portbench/reference/strip.py", True),
                                              ("portbench/configs/strip64.py", False)])
def test_the_reference_and_the_configuration_import_nothing_of_the_program(path, torch_too):
    """The strip's reference and its configuration module import neither
    the port nor JAX nor the JAX package (the configuration builds the
    program's line from the package the harness hands it); the reference
    imports no torch either."""
    forbidden = {"pipe_tpu_torch", "jax", "jaxlib", "flax", "pipe_tpu"}
    if torch_too:
        forbidden.add("torch")
    tops = _imported_tops(os.path.join(ROOT, path))
    assert not tops & forbidden, tops

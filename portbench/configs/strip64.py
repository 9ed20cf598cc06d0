"""strip64: noise gate -> low shelf -> peaking EQ -> compressor -> limiter ->
feedback echo on every channel, the line through ``optimize.fuse`` and
``Pipe`` on one card.

Nothing here imports the program: :func:`line` builds from the package it is
handed.
"""

from __future__ import annotations

import importlib

import numpy as np

from portbench import reference
from portbench.design import f32, peaking
from portbench.reference import strip


def low_shelf(rate_hz: float, freq_hz: float, gain_db: float, slope: float) -> np.ndarray:
    """RBJ cookbook low shelf [b0 b1 b2 1 a1 a2]."""
    a = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * np.pi * freq_hz / rate_hz
    c = np.cos(w0)
    alpha = np.sin(w0) / 2.0 * np.sqrt((a + 1.0 / a) * (1.0 / slope - 1.0) + 2.0)
    s2a = 2.0 * np.sqrt(a) * alpha
    b = np.array([a * ((a + 1) - (a - 1) * c + s2a), 2 * a * ((a - 1) - (a + 1) * c),
                  a * ((a + 1) - (a - 1) * c - s2a)])
    den = np.array([(a + 1) + (a - 1) * c + s2a, -2 * ((a - 1) + (a + 1) * c),
                    (a + 1) + (a - 1) * c - s2a])
    return np.concatenate([b / den[0], [1.0], den[1:] / den[0]])


def coefficients(time_ms: float, rate_hz: float) -> tuple:
    """What the program derives in float32 from a time constant: the
    decay ``exp(-1000 / (ms fs))`` and its complement ``-expm1(...)``, each
    rounded to float32 from the float32 exponent."""
    q = np.float32(-1000.0) / (np.float32(max(time_ms, 1e-3)) * np.float32(rate_hz))
    return float(np.float32(np.exp(np.float64(q)))), float(np.float32(-np.expm1(np.float64(q))))


def _dynamics(part: dict, rate_hz: float, threshold_db: float | None = None) -> dict:
    p = {k: float(v) for k, v in part.items() if k != "threshold_db"}
    p["threshold_db"] = float(part["threshold_db"]) if threshold_db is None else threshold_db
    p["release_coef"], _ = coefficients(p["release_ms"], rate_hz)
    _, p["attack_a"] = coefficients(p["attack_ms"], rate_hz)
    return p


def design(cfg: dict, seed: int, draw=None) -> dict:
    """The settings of one run: the example's, with the compressor's and
    the limiter's thresholds drawn from the seed (float32 values)."""
    rng = np.random.default_rng([seed, 1])
    fs = float(cfg["sample_rate_hz"])
    eq = cfg["eq"]
    sh, pk = eq["low_shelf"], eq["peaking"]
    comp_t = float(f32(rng.uniform(*cfg["compressor"]["threshold_db"])))
    lim_t = float(f32(rng.uniform(*cfg["limiter"]["threshold_db"])))
    return {
        "seed": seed,
        "sos": f32(np.stack([low_shelf(fs, sh["freq_hz"], sh["gain_db"], sh["slope"]),
                             peaking(fs, pk["freq_hz"], pk["q"], pk["gain_db"])])),
        "gate": _dynamics(cfg["gate"], fs),
        "compressor": _dynamics(cfg["compressor"], fs, comp_t),
        "limiter": _dynamics(cfg["limiter"], fs, lim_t),
        "echo": dict(cfg["echo"]),
    }


def out_width(cfg: dict, block: int) -> int:
    return block


def eq_shape(cfg: dict, block: int):
    """(channels, frames) of one EQ section call, and calls per block: the
    fused cascade runs the shelf and the peak as two section calls."""
    return cfg["channels"], block, 2


def retuned_sos(cfg: dict, d: dict, landing: int) -> np.ndarray:
    return d["sos"]


def _knobs(p: dict, keys) -> dict:
    return {k: p[k] for k in keys}


GATE = ("threshold_db", "range_db", "attack_ms", "release_ms")
COMP = ("threshold_db", "ratio", "attack_ms", "release_ms", "makeup_db")


def _import_what_the_profiler_imports() -> None:
    """``torch.profiler``'s first start imports ``torch._inductor`` (its
    ``prepare_trace`` asks ``hasattr(torch, "_inductor")``): some 840
    modules. The harness starts the profiler inside the window, on a thread
    of its own, while this line's executor holds the interpreter lock for
    ~870 launch calls a block; the import then took 8 to over 20 s on an
    H100's host, and 3 of 11 traced runs captured no stretch. Imported
    here, in set-up, it is done before the window."""
    importlib.import_module("torch._inductor")


def line(port, cfg: dict, d: dict, source, sink):
    """The example's line, every band its own ``Biquad``, through
    ``optimize.fuse`` (which makes the two bands one cascade)."""
    _import_what_the_profiler_imports()
    ops = port.ops
    e = d["echo"]
    procs = [
        ops.NoiseGate(**_knobs(d["gate"], GATE)).processor(),
        ops.Biquad(d["sos"][0]).processor(),
        ops.Biquad(d["sos"][1]).processor(),
        ops.Compressor(**_knobs(d["compressor"], COMP)).processor(),
        ops.Compressor(**_knobs(d["limiter"], COMP)).processor(),
        ops.Delay(delay_frames=int(e["delay_frames"]), feedback=e["feedback"],
                  wet=e["wet"], dry=e["dry"]).processor(),
    ]
    return port.optimize.fuse(port.Line(source=source, processors=procs, sink=sink)), {}


def _dynamics_gain(p: dict, x) -> np.ndarray:
    env = strip.smoothed_envelope(x, p["release_coef"], p["attack_a"])
    if "range_db" in p:
        return strip.gate_gain(env, p["threshold_db"], p["range_db"])
    return strip.compressor_gain(env, p["threshold_db"], p["ratio"], p["makeup_db"])


def reference_output(cfg: dict, d: dict, x: np.ndarray, sos_blocks: np.ndarray,
                     block: int, tf32: bool = False) -> np.ndarray:
    """The strip over ``x`` (C, n) from a zero state, in float64; with
    ``tf32`` every product reads its operands rounded to TF32."""
    r = reference.tf32 if tf32 else (lambda a: np.asarray(a, np.float64))
    y = r(x)
    y = y * r(_dynamics_gain(d["gate"], y))
    y = reference.biquad_cascade(r(y), sos_blocks, block)
    for part in ("compressor", "limiter"):
        y = r(y)
        y = y * r(_dynamics_gain(d[part], y))
    e = d["echo"]
    return strip.echo(r(y), int(e["delay_frames"]), e["feedback"], e["wet"], e["dry"])

"""console64: FIR(255) low-pass -> 44.1k->48k polyphase resampler -> peaking
EQ -> 64->2 mix, through ``Pipe`` on one card."""

from __future__ import annotations

import numpy as np

from portbench import reference
from portbench.design import f32, lowpass, peaking_row, peaking_sections


def design(cfg: dict, seed: int, draw=None) -> dict:
    """The coefficients of one run, from its seed (float32 values)."""
    rng = np.random.default_rng([seed, 1])
    fir, rs = cfg["fir"], cfg["resample"]
    rate_out = cfg["sample_rate_hz"] * rs["up"] / rs["down"]
    cutoff = fir["cutoff_hz"] * (1.0 + fir["cutoff_jitter"] * rng.uniform(-1, 1))
    theta = rng.uniform(0.0, np.pi / 2, cfg["channels"])
    pan = np.stack([np.cos(theta), np.sin(theta)])
    return {
        "seed": seed,
        "rate_out": rate_out,
        "taps": f32(lowpass(fir["taps"], cutoff, cfg["sample_rate_hz"])),
        "sos": peaking_sections(rng, cfg["eq"], rate_out),
        "mix": f32(pan * np.sqrt(2.0 / cfg["channels"])),
    }


def retuned_sos(cfg: dict, d: dict, landing: int) -> np.ndarray:
    """The EQ rows in force from the ``landing``-th retune on (0: the
    designed rows): the first section re-drawn from the seed."""
    if landing == 0:
        return d["sos"]
    rng = np.random.default_rng([d["seed"], 2, landing])
    sos = d["sos"].copy()
    sos[0] = f32(peaking_row(rng, cfg["eq"], d["rate_out"]))
    return sos


def out_width(cfg: dict, block: int) -> int:
    rs = cfg["resample"]
    return block * rs["up"] // rs["down"]


def eq_shape(cfg: dict, block: int):
    """(channels, frames) of one EQ section call, and calls per block."""
    return cfg["channels"], out_width(cfg, block), cfg["eq"]["sections"]


def line(port, cfg: dict, d: dict, source, sink):
    """The program's line and the handles a retune needs."""
    from pipe_tpu_torch import ops

    rs = cfg["resample"]
    eq = ops.Biquad(d["sos"])
    procs = [
        ops.FIR(d["taps"]).processor(),
        ops.Resampler(rs["up"], rs["down"], rs["taps_per_phase"]).processor(),
        eq.processor(),
        ops.ChannelMix(d["mix"]).processor(),
    ]
    return port.Line(source=source, processors=procs, sink=sink), {"eq": eq}


def retune(handles: dict, sos: np.ndarray):
    """The mutation that puts ``sos`` in force."""
    return handles["eq"].set_sos(sos)


def bank(cfg: dict) -> np.ndarray:
    """The float32 polyphase bank the program derives, worked out again."""
    rs = cfg["resample"]
    return f32(reference.polyphase_bank(rs["up"], rs["down"], rs["taps_per_phase"],
                                        rs["kaiser_beta"]))


def reference_output(cfg: dict, d: dict, x: np.ndarray, sos_blocks: np.ndarray,
                     block: int, tf32: bool = False) -> np.ndarray:
    """The chain over ``x`` (C, n) from a zero state, in float64; with
    ``tf32`` every product reads its operands rounded to TF32."""
    rs = cfg["resample"]
    r = reference.tf32 if tf32 else (lambda a: np.asarray(a, np.float64))
    y = reference.convolve(r(x), r(d["taps"]))
    y = reference.resample(r(y), r(bank(cfg)), rs["up"], rs["down"])
    y = reference.biquad_cascade(y, sos_blocks, out_width(cfg, block))
    return reference.mix(r(y), r(d["mix"]))

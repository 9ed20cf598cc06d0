"""reverb16: a 65,536-tap impulse response through ``ops.OLSConvolve`` ->
peaking EQ, through ``Pipe`` on one card."""

from __future__ import annotations

import numpy as np

from portbench import reference
from portbench.design import f32, peaking_sections


def design(cfg: dict, seed: int, draw) -> dict:
    """The coefficients of one run: noise drawn on the device from the seed
    (``draw(n)``), shaped by the configuration's decay, is the IR."""
    rng = np.random.default_rng([seed, 1])
    n = cfg["ir"]["taps"]
    decay = np.exp(-np.arange(n) / cfg["ir"]["decay_samples"])
    return {
        "seed": seed,
        "ir": f32(draw(n) * decay),
        "sos": peaking_sections(rng, cfg["eq"], cfg["sample_rate_hz"]),
    }


def out_width(cfg: dict, block: int) -> int:
    return block


def eq_shape(cfg: dict, block: int):
    return cfg["channels"], block, cfg["eq"]["sections"]


def line(port, cfg: dict, d: dict, source, sink):
    from pipe_tpu_torch import ops

    eq = ops.Biquad(d["sos"])
    procs = [ops.OLSConvolve(d["ir"]).processor(), eq.processor()]
    return port.Line(source=source, processors=procs, sink=sink), {"eq": eq}


def retuned_sos(cfg: dict, d: dict, landing: int) -> np.ndarray:
    return d["sos"]


def reference_output(cfg: dict, d: dict, x: np.ndarray, sos_blocks: np.ndarray,
                     block: int, tf32: bool = False) -> np.ndarray:
    r = reference.tf32 if tf32 else (lambda a: np.asarray(a, np.float64))
    y = reference.convolve(r(x), r(d["ir"]))
    return reference.biquad_cascade(y, sos_blocks, block)

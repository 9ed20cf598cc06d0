"""Graph optimization passes over Lines: algebraic fusion of adjacent
stages that are mathematically one operator.

The PyTorch counterpart of :mod:`pipe_tpu.optimize`, with the same rules in
the same order (the sharded backend is not ported, so every op is a
streaming op and :func:`_is_sharded` is always False):

- **Biquad cascade**: a run of >= 2 adjacent Biquads with matching
  ``refine`` / ``precision`` becomes one :class:`~pipe_tpu_torch.ops.fused.
  BiquadCascade` (one ``biquad_block`` over the stacked SOS rows).
- **FIR cascade**: a run of >= 2 adjacent FIRs becomes one
  :class:`~pipe_tpu_torch.ops.fused.FIRCascade` with the combined taps
  ``conv(t_0, ..., t_{n-1})``. The last FIR of a run is left out when a
  resampler follows and its taps are 1-D, so the FIR+Resampler rewrite
  still fires on it.
- **FIR + Resampler** -> one combined polyphase bank
  (:class:`~pipe_tpu_torch.ops.fused.FIRResampler`).
- **Gain folding**: a Gain next to a FIR folds into the taps, next to a
  ChannelMix into the matrix (columns for an upstream gain, rows for a
  downstream one), next to an OLSConvolve into the stage output.

Steady-state output is that of the unfused line. One transient differs: a
live ``set_gain`` on a folded ``gain -> FIR`` pair applies the new gain at
the OUTPUT from exactly sample ``N*block`` (the folded form is
``g * (h * x)``), where the unfused pair would carry the old gain through
the filter's (T-1)-sample tail. For ``FIR -> gain``, mix folding and the
biquad cascade, retunes land as in the unfused line.

Retunes keep working through the ORIGINAL objects: every rewrite installs
a delegate, so ``fir.set_taps(...)``, ``gain.set_gain(...)`` or
``eq.set_sos(...)`` after :func:`fuse` update the fused component's
params.

Usage: ``line = pipe_tpu_torch.optimize.fuse(line)``, or
``run(block, line, optimize=True)`` / ``Pipe(block, line, optimize=True)``,
which fuse every line at build.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from pipe_tpu_torch.graph import Line
from pipe_tpu_torch.ops.fused import (
    BiquadCascade,
    FIRCascade,
    FIRResampler,
    FIRWithGain,
    MixWithGain,
    OLSWithGain,
)


def _tag(proc):
    return getattr(proc, "fusion_tag", None)


def _is_sharded(obj) -> bool:
    """Whether ``obj`` is an op of the sharded backend (not ported yet:
    every op is a streaming op). Rules fuse only within one backend."""
    return False


def _bq_key(obj) -> tuple:
    """(backend, refine, extended): biquads fuse only within one key."""
    return _is_sharded(obj), obj._refine, obj._extended


def _pair(procs: List, i: int):
    """The fusion tags of ``procs[i]`` and ``procs[i + 1]``, or None."""
    if i + 1 >= len(procs):
        return None
    ta, tb = _tag(procs[i]), _tag(procs[i + 1])
    if ta is None or tb is None or _is_sharded(ta[1]) != _is_sharded(tb[1]):
        return None
    return ta, tb


def _fuse_biquad_run(procs: List, i: int) -> Optional[tuple]:
    """A maximal run of >= 2 adjacent biquads with matching refine and
    precision -> one cascade."""
    t = _tag(procs[i])
    if t is None or t[0] != "biquad":
        return None
    key = _bq_key(t[1])
    run = [t[1]]
    j = i + 1
    while j < len(procs):
        tj = _tag(procs[j])
        if tj is None or tj[0] != "biquad" or _bq_key(tj[1]) != key:
            break
        run.append(tj[1])
        j += 1
    if len(run) < 2:
        return None
    fused = BiquadCascade(run)
    for p in run:
        p._delegate = fused
    return fused, j - i


def _fuse_fir_resample(procs: List, i: int) -> Optional[tuple]:
    pair = _pair(procs, i)
    if pair is None or (pair[0][0], pair[1][0]) != ("fir", "resample"):
        return None
    fir_obj, rs_obj = pair[0][1], pair[1][1]
    if fir_obj._init_taps.ndim != 1:
        return None
    fused = FIRResampler(fir_obj._init_taps, rs_obj.up, rs_obj.down,
                         taps_per_phase=rs_obj.taps_per_phase)
    fir_obj._delegate = fused
    rs_obj._delegate = fused
    return fused, 2


def _resampler_takes(procs: List, j: int, fir_obj) -> bool:
    """Whether the FIR+Resampler rewrite can fire on ``fir_obj`` followed
    by ``procs[j]``."""
    if j >= len(procs):
        return False
    t = _tag(procs[j])
    return (t is not None and t[0] == "resample"
            and _is_sharded(t[1]) == _is_sharded(fir_obj)
            and fir_obj._init_taps.ndim == 1)


def _fuse_gain_fir(procs: List, i: int) -> Optional[tuple]:
    """(gain, fir) or (fir, gain) -> FIR with the gain folded into its taps
    (they commute per channel)."""
    pair = _pair(procs, i)
    if pair is None:
        return None
    (ka, a), (kb, b) = pair
    if (ka, kb) == ("gain", "fir"):
        gain_obj, fir_obj = a, b
        # leave the FIR to the bigger FIR+Resampler rewrite when it can
        # fire (1-D taps); the gain then stays a stage of its own
        if _resampler_takes(procs, i + 2, fir_obj):
            return None
    elif (ka, kb) == ("fir", "gain"):
        fir_obj, gain_obj = a, b
    else:
        return None
    fused = FIRWithGain(fir_obj._init_taps, gain_obj._init_gain)
    gain_obj._delegate = fused
    fir_obj._delegate = fused
    return fused, 2


def _fuse_fir_run(procs: List, i: int) -> Optional[tuple]:
    """A maximal run of >= 2 adjacent FIRs -> one cascade; the last FIR is
    left out when the FIR+Resampler rewrite can take it."""
    t = _tag(procs[i])
    if t is None or t[0] != "fir":
        return None
    backend = _is_sharded(t[1])
    run = [t[1]]
    j = i + 1
    while j < len(procs):
        tj = _tag(procs[j])
        if tj is None or tj[0] != "fir" or _is_sharded(tj[1]) != backend:
            break
        run.append(tj[1])
        j += 1
    if _resampler_takes(procs, j, run[-1]):
        run = run[:-1]
        j -= 1
    if len(run) < 2:
        return None
    fused = FIRCascade(run)
    for part in run:
        part._delegate = fused.handle_for(part)  # per-slot retunes
    return fused, j - i


def _fuse_gain_ols(procs: List, i: int) -> Optional[tuple]:
    """(gain, ols) or (ols, gain) -> OLS with a folded output gain
    (convolution is linear)."""
    pair = _pair(procs, i)
    if pair is None:
        return None
    (ka, a), (kb, b) = pair
    if (ka, kb) == ("gain", "ols"):
        gain_obj, ols_obj = a, b
    elif (ka, kb) == ("ols", "gain"):
        ols_obj, gain_obj = a, b
    else:
        return None
    fused = OLSWithGain(ols_obj._ir, gain_obj._init_gain)
    gain_obj._delegate = fused
    ols_obj._delegate = fused
    return fused, 2


def _fuse_gain_mix(procs: List, i: int) -> Optional[tuple]:
    """(gain, mix) folds into the matrix columns; (mix, gain) into the
    rows."""
    pair = _pair(procs, i)
    if pair is None:
        return None
    (ka, a), (kb, b) = pair
    if (ka, kb) == ("gain", "mix"):
        gain_obj, mix_obj, side = a, b, "in"
    elif (ka, kb) == ("mix", "gain"):
        mix_obj, gain_obj, side = a, b, "out"
    else:
        return None
    fused = MixWithGain(mix_obj._init_matrix, gain_obj._init_gain, side)
    gain_obj._delegate = fused
    mix_obj._delegate = fused
    return fused, 2


_RULES = (
    _fuse_biquad_run,
    _fuse_fir_run,
    _fuse_fir_resample,
    _fuse_gain_fir,
    _fuse_gain_mix,
    _fuse_gain_ols,
)


def _fuse_pass(procs: List) -> Optional[List]:
    for i in range(len(procs)):
        for rule in _RULES:
            hit = rule(procs, i)
            if hit is not None:
                fused, consumed = hit
                return procs[:i] + [fused.processor()] + procs[i + consumed:]
    return None


def fuse(line: Line) -> Line:
    """A Line with every applicable rewrite applied, to a fixpoint.

    Processor allocators advertise what they are with a ``fusion_tag``
    attribute (set by the op factories); other allocators pass through
    untouched."""
    procs: List = list(line.processors)
    while True:
        new = _fuse_pass(procs)
        if new is None:
            return dataclasses.replace(line, processors=procs)
        procs = new

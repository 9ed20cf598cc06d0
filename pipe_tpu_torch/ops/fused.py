"""Fused stages: the rewrites of :mod:`pipe_tpu_torch.optimize`.

The PyTorch counterpart of :mod:`pipe_tpu.ops.fused`.

- :class:`FIRResampler`: a FIR followed by an L/M polyphase resampler is
  one polyphase bank: with ``h`` the FIR taps and ``hp[p]`` the resampler's
  phase-``p`` subfilter, the combined bank is ``hc[p] = conv(hp[p], h)``
  (``K + T - 1`` taps per phase).
- :class:`FIRWithGain`, :class:`MixWithGain`, :class:`OLSWithGain`: a gain
  folded into the adjacent FIR's taps, mix matrix or OLS output.
- :class:`BiquadCascade`: a run of Biquads as one cascade over the stacked
  SOS rows.
- :class:`FIRCascade`: a run of FIRs as one FIR with the combined taps
  ``conv(t_0, ..., t_{n-1})``.

Every fused stage keeps its members' coefficients as separate live params
and rebuilds the effective coefficients from them every block, so a retune
through an original object (routed here by its delegate) needs no rebuild
hook.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from pipe_tpu_torch.components import Processor, param_tensor
from pipe_tpu_torch.signal import Signal, SignalProperties
from pipe_tpu_torch.ops.biquad import (
    Biquad,
    biquad_block,
    biquad_init_state,
    split_f32_pair,
)
from pipe_tpu_torch.ops.fir import fir_block, fir_init_tail
from pipe_tpu_torch.ops.mix import channel_mix_block
from pipe_tpu_torch.ops.ols import (
    _spec_tensor,
    ols_block,
    ols_init_state,
    partition_ir,
)
from pipe_tpu_torch.ops.resample import (
    Resampler,
    _reduce_ratio,
    polyphase_design,
    resample_apply,
)


def combine_bank(taps, hp):
    """Combined polyphase bank ``hc[p] = conv(hp[p], taps)``: ``taps``
    ``(T,)``, ``hp`` ``(L, K)`` -> ``(L, K + T - 1)``."""
    T = taps.shape[-1]
    out = F.conv1d(hp[:, None, :], torch.flip(taps, (0,))[None, None, :],
                   padding=T - 1)
    return out[:, 0, :]


class FIRResampler:
    """Fused FIR + L/M resampler processor: a drop-in for ``FIR(taps)``
    followed by ``Resampler(up, down)`` with identical output (to f32
    rounding) and one fewer stage. Both the FIR taps and the resampler bank
    stay live parameters."""

    def __init__(self, taps, up: int, down: int, taps_per_phase: int = 32):
        self._taps = param_tensor(taps)
        if self._taps.ndim != 1:
            raise ValueError("FIRResampler uses shared (T,) taps")
        if up <= 0 or down <= 0:
            raise ValueError("up/down must be positive")
        self.up, self.down = _reduce_ratio(up, down)
        self.taps_per_phase = taps_per_phase
        self._hp = param_tensor(
            polyphase_design(self.up, self.down, taps_per_phase)
        )
        self._component = None
        self.context = None

    def processor(self):
        L, M = self.up, self.down
        T = self._taps.shape[0]
        Kc = self.taps_per_phase + T - 1

        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            # reuse the Resampler's streaming step with the combined bank,
            # recombined from the live taps/hp params each block
            inner = Resampler.__new__(Resampler)
            inner.up, inner.down = L, M
            inner.taps_per_phase = Kc
            inner._hp = combine_bank(self._taps, self._hp)
            inner._component = None
            inner.context = None
            comp = inner.processor()(mctx, block_size, props)
            base_step = comp.step

            def step(state, params, sig: Signal):
                hc = combine_bank(params["taps"], params["hp_base"])
                return base_step(state, {"hp": hc}, sig)

            self._component = Processor(
                output=comp.output,
                step=step,
                state=comp.state,
                params={
                    "taps": self._taps.to(props.device),
                    "hp_base": self._hp.to(props.device),
                },
                out_capacity=comp.out_capacity,
            )
            return self._component

        return alloc

    def set_taps(self, taps):
        """Replace the FIR taps (same length)."""
        def fn():
            cur = self._component.get_param("taps")
            self._component.set_param("taps", param_tensor(taps, cur.device))

        return self.context.mutate(fn)

    def set_bank(self, hp):
        """Replace the resampler prototype bank (same shape)."""
        def fn():
            cur = self._component.get_param("hp_base")
            self._component.set_param("hp_base", param_tensor(hp, cur.device))

        return self.context.mutate(fn)


def fused_apply(hist, x, taps, hp, up: int, down: int):
    """Functional fused full-block path for chunk runners: ``hist`` is
    ``(C, K+T-2)`` input history; returns ``(C, B*up//down)``."""
    return resample_apply(hist, x, combine_bank(taps, hp), up, down)


def _check_gain_length(gain, channels: int, what: str) -> None:
    if gain.ndim == 1 and gain.shape[0] != channels:
        raise ValueError(
            f"per-channel gain of length {gain.shape[0]} cannot fold into "
            f"a {channels}-channel {what}"
        )


def scaled_taps(taps, gain):
    """Gain folded into FIR taps: a scalar gain scales the taps; a
    per-channel gain turns shared taps into a per-channel bank. Exact:
    per-channel convolution commutes with per-channel scaling."""
    if gain.ndim == 0:
        return taps * gain
    if taps.ndim == 1:
        return gain[:, None] * taps[None, :]
    return gain[:, None] * taps


def scaled_matrix(matrix, gain, side: str):
    """Gain folded into a mix matrix: an upstream gain scales the COLUMNS
    (``M @ diag(g)``), a downstream gain the ROWS (``diag(g) @ M``)."""
    if gain.ndim == 0:
        return matrix * gain
    return matrix * (gain[None, :] if side == "in" else gain[:, None])


class FIRWithGain:
    """FIR with a folded gain (the ``optimize.fuse`` rewrite of an adjacent
    Gain and FIR, either order: they commute per channel). Taps and gain
    stay live params; the effective taps are rebuilt every block."""

    def __init__(self, taps, gain=1.0):
        self._taps = param_tensor(taps)
        self._gain = param_tensor(gain)
        self._component = None
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props: SignalProperties):
            taps = self._taps
            if taps.ndim == 2 and taps.shape[0] != props.channels:
                raise ValueError(
                    f"per-channel taps for {taps.shape[0]} channels, "
                    f"line has {props.channels}"
                )
            _check_gain_length(self._gain, props.channels, "FIR")
            self.context = mctx

            def step(state, params, sig: Signal):
                hc = scaled_taps(params["taps"], params["gain"])
                new_tail, y = fir_block(state["tail"], sig.data, sig.frames,
                                        hc)
                return {"tail": new_tail}, sig.with_data(y)

            self._component = Processor(
                output=props,
                step=step,
                state={"tail": fir_init_tail(props.channels, taps.shape[-1],
                                             props.device)},
                params={"taps": taps.to(props.device),
                        "gain": self._gain.to(props.device)},
            )
            return self._component

        return alloc

    def set_taps(self, taps):
        return self.context.mutate(
            lambda: self._component.replace_param("taps", taps))

    def set_gain(self, gain):
        return self.context.mutate(
            lambda: self._component.replace_param("gain", gain))


class MixWithGain:
    """Matrix mixer with a folded gain (the ``optimize.fuse`` rewrite of an
    adjacent Gain and ChannelMix): ``side='in'`` folds an upstream gain
    into the matrix columns, ``side='out'`` a downstream gain into the
    rows. Matrix and gain stay independent live params."""

    def __init__(self, matrix, gain=1.0, side: str = "in"):
        if side not in ("in", "out"):
            raise ValueError("side must be 'in' or 'out'")
        self._m = param_tensor(matrix)
        self._gain = param_tensor(gain)
        if self._gain.ndim == 1:
            want = self._m.shape[1] if side == "in" else self._m.shape[0]
            if self._gain.shape[0] != want:
                raise ValueError(
                    f"per-channel gain of length {self._gain.shape[0]} "
                    f"cannot fold into the "
                    f"{'columns' if side == 'in' else 'rows'} of a "
                    f"{tuple(self._m.shape)} matrix (needs {want})"
                )
        self.side = side
        self._component = None
        self.context = None

    def processor(self):
        out_channels, in_channels = self._m.shape
        side = self.side

        def alloc(mctx, block_size, props: SignalProperties):
            if props.channels != in_channels:
                raise ValueError(
                    f"mix matrix expects {in_channels} input channels, "
                    f"line has {props.channels}"
                )
            self.context = mctx

            def step(state, params, sig: Signal):
                m = scaled_matrix(params["matrix"], params["gain"], side)
                return state, Signal(channel_mix_block(sig.data, m),
                                     sig.frames)

            self._component = Processor(
                output=dataclasses.replace(props, channels=out_channels),
                step=step,
                state={},
                params={"matrix": self._m.to(props.device),
                        "gain": self._gain.to(props.device)},
            )
            return self._component

        return alloc

    def set_matrix(self, matrix):
        return self.context.mutate(
            lambda: self._component.replace_param("matrix", matrix))

    def set_gain(self, gain):
        return self.context.mutate(
            lambda: self._component.replace_param("gain", gain))


class BiquadCascade:
    """A run of adjacent Biquad processors as ONE cascade component (the
    ``optimize.fuse`` rewrite): one ``biquad_block`` over the stacked SOS
    rows, so on the card the tile kernel runs twice per section and block
    (forward and refinement pass). Each original ``Biquad`` keeps retuning
    its own rows through :meth:`set_part_sos` (installed as its
    delegate)."""

    def __init__(self, parts):
        """``parts``: the original ``Biquad`` objects, in line order. They
        agree on ``refine`` and ``precision`` (the fuse rule checks)."""
        self._parts = list(parts)
        self._rows = {}  # id(part) -> (start, count)
        start = 0
        for part in self._parts:
            self._rows[id(part)] = (start, part.n_sections)
            start += part.n_sections
        pair = split_f32_pair(np.vstack([p._sos64 for p in self._parts]))
        self._sos = param_tensor(pair[0])
        self._sos_lo = param_tensor(pair[1])
        self._refine = self._parts[0]._refine
        self._extended = self._parts[0]._extended
        self._component = None
        self.context = None

    def processor(self):
        refine, extended = self._refine, self._extended
        S = self._sos.shape[0]

        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx

            def step(state, params, sig: Signal):
                new_state, y = biquad_block(
                    state, sig.data, sig.frames, params["sos"], refine=refine,
                    sections_lo=params["sos_lo"] if extended else None,
                )
                return new_state, sig.with_data(y)

            self._component = Processor(
                output=props,
                step=step,
                state=biquad_init_state(props.channels, S, props.device,
                                        extended=extended),
                params={"sos": self._sos.to(props.device),
                        "sos_lo": self._sos_lo.to(props.device)},
            )
            return self._component

        return alloc

    def set_part_sos(self, part, sos):
        """Mutation updating only ``part``'s rows of the combined SOS (the
        delegate target of a fused-away ``Biquad.set_sos``)."""
        start, count = self._rows[id(part)]
        sos64 = Biquad._normalize(sos)
        if sos64.shape[0] != count:
            raise ValueError(
                f"fused biquad expects {count} section(s) for this part, "
                f"got {sos64.shape[0]}"
            )
        hi, lo = (param_tensor(a) for a in split_f32_pair(sos64))

        def fn():
            for name, rows in (("sos", hi), ("sos_lo", lo)):
                new = self._component.get_param(name).clone()
                new[start: start + count] = rows.to(new.device)
                self._component.set_param(name, new)

        return self.context.mutate(fn)


def _convolve_full(a, b):
    """Full convolution of ``a`` and ``b`` along the last axis: both (T,),
    or both (C, T) row by row."""
    Tb = b.shape[-1]
    if a.ndim == 1:
        return F.conv1d(a[None, None], torch.flip(b, (-1,))[None, None],
                        padding=Tb - 1)[0, 0]
    return F.conv1d(a[None], torch.flip(b, (-1,))[:, None, :],
                    padding=Tb - 1, groups=a.shape[0])[0]


def cascade_taps(parts):
    """Combined impulse response of a run of FIRs: the full convolution of
    their taps along the last axis (per-channel (C, T) rows broadcast
    against shared (T,) vectors)."""
    eff = parts[0]
    for t in parts[1:]:
        if eff.ndim == 2 or t.ndim == 2:
            C = eff.shape[0] if eff.ndim == 2 else t.shape[0]
            eff = eff.expand(C, eff.shape[-1]).contiguous()
            t = t.expand(C, t.shape[-1]).contiguous()
        eff = _convolve_full(eff, t)
    return eff


class _CascadeHandle:
    """The delegate of a fused-away FIR: routes ``set_taps`` to its slot in
    the owning cascade."""

    def __init__(self, cascade, part):
        self._cascade = cascade
        self._part = part

    def set_taps(self, taps):
        return self._cascade.set_part_taps(self._part, taps)


class FIRCascade:
    """A run of adjacent FIR processors as ONE component (the
    ``optimize.fuse`` rewrite). The combined taps ``conv(t_0, ...,
    t_{n-1})`` are rebuilt every block from the member taps, so each
    original ``FIR`` keeps retuning its own slot. Exact: convolution is
    associative."""

    def __init__(self, parts):
        self._parts = list(parts)
        self._taps = [p._init_taps.clone() for p in parts]
        self._slot = {id(p): i for i, p in enumerate(parts)}
        self._component = None
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props: SignalProperties):
            for t in self._taps:
                if t.ndim == 2 and t.shape[0] != props.channels:
                    raise ValueError(
                        f"per-channel taps for {t.shape[0]} channels, "
                        f"line has {props.channels}"
                    )
            self.context = mctx
            n = len(self._taps)
            T_comb = sum(t.shape[-1] for t in self._taps) - (n - 1)

            def step(state, params, sig: Signal):
                hc = cascade_taps([params[f"taps{i}"] for i in range(n)])
                new_tail, y = fir_block(state["tail"], sig.data, sig.frames,
                                        hc)
                return {"tail": new_tail}, sig.with_data(y)

            self._component = Processor(
                output=props,
                step=step,
                state={"tail": fir_init_tail(props.channels, T_comb,
                                             props.device)},
                params={f"taps{i}": t.to(props.device)
                        for i, t in enumerate(self._taps)},
            )
            return self._component

        return alloc

    def set_part_taps(self, part, taps):
        """Mutation updating only ``part``'s slot (the delegate target of a
        fused-away ``FIR.set_taps``)."""
        i = self._slot[id(part)]
        t = param_tensor(taps)
        if t.shape != self._taps[i].shape:
            raise ValueError(
                f"taps shape {tuple(t.shape)} != allocated "
                f"{tuple(self._taps[i].shape)}: live retunes must keep "
                "shapes"
            )

        def fn():
            self._taps[i] = t  # restarts and re-allocations keep the retune
            self._component.replace_param(f"taps{i}", t)

        return self.context.mutate(fn)

    def handle_for(self, part):
        return _CascadeHandle(self, part)


class OLSWithGain:
    """Overlap-save convolution with a folded gain (the ``optimize.fuse``
    rewrite of an adjacent Gain and OLSConvolve, either order: convolution
    is linear). The gain stays a live param applied to the stage output;
    the fold saves one component per block."""

    def __init__(self, ir, gain=1.0):
        self._ir = np.asarray(ir)
        self._gain = param_tensor(gain)
        self._component = None
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            spec = _spec_tensor(self._ir, block_size, props.channels,
                                props.device)
            _check_gain_length(self._gain, props.channels, "line")

            def step(state, params, sig: Signal):
                new_state, y = ols_block(state, sig.data, sig.frames,
                                         params["ir_spec"])
                g = params["gain"]
                if g.ndim == 1:
                    g = g[:, None]
                return new_state, sig.with_data(y * g)

            self._component = Processor(
                output=props,
                step=step,
                state=ols_init_state(props.channels, block_size,
                                     spec.shape[1], props.device),
                params={"ir_spec": spec, "gain": self._gain.to(props.device)},
            )
            return self._component

        return alloc

    def set_ir(self, ir):
        ir = np.asarray(ir)

        def fn():
            block_size = self._component.state["prev"].shape[1]
            self._component.replace_param("ir_spec",
                                          partition_ir(ir, block_size))

        return self.context.mutate(fn)

    def set_gain(self, gain):
        return self.context.mutate(
            lambda: self._component.replace_param("gain", gain))

"""Sharded components: the stage kit behind the Line/Pipe API.

The counterpart of :mod:`pipe_tpu.parallel.components`, exported as
``pipe_tpu_torch.parallel.sharded``. Every stage of the sharded chain is
wrapped as a mutable component allocator with the allocator signature of
the streaming ops, so a ``Line`` built from these runs on a mesh-placed
:class:`~pipe_tpu_torch.runtime.pipe.Pipe` with the runtime's surface
(mutation push, EOF and partial-final-chunk masking, host feed/receive,
start/flush, checkpoints) while the per-chunk compute is the stage's
``apply`` with its collectives. Each factory mirrors its streaming twin in
:mod:`pipe_tpu_torch.ops`: construct, pass ``.processor()`` into a Line,
and use the ``set_*`` methods to build mutations for ``Pipe.push``.

What differs from the JAX module, decided once:

- **What a Processor holds.** The JAX component holds global arrays that
  ``shard_map`` splits. Here every rank is a process, so the allocator
  builds the stage as ``ShardedChain`` does (global host arrays with a
  layout) and gives the ``Processor`` THIS RANK'S tensors:
  ``state = localize(stage.carry, stage.carry_spec)`` and ``params =
  localize(stage.params, stage.param_spec)`` on the line's device. The
  layouts stay on the component (``state_spec``/``param_spec``), so
  checkpoints and ``convert`` go back to global arrays over the pipe's
  mesh. ``Signal.frames`` is the GLOBAL valid count, a host int.
- **A retune takes the global value**, as the user passes it: it is
  zero-padded against the GLOBAL built shape (``stage.params[name]``; a
  channel-padded line), then cut to this rank's block by
  ``param_spec[name]``, then set. No tensor is written in place: a row
  update clones first. ``stage.params`` keeps the built arrays and is read
  for shapes only.
- ``OLS.set_ir`` goes through ``stage.transform_ir``, whose result is
  global (bin-sharded in the partitioned regime) and is cut to the rank's
  block like any other parameter.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from pipe_tpu_torch import config, mutable
from pipe_tpu_torch.components import Processor
from pipe_tpu_torch.errors import ShapeConstraintError
from pipe_tpu_torch.ops.biquad import split_f32_pair
from pipe_tpu_torch.ops.channelizer import polyphase_branches
from pipe_tpu_torch.ops.fused import _CascadeHandle
from pipe_tpu_torch.parallel import chain as _chain
from pipe_tpu_torch.parallel.mesh import CH_AXIS, TIME_AXIS
from pipe_tpu_torch.parallel.meshctx import require_mesh
from pipe_tpu_torch.signal import Signal, SignalProperties


def _local_shape(mesh, channels: int, block_size: int):
    """Local (channels, frames) per rank. Channels pad up to the ch-axis
    multiple (zero rows, sliced off at the sink); a block not divisible by
    the time axis raises the RETRYABLE shape error so the mesh runtime
    re-allocates the line at an aggregated block size."""
    t_shards = mesh.shape[TIME_AXIS]
    ch_shards = mesh.shape[CH_AXIS]
    if block_size % t_shards:
        raise ShapeConstraintError(
            f"block_size {block_size} not divisible by time shards {t_shards}"
        )
    c_pad = -(-channels // ch_shards) * ch_shards
    return c_pad // ch_shards, block_size // t_shards


def _f32(value) -> np.ndarray:
    return np.asarray(value, np.float32)


class ShardedOp:
    """Base adapter: a :class:`~pipe_tpu_torch.parallel.chain.Stage` as a
    mutable Processor allocator. Subclasses provide the stage and any output
    property / frame-count transforms."""

    def __init__(self):
        self._component: Optional[Processor] = None
        self._stage = None
        self._mesh = None
        self._device = None
        self.context: Optional[mutable.Context] = None

    # -- subclass hooks ------------------------------------------------------

    def _make_stage(self, props: SignalProperties) -> "_chain.Stage":
        raise NotImplementedError

    def _out_props(self, props: SignalProperties, stage) -> SignalProperties:
        return props

    def _out_frames(self, frames: int, stage) -> int:
        """Global valid-frame count after this stage (a host int)."""
        return frames

    # -- allocator -----------------------------------------------------------

    #: set by subclasses that participate in optimize.fuse
    fusion_kind: Optional[str] = None

    def processor(self):
        def alloc(mctx: mutable.Context, block_size: int, props: SignalProperties):
            mesh = require_mesh()
            c_local, n_local = _local_shape(mesh, props.channels, block_size)
            ch_shards = mesh.shape[CH_AXIS]
            c_pad = c_local * ch_shards
            stage = self._make_stage(props)
            stage.time_shards = mesh.shape[TIME_AXIS]
            if c_pad != props.channels:
                if not stage.channel_pad_safe:
                    raise ValueError(
                        f"{type(stage).__name__} has a positional channel "
                        f"layout and needs channels divisible by the mesh "
                        f"channel axis ({ch_shards}); got {props.channels}"
                    )
                stage.c_user = props.channels
            stage.out_c_user = None
            stage.build(c_pad, c_local, n_local)
            if stage.out_c_user is None:
                stage.out_c_user = (
                    props.channels if stage.out_c_global == c_pad
                    else stage.out_c_global
                )
            if (
                stage.c_user is not None
                and stage.out_c_global != c_pad
                and stage.out_c_user != stage.out_c_global
            ):
                # a channel-count-CHANGING stage with pad rows in its
                # output: the next allocator would recompute padding from
                # the user count and mismatch the actual tensor
                raise ValueError(
                    f"{type(stage).__name__} changes the channel count on "
                    f"a channel-padded line (channels {props.channels} on "
                    f"a {ch_shards}-way channel axis); pick a channel "
                    "count divisible by the mesh channel axis for this "
                    "stage, or use ShardedChain"
                )
            device = config.resolve_device(props.device)
            self.context = mctx
            self._stage = stage
            self._mesh, self._device = mesh, device
            out_frames = self._out_frames

            def step(state, params, sig: Signal):
                new_carry, y = stage.apply(state, params, sig.data)
                return new_carry, Signal(y, out_frames(sig.frames, stage))

            # Width contract: a stage whose output frame count differs from
            # its input (resampler, channelizer) declares the GLOBAL output
            # width so downstream allocators size to what arrives.
            out_global = stage.out_n_local * mesh.shape[TIME_AXIS]
            comp = Processor(
                output=self._out_props(props, stage),
                step=step,
                state=_chain.localize(mesh, device, stage.carry,
                                      stage.carry_spec),
                params=_chain.localize(mesh, device, dict(stage.params),
                                       dict(stage.param_spec)),
                out_capacity=None if out_global == block_size else out_global,
            )
            comp.state_spec = stage.carry_spec
            comp.param_spec = stage.param_spec
            if getattr(stage, "reduces_channels", False):
                comp.reduces_channels = True
            self._component = comp
            return comp

        if self.fusion_kind is not None:
            alloc.fusion_tag = (self.fusion_kind, self)
        return alloc

    def _pad_param(self, name, value: np.ndarray) -> np.ndarray:
        """Zero-pad a live per-channel param value (GLOBAL, as the user
        passes it) along its CH_AXIS-sharded axis when the stage was
        channel-padded at build: the mutation twin of
        ``Stage.pad_channels``. Compared with the global built shape."""
        stage = self._stage
        if stage is None or stage.c_user is None:
            return value
        built = tuple(np.shape(stage.params[name]))
        if value.shape == built:
            return value
        spec = stage.param_spec.get(name)
        axes = tuple(spec.axes) if spec is not None else ()
        for ax, ax_name in enumerate(axes):
            if (
                ax_name == CH_AXIS
                and ax < value.ndim
                and value.shape[ax] < built[ax]
                and value.shape[:ax] + value.shape[ax + 1:]
                == built[:ax] + built[ax + 1:]
            ):
                pad_shape = list(value.shape)
                pad_shape[ax] = built[ax] - value.shape[ax]
                return np.concatenate(
                    [value, np.zeros(pad_shape, value.dtype)], axis=ax
                )
        return value

    def _localize_param(self, name, value: np.ndarray):
        """This rank's block of the global ``value`` of param ``name``."""
        return _chain.localize(self._mesh, self._device, value,
                               self._stage.param_spec[name])

    def _set_params(self, **vals) -> mutable.Mutation:
        """A mutation updating parameters from GLOBAL values (same shapes;
        per-channel values pad to the built channel count on padded lines,
        then each rank keeps its block)."""

        def fn():
            for k, v in vals.items():
                self._component.set_param(
                    k, self._localize_param(k, self._pad_param(k, _f32(v))))

        return self.context.mutate(fn)


class Gain(ShardedOp):
    """Elementwise gain; scalar or per-channel vector (sharded with the
    channel rows)."""

    fusion_kind = "gain"

    def __init__(self, gain=1.0):
        super().__init__()
        self._gain = gain
        self._delegate = None  # set by pipe_tpu_torch.optimize.fuse

    def _make_stage(self, props):
        return _chain.GainStage(self._gain)

    def set_gain(self, gain) -> mutable.Mutation:
        if self._delegate is not None:  # folded away by optimize.fuse
            return self._delegate.set_gain(gain)
        return self._set_params(gain=_f32(gain))


class FIR(ShardedOp):
    """FIR filter with a (T-1)-sample halo between time shards. ``taps`` is
    (T,) shared or (C, T) per-channel."""

    fusion_kind = "fir"

    def __init__(self, taps):
        super().__init__()
        self._taps = np.asarray(taps)
        self._delegate = None  # set by pipe_tpu_torch.optimize.fuse

    def _make_stage(self, props):
        return _chain.FIRStage(self._taps)

    def set_taps(self, taps) -> mutable.Mutation:
        if self._delegate is not None:  # fused away by optimize.fuse
            return self._delegate.set_taps(taps)
        new = _f32(taps)
        if new.shape != tuple(np.shape(self._taps)):
            raise ValueError(
                f"taps shape {new.shape} != allocated {np.shape(self._taps)}: "
                "live retunes must keep shapes (or recompiles would glitch "
                "the stream)"
            )
        return self._set_params(taps=new)


class Resample(ShardedOp):
    """Polyphase L/M resampler; every time shard emits an equal static
    output count (``n_local * L % M == 0`` checked at build)."""

    fusion_kind = "resample"

    def __init__(self, up: int, down: int, taps_per_phase: int = 32):
        super().__init__()
        self._args = (up, down, taps_per_phase)

    def _make_stage(self, props):
        return _chain.ResampleStage(*self._args)

    def _out_props(self, props, stage):
        return SignalProperties(
            sample_rate=props.sample_rate * stage.up / stage.down,
            channels=props.channels,
        )

    def _out_frames(self, frames, stage):
        return frames * stage.up // stage.down


class FIRResample(ShardedOp):
    """Fused FIR + polyphase resample: one combined bank, one halo."""

    def __init__(self, taps, up: int, down: int, taps_per_phase: int = 32):
        super().__init__()
        self._taps = np.asarray(taps)
        self._args = (up, down, taps_per_phase)

    def _make_stage(self, props):
        return _chain.FIRResampleStage(self._taps, *self._args)

    def _out_props(self, props, stage):
        return SignalProperties(
            sample_rate=props.sample_rate * stage.up / stage.down,
            channels=props.channels,
        )

    def _out_frames(self, frames, stage):
        return frames * stage.up // stage.down

    def set_taps(self, taps) -> mutable.Mutation:
        """Retune the FIR half of the fused bank (same shape)."""
        new = _f32(taps)
        if new.shape != tuple(np.shape(self._taps)):
            raise ValueError(
                f"taps shape {new.shape} != allocated {np.shape(self._taps)}"
            )
        return self._set_params(taps=new)

    def set_bank(self, hp) -> mutable.Mutation:
        """Retune the resampler half of the fused bank (same shape)."""
        return self._set_params(hp=_f32(hp))


def _pad_ir_rows(op, ir: np.ndarray) -> np.ndarray:
    """Zero-pad a per-channel IR to the stage's built (padded) channel
    count before re-transforming it (the ``set_ir`` twin of the build-time
    padding)."""
    stage = op._stage
    if stage is None or stage.c_user is None or ir.ndim != 2:
        return ir
    c_built = stage._ir.shape[0]
    if ir.shape[0] >= c_built:
        return ir
    return np.concatenate(
        [ir, np.zeros((c_built - ir.shape[0], ir.shape[1]), ir.dtype)],
        axis=0,
    )


class OLS(ShardedOp):
    """Overlap-save FFT convolution (long IRs / reverb), time-sharded."""

    fusion_kind = "ols"

    def __init__(self, ir):
        super().__init__()
        self._ir = np.asarray(ir)
        self._delegate = None  # set by pipe_tpu_torch.optimize.fuse

    def _make_stage(self, props):
        return _chain.OLSStage(self._ir)

    def _set_ir(self, new: np.ndarray) -> mutable.Mutation:
        if new.shape != self._ir.shape:
            raise ValueError(
                f"IR shape {new.shape} != allocated {self._ir.shape}"
            )

        def fn():
            ir_f = self._stage.transform_ir(_pad_ir_rows(self, new))
            self._component.set_param(
                "ir_f", self._localize_param("ir_f", ir_f))

        return self.context.mutate(fn)

    def set_ir(self, ir) -> mutable.Mutation:
        """Swap the impulse response mid-stream (same length)."""
        if self._delegate is not None:  # fused away by optimize.fuse
            return self._delegate.set_ir(ir)
        return self._set_ir(np.asarray(ir))


class OLSGain(OLS):
    """OLS with a folded gain (``optimize.fuse`` rewrite of an adjacent
    Gain + OLS pair, either order)."""

    fusion_kind = None

    def __init__(self, ir, gain=1.0):
        super().__init__(ir)
        self._gain = _f32(gain)

    def _make_stage(self, props):
        return _chain.OLSGainStage(self._ir, self._gain)

    def set_gain(self, gain) -> mutable.Mutation:
        return self._set_params(gain=_f32(gain))


class FIRCascade(ShardedOp):
    """A run of FIRs as one sharded stage (``optimize.fuse`` rewrite);
    each original ``FIR`` keeps retuning its own slot via the installed
    per-part delegate."""

    def __init__(self, parts):
        super().__init__()
        self._parts = list(parts)
        self._slot = {id(p): i for i, p in enumerate(parts)}
        self._shapes = [np.shape(p._taps) for p in parts]

    def _make_stage(self, props):
        return _chain.FIRCascadeStage([p._taps for p in self._parts])

    def set_part_taps(self, part, taps) -> mutable.Mutation:
        i = self._slot[id(part)]
        t = _f32(taps)
        if t.shape != tuple(self._shapes[i]):
            raise ValueError(
                f"taps shape {t.shape} != allocated "
                f"{tuple(self._shapes[i])}: live retunes must keep shapes"
            )
        return self._set_params(**{f"taps{i}": t})

    def handle_for(self, part):
        return _CascadeHandle(self, part)


def _sos_pair(sos_row) -> np.ndarray:
    """One SOS row, normalized, as its float32 ``[hi, lo]`` pair."""
    sos = np.asarray(sos_row, np.float64).reshape(-1)
    if sos.shape[0] != 6:
        raise ValueError("set_sos takes one SOS row")
    return split_f32_pair(sos / sos[3])


class Biquad(ShardedOp):
    """One IIR biquad section; the pole recursion crosses rank boundaries
    through the mesh-wide prefix. ``precision='extended'`` selects the
    double-f32 engine (``chain.BiquadStage``)."""

    fusion_kind = "biquad"

    def __init__(self, sos_row, precision: Optional[str] = None,
                 refine: bool = True):
        super().__init__()
        self._sos = np.asarray(sos_row)
        self._precision = precision
        self._refine = bool(refine)
        self._delegate = None  # set by pipe_tpu_torch.optimize.fuse

    def _make_stage(self, props):
        return _chain.BiquadStage(
            self._sos, refine=self._refine, precision=self._precision
        )

    def set_sos(self, sos_row) -> mutable.Mutation:
        if self._delegate is not None:  # cascaded away by optimize.fuse
            return self._delegate.set_part_sos(self, sos_row)
        pair = _sos_pair(sos_row)
        return self._set_params(sos=pair[0], sos_lo=pair[1])


class Compressor(ShardedOp):
    """Peak compressor; envelope recurrences extend across ranks via
    exclusive prefix scans."""

    _what = "compressor"
    _stage_cls = "CompressorStage"

    def __init__(self, threshold_db=-18.0, ratio=4.0, attack_ms=5.0,
                 release_ms=120.0, makeup_db=0.0):
        super().__init__()
        self._kw = dict(
            threshold_db=threshold_db, ratio=ratio, attack_ms=attack_ms,
            release_ms=release_ms, makeup_db=makeup_db,
        )

    def _make_stage(self, props):
        return getattr(_chain, self._stage_cls)(
            sample_rate=props.sample_rate, **self._kw)

    def set(self, **kwargs) -> mutable.Mutation:
        unknown = set(kwargs) - set(self._kw)
        if unknown:
            raise KeyError(f"unknown {self._what} params: {sorted(unknown)}")
        return self._set_params(**{k: _f32(v) for k, v in kwargs.items()})


class SpectralGain(ShardedOp):
    """Per-bin STFT gain curve (graphic EQ), time+channel sharded."""

    def __init__(self, window_size: int, hop: int, gains=None):
        super().__init__()
        self._args = (window_size, hop)
        self._gains = gains

    def _make_stage(self, props):
        return _chain.SpectralGainStage(*self._args, gains=self._gains)

    def set_gains(self, gains) -> mutable.Mutation:
        return self._set_params(gains=_f32(gains))


class SpectralGate(ShardedOp):
    """Per-bin spectral noise gate, time+channel sharded."""

    def __init__(self, window_size: int, hop: int, threshold: float,
                 reduction_db: float = -80.0, knee_db: float = 6.0):
        super().__init__()
        self._args = (window_size, hop, threshold, reduction_db, knee_db)

    def _make_stage(self, props):
        return _chain.SpectralGateStage(*self._args)

    def set(self, threshold=None, reduction_db=None) -> mutable.Mutation:
        vals = {}
        if threshold is not None:
            vals["threshold"] = _f32(threshold)
        if reduction_db is not None:
            vals["reduction_db"] = _f32(reduction_db)
        return self._set_params(**vals)


class Mix(ShardedOp):
    """(C_out, C_in) matrix mix reduced with an ``all_reduce`` over the
    channel axis: the merged mixer sink of BASELINE config 5. Output
    channels are replicated over the channel axis; must be the last
    processor."""

    fusion_kind = "mix"

    def __init__(self, matrix):
        super().__init__()
        self._m = np.asarray(matrix)
        self._delegate = None  # set by pipe_tpu_torch.optimize.fuse

    def _make_stage(self, props):
        return _chain.MixStage(self._m)

    def _out_props(self, props, stage):
        return SignalProperties(
            sample_rate=props.sample_rate, channels=self._m.shape[0]
        )

    def set_matrix(self, matrix) -> mutable.Mutation:
        if self._delegate is not None:  # fused away by optimize.fuse
            return self._delegate.set_matrix(matrix)
        new = _f32(matrix)
        if new.shape != self._m.shape:
            raise ValueError(
                f"mix matrix shape {new.shape} != allocated {self._m.shape}"
            )
        return self._set_params(m=new)


class FIRGain(ShardedOp):
    """Fused sharded FIR with a folded gain (``optimize.fuse`` rewrite of
    an adjacent Gain + FIR pair). Both stay live parameters."""

    def __init__(self, taps, gain=1.0):
        super().__init__()
        self._taps = np.asarray(taps)
        self._gain = gain

    def _make_stage(self, props):
        return _chain.FIRGainStage(self._taps, self._gain)

    def set_taps(self, taps) -> mutable.Mutation:
        return self._set_params(taps=_f32(taps))

    def set_gain(self, gain) -> mutable.Mutation:
        return self._set_params(gain=_f32(gain))


class MixGain(ShardedOp):
    """Fused sharded mix with a folded gain (``side='in'`` scales columns,
    ``side='out'`` rows)."""

    def __init__(self, matrix, gain=1.0, side: str = "in"):
        super().__init__()
        self._m = np.asarray(matrix)
        self._gain = gain
        self._side = side

    def _make_stage(self, props):
        return _chain.MixGainStage(self._m, self._gain, self._side)

    def _out_props(self, props, stage):
        return SignalProperties(
            sample_rate=props.sample_rate, channels=self._m.shape[0]
        )

    def set_matrix(self, matrix) -> mutable.Mutation:
        return self._set_params(m=_f32(matrix))

    def set_gain(self, gain) -> mutable.Mutation:
        return self._set_params(gain=_f32(gain))


class BiquadCascade(ShardedOp):
    """A run of adjacent sharded Biquads collapsed into ONE cascade stage
    (``optimize.fuse`` rewrite). Each original ``Biquad`` keeps mutating
    its own row via :meth:`set_part_sos` (installed as its delegate)."""

    def __init__(self, parts):
        super().__init__()
        self._parts = list(parts)
        self._rows = {id(p): i for i, p in enumerate(self._parts)}
        self._sos = np.vstack(
            [np.asarray(p._sos, np.float64).reshape(1, 6) for p in self._parts]
        )
        self._precision = self._parts[0]._precision
        self._refine = self._parts[0]._refine

    def _make_stage(self, props):
        return _chain.BiquadCascadeStage(
            self._sos, refine=self._refine, precision=self._precision
        )

    def set_part_sos(self, part, sos_row) -> mutable.Mutation:
        i = self._rows[id(part)]
        pair = _sos_pair(sos_row)

        def fn():
            # the rows are replicated on every rank; a clone is written, the
            # tensor that blocks in flight read is not
            for name, row in (("sos", pair[0]), ("sos_lo", pair[1])):
                cur = self._component.get_param(name).clone()
                cur[i] = cur.new_tensor(row)
                self._component.set_param(name, cur)

        return self.context.mutate(fn)


class Delay(ShardedOp):
    """Pure delay / feedback echo for ANY ``delay_frames`` (longer than the
    local chunk included). Feedback capability is structural: build with a
    nonzero ``feedback`` or ``allow_feedback=True`` to get the (heavier)
    cross-rank recurrence machinery and a live ``set_feedback``; otherwise
    the stage is the cheap pure-delay tap and ``set_feedback`` raises
    (mirroring the streaming component's structural gating)."""

    def __init__(self, delay_frames: int, feedback: float = 0.0,
                 wet: float = 1.0, dry: float = 0.0,
                 allow_feedback: Optional[bool] = None):
        super().__init__()
        self._args = (delay_frames, feedback, wet, dry, allow_feedback)

    def _make_stage(self, props):
        return _chain.DelayStage(*self._args)

    def set_feedback(self, fb) -> mutable.Mutation:
        if self._stage is not None and not self._stage.can_feedback:
            raise ValueError(
                "this Delay cannot do feedback: it was built pure "
                "(pass feedback=... or allow_feedback=True at construction)"
            )
        return self._set_params(feedback=_f32(fb))

    def set_mix(self, wet, dry) -> mutable.Mutation:
        return self._set_params(wet=_f32(wet), dry=_f32(dry))


class Gate(Compressor):
    """Downward-expander noise gate."""

    _what = "gate"
    _stage_cls = "GateStage"

    def __init__(self, threshold_db=-50.0, range_db=80.0, attack_ms=1.0,
                 release_ms=200.0):
        ShardedOp.__init__(self)
        self._kw = dict(
            threshold_db=threshold_db, range_db=range_db,
            attack_ms=attack_ms, release_ms=release_ms,
        )


class Limiter(Compressor):
    """Peak limiter (infinite-ratio compressor)."""

    _what = "limiter"
    _stage_cls = "LimiterStage"

    def __init__(self, threshold_db=-1.0, attack_ms=0.5, release_ms=50.0,
                 makeup_db=0.0):
        ShardedOp.__init__(self)
        self._kw = dict(
            threshold_db=threshold_db, attack_ms=attack_ms,
            release_ms=release_ms, makeup_db=makeup_db,
        )


class Channelizer(ShardedOp):
    """K-channel polyphase DFT filterbank; emits ``C * 2 * (K//2+1)``
    stacked re/im channels at rate ``sr/K``."""

    def __init__(self, num_channels: int, taps_per_branch: int = 16):
        super().__init__()
        self._args = (num_channels, taps_per_branch)

    def _make_stage(self, props):
        return _chain.ChannelizerStage(*self._args)

    def _out_props(self, props, stage):
        K = stage.K
        return SignalProperties(
            sample_rate=props.sample_rate / K,
            channels=props.channels * 2 * (K // 2 + 1),
        )

    def _out_frames(self, frames, stage):
        return frames // stage.K

    def set_prototype(self, h) -> mutable.Mutation:
        gp = polyphase_branches(np.asarray(h, np.float64), self._args[0])
        return self._set_params(gp=_f32(gp))


class IQMix(ShardedOp):
    """Quadrature downconverter: ``(C, N) -> (2C, N)`` with per-shard
    [I..., Q...] rail pairing; exact integer phase at each rank's global
    sample position."""

    def __init__(self, freq_hz: float):
        super().__init__()
        self._freq = float(freq_hz)

    def _make_stage(self, props):
        return _chain.IQMixStage(self._freq, sample_rate=props.sample_rate)

    def _out_props(self, props, stage):
        return SignalProperties(
            sample_rate=props.sample_rate, channels=2 * props.channels
        )


class _Detector(ShardedOp):
    """A detector over local I/Q pairs: ``(2C, N) -> (C, N)``."""

    _stage_cls = ""

    def _make_stage(self, props):
        return getattr(_chain, self._stage_cls)()

    def _out_props(self, props, stage):
        return SignalProperties(
            sample_rate=props.sample_rate, channels=props.channels // 2
        )


class EnvelopeDetector(_Detector):
    """AM detector over local I/Q pairs: ``(2C, N) -> (C, N)``."""

    _stage_cls = "EnvelopeDetectorStage"


class FMDiscriminator(_Detector):
    """Quadrature FM discriminator over local I/Q pairs:
    ``(2C, N) -> (C, N)`` instantaneous frequency in cycles/sample."""

    _stage_cls = "FMDiscriminatorStage"

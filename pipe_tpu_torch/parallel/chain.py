"""ShardedChain: the bulk/throughput runner over a mesh of ranks.

The counterpart of :mod:`pipe_tpu.parallel.chain`. Where the streaming
runtime advances one block at a time on one card, the sharded chain
processes a large chunk per step with the channel axis sharded as data
parallelism and the time axis as sequence parallelism, one process per
shard (see the package docstring). Stream state (filter tails, IIR states)
crosses the shard boundary as halos: each rank receives its left
neighbour's trailing samples (``halo.halo_from_left``), and a chunk's final
state is broadcast from the row's last rank as the next chunk's carry
(``halo.last_shard``), so chunked and sharded output has the structure of
the sequential stream.

A stage's ``build`` fixes shapes and creates its carries and parameters as
GLOBAL host arrays with a layout (``carry_spec``/``param_spec``, ``P`` of
:mod:`pipe_tpu_torch.parallel.mesh`), exactly as the JAX package's does;
the chain keeps each rank's block of them on its device, and ``apply`` sees
the local view and calls the collectives. Parameters are read from
``stage.params`` at every step: replacing one between chunks, or editing
the host array in place, is a live retune.

What crosses the chain's boundary, on every rank alike:

- ``step(x)`` takes the GLOBAL chunk ``(channels, chunk_frames)`` (a host
  array or a tensor; each rank uses its block of it) or this rank's block
  declared through ``parallel.shard_host_chunk``, and returns THIS RANK'S
  BLOCK of the output as a tensor on the chain's device: ``(out_c_local,
  out_n_local)`` rows and frames in mesh order, pad rows included, or all
  output channels after a ``MixStage``. The shape depends on the mesh and
  never on the rank.
- ``gather(y_local)`` assembles the global ``(out_channels, out_frames)``
  output on every rank, and ``process`` streams a long signal and returns
  the global output as a host array on every rank.
- ``global_carries()`` / ``load_global_carries()`` move the stream state as
  global host arrays, the JAX chain's ``carries`` after ``np.asarray``: a
  stream begun in either package continues in the other
  (:func:`pipe_tpu_torch.convert.chain_carries_from_numpy`).

Stages (all 22 of the JAX package): :class:`GainStage`,
:class:`FIRStage`, :class:`FIRCascadeStage`, :class:`ResampleStage`
(requires ``N_local*L % M == 0`` so every rank emits an equal count at
phase 0), :class:`FIRResampleStage`, :class:`OLSStage` and
:class:`OLSGainStage` (a P-sample halo, or for an IR longer than the local
chunk the bin-sharded frequency-domain delay line with two ``all_to_all``
per step), :class:`BiquadStage` (float32 and ``precision='extended'``),
:class:`BiquadCascadeStage`, :class:`CompressorStage`,
:class:`LimiterStage`, :class:`GateStage`, :class:`DelayStage` (pure tap,
feedback-free ring, ladder, wave-DAG), :class:`ChannelizerStage`,
:class:`IQMixStage`, :class:`EnvelopeDetectorStage`,
:class:`FMDiscriminatorStage`, :class:`SpectralGainStage`,
:class:`SpectralGateStage`, :class:`MixStage` (``all_reduce`` over the
channel axis; must be last), :class:`FIRGainStage`, :class:`MixGainStage`.

A carry that is a 0-d integer (the oscillator's sample index) is a host
``int`` on every rank, as stream counters are everywhere in the port, and an
``int32`` scalar among the global carries.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from pipe_tpu_torch import config
from pipe_tpu_torch.errors import ShapeConstraintError
from pipe_tpu_torch.ops.biquad import (
    _dd_add,
    _dd_affine_combine,
    _dd_apply_boundary,
    _dd_forcing,
    _dd_mul,
    _iir_apply,
    _iir_scan_dd,
    _two_prod,
    _two_sum,
    split_f32_pair,
)
from pipe_tpu_torch.ops.channelizer import (
    channelize_block,
    design_prototype,
    polyphase_branches,
)
from pipe_tpu_torch.ops.demod import _rationalize, osc_block
from pipe_tpu_torch.ops.dynamics import (
    _affine1_combine,
    _attack_oma,
    _decay_coef,
    _max_decay_combine,
    _pow_int,
    compressor_gain,
)
from pipe_tpu_torch.ops.fir import fir_apply
from pipe_tpu_torch.ops.fused import (
    cascade_taps,
    combine_bank,
    scaled_matrix,
    scaled_taps,
)
from pipe_tpu_torch.ops.prims import dynamic_slice, prefix_scan
from pipe_tpu_torch.ops.resample import (
    _reduce_ratio,
    polyphase_design,
    resample_apply,
)
from pipe_tpu_torch.ops.spectral import (
    _ola_fold,
    design_stft_window,
    frame_hops,
)
from pipe_tpu_torch.parallel.distributed import ShardedChunk
from pipe_tpu_torch.parallel.halo import (
    broadcast_last,
    exclusive_prefix,
    halo_from_left,
    last_shard,
    psum,
)
from pipe_tpu_torch.parallel.mesh import CH_AXIS, TIME_AXIS, Mesh, P
from pipe_tpu_torch.parallel.meshctx import mesh_scope, require_mesh
from pipe_tpu_torch.tree import tree_flatten, tree_unflatten


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _tail(x, n: int):
    """The last ``n`` frames of ``x`` (none for ``n == 0``)."""
    return x[:, x.shape[1] - n:]


class Stage:
    """Build-time protocol. ``build(c_global, c_local, n_local)`` fixes
    shapes; carries and params are GLOBAL host arrays (the chain keeps each
    rank's block by ``carry_spec``/``param_spec``) while ``apply`` sees the
    local view.

    The chain sets ``time_shards`` to the mesh time-axis size before
    calling ``build``, for stages whose carry layout depends on it.

    **Channel padding**: when the user channel count does not divide the
    mesh channel axis, the chain pads ``c_global`` up to the next multiple
    and sets ``c_user`` to the real count before ``build``. Pad channels
    carry zeros end to end (every stage maps zero rows to zero rows), so
    stages only need to size carries by the padded ``c_global`` and
    validate / zero-pad their per-channel parameters via
    :meth:`pad_channels`. Stages whose channel layout is positional set
    ``channel_pad_safe = False`` and keep the divisibility requirement."""

    time_shards: int = 1
    #: real (user) input channel count when the chain padded c_global
    c_user: Optional[int] = None
    channel_pad_safe: bool = True
    #: user-visible output channel count (set by build when it differs from
    #: out_c_global under padding; the chain defaults it)
    out_c_user: Optional[int] = None

    def user_channels(self, c_global: int) -> int:
        return c_global if self.c_user is None else self.c_user

    def pad_channels(self, arr, c_global: int, what: str):
        """Validate a per-channel parameter's leading dim against the USER
        channel count and zero-pad it to the (possibly padded)
        ``c_global``."""
        c_user = self.user_channels(c_global)
        if arr.shape[0] != c_user:
            raise ValueError(
                f"per-channel {what} for {arr.shape[0]} channels, "
                f"chain has {c_user}"
            )
        if arr.shape[0] == c_global:
            return arr
        pad = np.zeros(
            (c_global - arr.shape[0],) + tuple(arr.shape[1:]), arr.dtype
        )
        return np.concatenate([arr, pad], axis=0)

    def build(self, c_global: int, c_local: int, n_local: int):
        raise NotImplementedError

    # populated by build():
    carry: Any = None
    params: Any = None
    carry_spec: Any = None
    param_spec: Any = None
    out_c_local: int = 0
    out_n_local: int = 0

    def apply(self, carry, params, x_local):
        raise NotImplementedError


class GainStage(Stage):
    def __init__(self, gain=1.0):
        self._gain = gain

    def build(self, c_global, c_local, n_local):
        g = _f32(self._gain)
        if g.ndim == 1:
            g = self.pad_channels(g, c_global, "gain")
        self.carry = ()
        self.params = {"gain": g}
        self.carry_spec = ()
        # scalar gain replicates; a per-channel vector shards with the rows
        self.param_spec = {"gain": P() if g.ndim == 0 else P(CH_AXIS)}
        self.out_c_global, self.out_c_local, self.out_n_local = c_global, c_local, n_local

    def apply(self, carry, params, x):
        g = params["gain"]
        if g.ndim == 1:
            g = g[:, None]
        return (), x * g


class FIRStage(Stage):
    """FIR with (T-1) halo. Taps may be shared ``(T,)`` (replicated over the
    mesh) or per-channel ``(C, T)`` (sharded over CH_AXIS with the
    channels)."""

    def __init__(self, taps):
        self._taps = _f32(taps)
        if self._taps.ndim not in (1, 2):
            raise ValueError("FIRStage taps must be (T,) or (C, T)")

    def build(self, c_global, c_local, n_local):
        T = self._taps.shape[-1]
        if self._taps.ndim == 2:
            self._taps = self.pad_channels(self._taps, c_global, "taps")
        if T - 1 > n_local:
            raise ShapeConstraintError(
                f"FIR halo {T-1} exceeds local chunk {n_local}; "
                "use a larger chunk or fewer time shards"
            )
        self.carry = {"tail": np.zeros((c_global, T - 1), np.float32)}
        self.params = {"taps": self._taps}
        self.carry_spec = {"tail": P(CH_AXIS, None)}
        self.param_spec = {
            "taps": P() if self._taps.ndim == 1 else P(CH_AXIS, None)
        }
        self.out_c_global, self.out_c_local, self.out_n_local = c_global, c_local, n_local

    def apply(self, carry, params, x):
        T = params["taps"].shape[-1]
        left = halo_from_left(x, T - 1, TIME_AXIS, carry["tail"])
        y = fir_apply(left, x, params["taps"])
        new_tail = last_shard(_tail(x, T - 1), TIME_AXIS)
        return {"tail": new_tail}, y


class FIRCascadeStage(FIRStage):
    """A run of FIRs as ONE sharded stage (the sharded twin of
    ``ops.fused.FIRCascade``): the combined taps are rebuilt inside the
    step from the member taps (per-slot live retunes); one halo of
    ``sum(T_i - 1)`` samples instead of one per stage."""

    def __init__(self, taps_list):
        self._taps = [_f32(t) for t in taps_list]
        for t in self._taps:
            if t.ndim not in (1, 2):
                raise ValueError("FIR taps must be (T,) or (C, T)")

    def build(self, c_global, c_local, n_local):
        self._taps = [
            self.pad_channels(t, c_global, "taps") if t.ndim == 2 else t
            for t in self._taps
        ]
        Tc = sum(t.shape[-1] for t in self._taps) - (len(self._taps) - 1)
        if Tc - 1 > n_local:
            raise ShapeConstraintError(
                f"cascaded FIR halo {Tc-1} exceeds local chunk {n_local}"
            )
        self.carry = {"tail": np.zeros((c_global, Tc - 1), np.float32)}
        self.params = {f"taps{i}": t for i, t in enumerate(self._taps)}
        self.carry_spec = {"tail": P(CH_AXIS, None)}
        self.param_spec = {
            f"taps{i}": P() if t.ndim == 1 else P(CH_AXIS, None)
            for i, t in enumerate(self._taps)
        }
        self.out_c_global, self.out_c_local, self.out_n_local = (
            c_global, c_local, n_local,
        )

    def apply(self, carry, params, x):
        hc = cascade_taps(
            [params[f"taps{i}"] for i in range(len(self._taps))]
        )
        return super().apply(carry, {"taps": hc}, x)


class ResampleStage(Stage):
    def __init__(self, up: int, down: int, taps_per_phase: int = 32):
        self.up, self.down = _reduce_ratio(up, down)
        self.K = taps_per_phase
        self._hp = _f32(polyphase_design(self.up, self.down, taps_per_phase))

    def build(self, c_global, c_local, n_local):
        L, M, K = self.up, self.down, self.K
        if (n_local * L) % M != 0:
            raise ShapeConstraintError(
                f"ResampleStage needs N_local*{L} divisible by {M}; "
                f"got N_local={n_local}"
            )
        if K - 1 > n_local:
            raise ShapeConstraintError("resampler halo exceeds local chunk")
        self.carry = {"hist": np.zeros((c_global, K - 1), np.float32)}
        self.params = {"hp": self._hp}
        self.carry_spec = {"hist": P(CH_AXIS, None)}
        self.param_spec = {"hp": P()}
        self.out_c_global, self.out_c_local = c_global, c_local
        self.out_n_local = n_local * L // M

    def apply(self, carry, params, x):
        L, M, K = self.up, self.down, self.K
        left = halo_from_left(x, K - 1, TIME_AXIS, carry["hist"])
        # rank-local phase starts at 0 by the N_local*L % M divisibility rule
        y = resample_apply(left, x, params["hp"], L, M)
        new_hist = last_shard(_tail(x, K - 1), TIME_AXIS)
        return {"hist": new_hist}, y


class FIRResampleStage(Stage):
    """Fused FIR + polyphase resample (see ``pipe_tpu_torch.ops.fused``):
    one combined bank, one supercycle product, one halo of ``K + T - 2``
    samples instead of two stages with two halos."""

    def __init__(self, taps, up: int, down: int, taps_per_phase: int = 32):
        self._taps = _f32(taps)
        if self._taps.ndim != 1:
            raise ValueError("FIRResampleStage uses shared (T,) taps")
        self.up, self.down = _reduce_ratio(up, down)
        self.K = taps_per_phase
        self._hp = _f32(polyphase_design(self.up, self.down, taps_per_phase))

    def build(self, c_global, c_local, n_local):
        L, M = self.up, self.down
        Kc = self.K + self._taps.shape[0] - 1
        if (n_local * L) % M != 0:
            raise ShapeConstraintError(
                f"FIRResampleStage needs N_local*{L} divisible by {M}; "
                f"got N_local={n_local}"
            )
        if Kc - 1 > n_local:
            raise ShapeConstraintError("fused halo exceeds local chunk")
        self.carry = {"hist": np.zeros((c_global, Kc - 1), np.float32)}
        self.params = {"taps": self._taps, "hp": self._hp}
        self.carry_spec = {"hist": P(CH_AXIS, None)}
        self.param_spec = {"taps": P(), "hp": P()}
        self.out_c_global, self.out_c_local = c_global, c_local
        self.out_n_local = n_local * L // M

    def apply(self, carry, params, x):
        L, M = self.up, self.down
        Kc = self.K + params["taps"].shape[0] - 1
        hc = combine_bank(params["taps"], params["hp"])
        left = halo_from_left(x, Kc - 1, TIME_AXIS, carry["hist"])
        y = resample_apply(left, x, hc, L, M)
        new_hist = last_shard(_tail(x, Kc - 1), TIME_AXIS)
        return {"hist": new_hist}, y


def _affine_combine(left, right):
    """Compose affine maps: (A2, u2) after (A1, u1) = (A2@A1, A2@u1 + u2),
    with leading batch dims (..., 2, 2) and (..., 2). Written out as
    multiplies and two-term sums: IEEE FP32 whatever the precision knob
    says, as the recurrence needs."""
    A1, u1 = left
    A2, u2 = right
    A = (A2[..., :, :, None] * A1[..., None, :, :]).sum(-2)
    u = (A2 * u1[..., None, :]).sum(-1) + u2
    return A, u


def _sharded_iir(v, s, a1, a2, basis):
    """Pole recurrence ``y[n] = v[n] - a1 y[n-1] - a2 y[n-2]`` over a
    time-sharded chunk, built from the streaming engine's recurrence
    (``ops.biquad._iir_apply``: ``kernels.iir_tiles`` for a local block on
    the card that passes ``kernels.section_gate``):

      1. zero-entering-state local response ``y0``: the hot pass;
      2. ``basis = (alpha, beta)``: length-N responses to unit entering
         states (shared between the main and the refinement call, so
         passed in);
      3. per-rank affine totals (transition matrix from the basis tails,
         forcing from the ``y0`` tails) exclusive-prefix-combined across
         the time axis to recover each rank's true entering state;
      4. rank-2 boundary correction ``y = y0 + s0_1*alpha + s0_2*beta``.

    Nothing here consults the precision knob: the products are elementwise.
    """
    C, N = v.shape
    alpha, beta = basis[0], basis[1]  # (N,), (N,)
    zeros = torch.zeros((C, 2), dtype=torch.float32, device=v.device)
    y0 = _iir_apply(v, zeros, a1, a2)

    # transition of (y[-1], y[-2]) over one local chunk, channel-independent
    A_N = torch.stack(
        [torch.stack([alpha[N - 1], beta[N - 1]]),
         torch.stack([alpha[N - 2], beta[N - 2]])]
    )  # (2, 2)
    u_N = torch.stack([y0[:, N - 1], y0[:, N - 2]], dim=1)  # (C, 2)
    unit = (
        torch.eye(2, dtype=torch.float32, device=v.device).expand(C, 2, 2),
        zeros,
    )
    pre = exclusive_prefix(
        TIME_AXIS, _affine_combine, unit,
        (A_N[None].expand(C, 2, 2).contiguous(), u_N),
    )
    s0 = (pre[0] * s[:, None, :]).sum(-1) + pre[1]
    return y0 + s0[:, 0:1] * alpha[None, :] + s0[:, 1:2] * beta[None, :]


def _dd_identity_elem(shape, device):
    one = torch.ones(shape, dtype=torch.float32, device=device)
    zero = torch.zeros(shape, dtype=torch.float32, device=device)
    z = (zero, zero)
    return (one, zero), z, z, (one, zero), z, z


class BiquadStage(Stage):
    """One biquad section, time-sharded on the streaming engine's
    recurrence (see :func:`_sharded_iir`), with one iterative-refinement
    pass on the pole recurrence, crossing the shard boundary like the main
    pass, to clear 100 dB on high-Q poles. ``refine=False`` skips the second
    pass. On the card, each pass of a local block on ``kernels.section_gate``
    (whole 8-channel groups, any length) is one ``kernels.iir_tiles`` call.

    ``precision='extended'`` runs the double-f32 engine instead: the local
    prefix scan, the cross-rank exclusive prefix of per-rank affine totals
    and the chunk carry all ride as f32 hi/lo pairs, so near-DC sections
    whose float32 floor sits below 100 dB stay at or above it on the mesh
    as on the streaming engine."""

    def __init__(self, sos_row, refine: bool = True,
                 precision: str | None = None):
        sos = np.asarray(sos_row, np.float64).reshape(-1)
        if sos.shape[0] != 6:
            raise ValueError("BiquadStage takes one SOS row")
        if precision not in (None, "extended"):
            raise ValueError("precision must be None or 'extended'")
        pair = split_f32_pair(sos / sos[3])
        self._sos = pair[0]
        self._sos_lo = pair[1]
        self._refine = bool(refine)
        self._extended = precision == "extended"
        self._basis = {}  # slot -> (key, coefficient tensor, basis)

    def build(self, c_global, c_local, n_local):
        self.carry = {
            "x_tail": np.zeros((c_global, 2), np.float32),
            "s": np.zeros((c_global, 2), np.float32),
        }
        self.carry_spec = {"x_tail": P(CH_AXIS, None), "s": P(CH_AXIS, None)}
        self.params = {"sos": self._sos, "sos_lo": self._sos_lo}
        self.param_spec = {"sos": P(), "sos_lo": P()}
        if self._extended:
            self.carry["s_lo"] = np.zeros((c_global, 2), np.float32)
            self.carry_spec["s_lo"] = P(CH_AXIS, None)
        self.out_c_global, self.out_c_local, self.out_n_local = c_global, c_local, n_local

    def apply(self, carry, params, x, slot: int = 0):
        """``slot`` tells the sections of a cascade apart (each keeps its
        own boundary responses)."""
        if self._extended:
            return self._apply_extended(carry, params, x)
        return self._apply_f32(carry, params, x, slot)

    def _unit_responses(self, coefs, N: int, slot: int):
        """``(alpha, beta)`` as a (2, N) tensor: the responses to unit
        entering states, shared by both passes. A (2, N) block fails
        ``kernels.section_gate``'s channel rule and takes the float64
        prefix-doubling path, log2(N) passes of small launches, so the
        result is kept until the coefficients change: the key is the
        coefficient tensor's address and version, and the tensor is held
        so that its address cannot be reused while the entry lives
        (``ShardedChain.params`` hands over a new tensor whenever the host
        values changed)."""
        key = (coefs.data_ptr(), coefs._version, N)
        hit = self._basis.get(slot)
        if hit is None or hit[0] != key:
            basis = _iir_apply(
                torch.zeros((2, N), dtype=torch.float32, device=coefs.device),
                torch.eye(2, dtype=torch.float32, device=coefs.device),
                coefs[4], coefs[5],
            )
            hit = self._basis[slot] = (key, coefs, basis)
        return hit[2]

    def _apply_extended(self, carry, params, x):
        """Double-f32 sharded recurrence: local dd prefix scan, dd affine
        exclusive prefix across the time axis, dd chunk carry."""
        C, N = x.shape
        coefs, coefs_lo = params["sos"], params["sos_lo"]
        a1 = (coefs[4], coefs_lo[4])
        a2 = (coefs[5], coefs_lo[5])
        x_tail = halo_from_left(x, 2, TIME_AXIS, carry["x_tail"])
        buf = torch.cat([x_tail, x], dim=1)
        v = _dd_forcing(buf, coefs, coefs_lo)
        pref = _iir_scan_dd(v, a1, a2)
        # per-rank affine total = the prefix at the last local sample
        totals = tuple((h[:, -1], l[:, -1]) for h, l in pref)
        pre = exclusive_prefix(
            TIME_AXIS, _dd_affine_combine,
            _dd_identity_elem((C,), x.device), totals,
        )
        # entering state for this rank: A_pre @ s_carry + u_pre, in dd
        s_lo = carry.get("s_lo")
        if s_lo is None:
            s_lo = torch.zeros_like(carry["s"])
        sx = (carry["s"][:, 0], s_lo[:, 0])
        sy = (carry["s"][:, 1], s_lo[:, 1])
        pa, pb, pc, pd, pux, puy = pre
        devx = _dd_add(_dd_add(_dd_mul(pa, sx), _dd_mul(pb, sy)), pux)
        devy = _dd_add(_dd_add(_dd_mul(pc, sx), _dd_mul(pd, sy)), puy)
        s_dev = (
            torch.stack([devx[0], devy[0]], dim=1),
            torch.stack([devx[1], devy[1]], dim=1),
        )
        yh, yl = _dd_apply_boundary(pref, s_dev)
        new_s = last_shard(
            torch.stack([yh[:, -1], yh[:, -2]], dim=1), TIME_AXIS
        )
        new_s_lo = last_shard(
            torch.stack([yl[:, -1], yl[:, -2]], dim=1), TIME_AXIS
        )
        new_x_tail = last_shard(_tail(x, 2), TIME_AXIS)
        return {
            "x_tail": new_x_tail, "s": new_s, "s_lo": new_s_lo
        }, yh

    def _apply_f32(self, carry, params, x, slot: int = 0):
        C, N = x.shape
        coefs = params["sos"]
        b0, b1, b2, a1, a2 = coefs[0], coefs[1], coefs[2], coefs[4], coefs[5]

        x_tail = halo_from_left(x, 2, TIME_AXIS, carry["x_tail"])
        buf = torch.cat([x_tail, x], dim=1)
        v = b0 * buf[:, 2:] + b1 * buf[:, 1:-1] + b2 * buf[:, :-2]

        basis = self._unit_responses(coefs, N, slot)
        y = _sharded_iir(v, carry["s"], a1, a2, basis)
        if self._refine:
            # the defect of the recurrence, with the previous two outputs
            # crossing the shard boundary as a halo; the filtered defect is
            # itself a (zero-state) recurrence across the whole chunk. The
            # defect is formed in float64, where products of float32 values
            # are exact, and rounded once (ops.biquad._iir_refine).
            y_prev = halo_from_left(y, 2, TIME_AXIS, carry["s"].flip(1))
            ybuf = torch.cat([y_prev, y], dim=1).double()
            r = v.double() - (ybuf[:, 2:] + a1.double() * ybuf[:, 1:-1]
                              + a2.double() * ybuf[:, :-2])
            y = y + _sharded_iir(
                r.float(), torch.zeros_like(carry["s"]), a1, a2, basis
            )

        new_s = last_shard(
            torch.stack([y[:, -1], y[:, -2]], dim=1), TIME_AXIS
        )
        new_x_tail = last_shard(_tail(x, 2), TIME_AXIS)
        return {"x_tail": new_x_tail, "s": new_s}, y


class MixStage(Stage):
    """Matrix mix with channel reduction over the mesh: the sum
    (``all_reduce``) of the column-sharded partial products, the merged
    mixer sink. Output is replicated over the channel axis; must be the
    last stage."""

    def __init__(self, matrix):
        self._m = _f32(matrix)
        if self._m.ndim != 2:
            raise ValueError("mix matrix must be (C_out, C_in)")

    def build(self, c_global, c_local, n_local):
        c_user = self.user_channels(c_global)
        if self._m.shape[1] != c_user:
            raise ValueError(
                f"mix matrix expects {self._m.shape[1]} input channels, "
                f"chain has {c_user}"
            )
        if self._m.shape[1] != c_global:
            self._m = np.concatenate(
                [
                    self._m,
                    np.zeros(
                        (self._m.shape[0], c_global - self._m.shape[1]),
                        self._m.dtype,
                    ),
                ],
                axis=1,
            )
        self.carry = ()
        self.params = {"m": self._m}
        self.carry_spec = ()
        # columns sharded with the input channels
        self.param_spec = {"m": P(None, CH_AXIS)}
        # output channels are global and replicated over the ch axis
        self.out_c_global = self.out_c_local = self._m.shape[0]
        self.out_c_user = self._m.shape[0]
        self.out_n_local = n_local
        self.reduces_channels = True

    def apply(self, carry, params, x):
        partial_mix = config.matmul(params["m"], x)
        return (), psum(partial_mix, CH_AXIS)


class FIRGainStage(FIRStage):
    """FIR with a folded gain (the sharded twin of
    ``ops.fused.FIRWithGain``): the effective bank ``taps * gain`` is
    rebuilt inside the step from the live params, so the gain costs T
    mults instead of an N-sample elementwise pass."""

    def __init__(self, taps, gain=1.0):
        super().__init__(taps)
        self._gain = _f32(gain)

    def build(self, c_global, c_local, n_local):
        if self._gain.ndim == 1:
            self._gain = self.pad_channels(self._gain, c_global, "gain")
        super().build(c_global, c_local, n_local)
        self.params["gain"] = self._gain
        self.param_spec["gain"] = P() if self._gain.ndim == 0 else P(CH_AXIS)

    def apply(self, carry, params, x):
        hc = scaled_taps(params["taps"], params["gain"])
        return super().apply(carry, {"taps": hc}, x)


class MixGainStage(MixStage):
    """Mix with a folded gain (sharded twin of ``ops.fused.MixWithGain``):
    ``side='in'`` scales columns (upstream gain), ``side='out'`` rows."""

    def __init__(self, matrix, gain=1.0, side: str = "in"):
        if side not in ("in", "out"):
            raise ValueError("side must be 'in' or 'out'")
        super().__init__(matrix)
        self._gain = _f32(gain)
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

    def build(self, c_global, c_local, n_local):
        if self._gain.ndim == 1 and self.side == "in":
            self._gain = self.pad_channels(self._gain, c_global, "gain")
        super().build(c_global, c_local, n_local)
        self.params["gain"] = self._gain
        # an 'in'-side vector gain shards with the matrix columns; an
        # 'out'-side one is replicated like the output channels
        if self._gain.ndim == 0:
            self.param_spec["gain"] = P()
        else:
            self.param_spec["gain"] = (
                P(CH_AXIS) if self.side == "in" else P()
            )

    def apply(self, carry, params, x):
        m = scaled_matrix(params["m"], params["gain"], self.side)
        return super().apply(carry, {"m": m}, x)


class BiquadCascadeStage(Stage):
    """A run of biquad sections as ONE sharded stage (the sharded twin of
    ``ops.fused.BiquadCascade``): stacked SOS rows applied in sequence
    inside a single stage, one carry tree, per-row live retunes."""

    def __init__(self, sos, refine: bool = True, precision: str | None = None):
        sos = np.asarray(sos, np.float64)
        if sos.ndim == 1:
            sos = sos[None, :]
        if sos.shape[-1] != 6:
            raise ValueError("sos rows must be [b0 b1 b2 a0 a1 a2]")
        if precision not in (None, "extended"):
            raise ValueError("precision must be None or 'extended'")
        pair = split_f32_pair(sos / sos[:, 3:4])
        self._sos = pair[0]
        self._sos_lo = pair[1]
        self._row = BiquadStage(
            np.array([1.0, 0, 0, 1.0, 0, 0]), refine=refine,
            precision=precision,
        )
        self._extended = precision == "extended"

    @property
    def n_sections(self) -> int:
        return int(self._sos.shape[0])

    def build(self, c_global, c_local, n_local):
        S = self._sos.shape[0]

        def z():
            return np.zeros((S, c_global, 2), np.float32)

        self.carry = {"x_tail": z(), "s": z()}
        self.carry_spec = {
            "x_tail": P(None, CH_AXIS, None), "s": P(None, CH_AXIS, None),
        }
        if self._extended:
            self.carry["s_lo"] = z()
            self.carry_spec["s_lo"] = P(None, CH_AXIS, None)
        self.params = {"sos": self._sos, "sos_lo": self._sos_lo}
        self.param_spec = {"sos": P(), "sos_lo": P()}
        self.out_c_global, self.out_c_local, self.out_n_local = (
            c_global, c_local, n_local,
        )

    def apply(self, carry, params, x):
        S = self._sos.shape[0]
        new = {k: [] for k in carry}
        for i in range(S):
            rc = {k: carry[k][i] for k in carry}
            rp = {"sos": params["sos"][i], "sos_lo": params["sos_lo"][i]}
            nc, x = self._row.apply(rc, rp, x, slot=i)
            for k in new:
                new[k].append(nc[k])
        return {k: torch.stack(v) for k, v in new.items()}, x


class OLSStage(Stage):
    """Overlap-save FFT convolution, time-sharded, for ANY IR length.

    Two regimes, chosen at build:

    - **single-FFT** (``P <= n_local``): each rank convolves [P-sample halo,
      local chunk] with one FFT sized to the next power of two >= P +
      N_local and keeps the last N_local outputs.
    - **distributed partitioned FDL** (``P > n_local``: the 64k-tap reverb
      of BASELINE config 4): UPOLS with partition size ``B = n_local``, with
      the frequency-domain delay line SHARDED over the time axis by
      frequency bins. The classical 2B analysis window spectrum decomposes
      linearly over zero-padded block FFTs: with ``A_j = rfft(x_j, 2B)`` and
      the B-sample shift phase ``sigma_k = (-1)^k``, ``W_g = A_{g-1} +
      sigma * A_g``, so the window halo folds into the partition spectra
      once at build: ``G_0 = sigma*H_0``, ``G_m = sigma*H_m + H_{m-1}``,
      ``G_K = H_{K-1}`` and ``y_g = last B of irfft(sum_{m=0}^{K} G_m
      A_{g-m})``.

      Per chunk step each rank FFTs only its OWN block (no neighbour halo),
      one ``all_to_all`` transposes the T fresh block spectra to a
      bins-over-ranks layout, every rank multiply-accumulates its bin slice
      of the K+1-deep A-spectra delay line against its bin slice of G for
      ALL T outputs, and a second ``all_to_all`` brings each output block's
      spectrum home for the inverse FFT. The FDL carry and the partition
      spectra are bin-sharded (carry memory and param bytes /T); per-step
      collective traffic is two spectrum-sized transposes, independent of T
      and K.

    The carry and ``ir_f`` are float32 re/im planes, the JAX package's
    layout, so they cross packages; the FFTs run on complex64. The delay
    line's multiply-accumulate is four real einsums through
    :func:`pipe_tpu_torch.config.einsum`, so the precision knob reaches it
    as in the JAX package.
    """

    def __init__(self, ir):
        self._ir = np.asarray(ir, np.float64)
        if self._ir.ndim not in (1, 2):
            raise ValueError("OLSStage ir must be (P,) or (C, P)")

    def build(self, c_global, c_local, n_local):
        Pn = self._ir.shape[-1]
        if self._ir.ndim == 2 and self._ir.shape[0] != c_global:
            c_user = self.user_channels(c_global)
            if self._ir.shape[0] != c_user:
                raise ValueError(
                    f"per-channel IR for {self._ir.shape[0]} channels, "
                    f"chain has {c_user}"
                )
            self._ir = np.concatenate(
                [self._ir, np.zeros((c_global - c_user, Pn), np.float64)],
                axis=0,
            )
        self._partitioned = Pn > n_local
        if self._partitioned:
            B = n_local
            K = -(-Pn // B)
            self._F = 2 * B
            self._K = K
            bins = B + 1
            T = max(1, int(self.time_shards))
            self._t = T
            # bins padded to the transpose width (T equal slices)
            self._bs = -(-bins // T)
            self._bins_pad = self._bs * T
            self.carry = {
                # zfdl[i] = A-spectrum planes of global block (start-K+i)
                # (oldest first), frequency bins sharded over the time axis
                "zfdl": np.zeros(
                    (K, 2, c_global, self._bins_pad), np.float32
                ),
            }
            self.carry_spec = {"zfdl": P(None, None, CH_AXIS, TIME_AXIS)}
            self.params = {"ir_f": self.transform_ir(self._ir)}
            # reversed G planes, bin-sharded with the carry: shared
            # (2, K+1, binsP); per-channel (C, 2, K+1, binsP)
            self.param_spec = {
                "ir_f": P(None, None, TIME_AXIS)
                if self._ir.ndim == 1
                else P(CH_AXIS, None, None, TIME_AXIS)
            }
        else:
            F_ = 1 << int(np.ceil(np.log2(Pn + n_local)))
            self._F = F_
            self.carry = {"hist": np.zeros((c_global, Pn), np.float32)}
            self.carry_spec = {"hist": P(CH_AXIS, None)}
            self.params = {"ir_f": self.transform_ir(self._ir)}
            # shared: (2, bins) replicated; per-channel: (C, 2, bins)
            self.param_spec = {
                "ir_f": P() if self._ir.ndim == 1 else P(CH_AXIS, None, None)
            }
        self.out_c_global, self.out_c_local, self.out_n_local = c_global, c_local, n_local

    def transform_ir(self, ir) -> np.ndarray:
        """Spectra planes for the built FFT layout, float64 on the host then
        rounded to float32 (also used by live IR swaps: same length, same
        partitioning)."""
        ir = np.asarray(ir, np.float64)
        if not getattr(self, "_partitioned", False):
            spec = np.fft.rfft(ir, n=self._F, axis=-1)
            return np.stack([spec.real, spec.imag], axis=-2).astype(np.float32)
        B, K = self._F // 2, self._K
        bins = B + 1
        shared = ir.ndim == 1
        irc = ir[None, :] if shared else ir
        C = irc.shape[0]
        padded = np.zeros((C, K * B), np.float64)
        padded[:, : irc.shape[1]] = irc
        parts = padded.reshape(C, K, B)
        H = np.fft.rfft(parts, n=self._F, axis=-1)  # (C, K, bins)
        # fold the window halo into the partitions (class docstring):
        # G_m = sigma * H_m + H_{m-1}, sigma_k = (-1)^k
        sigma = np.where(np.arange(bins) % 2 == 0, 1.0, -1.0)
        G = np.zeros((C, K + 1, bins), np.complex128)
        G[:, :K] += sigma * H
        G[:, 1:] += H
        Grev = G[:, ::-1]  # Grev[k] = G_{K-k}: the windowed-MAC order
        planes = np.stack(
            [Grev.real, Grev.imag], axis=1
        ).astype(np.float32)  # (C, 2, K+1, bins)
        pad = self._bins_pad - bins
        if pad:
            planes = np.pad(planes, ((0, 0), (0, 0), (0, 0), (0, pad)))
        if shared:
            return planes[0]  # (2, K+1, binsP)
        return planes  # (C, 2, K+1, binsP)

    def apply(self, carry, params, x):
        if self._partitioned:
            return self._apply_fdl(carry, params, x)
        C, N = x.shape
        Pn = carry["hist"].shape[1]
        left = halo_from_left(x, Pn, TIME_AXIS, carry["hist"])
        w = torch.cat([left, x], dim=1)  # (C, Pn+N)
        W = torch.fft.rfft(w, n=self._F, dim=-1)
        ir_f = params["ir_f"]
        if ir_f.ndim == 2:  # shared (2, bins)
            H = torch.complex(ir_f[0], ir_f[1])[None, :]
        else:  # per-channel (C_local, 2, bins)
            H = torch.complex(ir_f[:, 0], ir_f[:, 1])
        y = torch.fft.irfft(W * H, n=self._F, dim=-1)
        y = y[:, Pn: Pn + N].contiguous()
        new_hist = last_shard(_tail(x, Pn), TIME_AXIS)
        return {"hist": new_hist}, y

    def _apply_fdl(self, carry, params, x):
        """Distributed UPOLS step (class docstring). Local shapes: ``x``
        (C, B); ``carry['zfdl']`` (K, 2, C, bs); ``params['ir_f']``
        (2, K+1, bs) shared or (C, 2, K+1, bs) per-channel."""
        C, B = x.shape
        K, T = self._K, self._t
        bins = B + 1
        bs = self._bs
        mesh = require_mesh()
        # zero-padded block FFT: each rank transforms only its own block
        A = torch.fft.rfft(x, n=self._F, dim=-1)  # (C, bins)
        Ap = F.pad(torch.stack([A.real, A.imag]), (0, self._bins_pad - bins))
        # transpose #1: blocks-over-ranks -> bins-over-ranks, (T, 2, C, bs):
        # block g's spectrum, my bin slice (itself on one time shard)
        new = mesh.all_to_all(
            Ap.reshape(2, C, T, bs).permute(2, 0, 1, 3), TIME_AXIS)
        # ext[i] = A-spectrum of global block (start - K + i), oldest first
        ext = torch.cat([carry["zfdl"], new], dim=0)  # (K+T, 2, C, bs)
        # windows[g, k] = A of block (start + g - K + k); Y_g needs k=0..K
        w = torch.stack([ext[g: g + K + 1] for g in range(T)])
        wr, wi = w[:, :, 0], w[:, :, 1]  # (T, K+1, C, bs)
        ir_f = params["ir_f"]  # Grev: Grev[k] = G_{K-k} matches windows
        if ir_f.ndim == 3:  # shared (2, K+1, bs)
            eq, gr, gi = "gkcb,kb->gcb", ir_f[0], ir_f[1]
        else:  # per-channel (C, 2, K+1, bs)
            eq, gr, gi = "gkcb,ckb->gcb", ir_f[:, 0], ir_f[:, 1]
        Yr = config.einsum(eq, wr, gr) - config.einsum(eq, wi, gi)
        Yi = config.einsum(eq, wr, gi) + config.einsum(eq, wi, gr)
        Yp = torch.stack([Yr, Yi], dim=1)  # (T, 2, C, bs)
        # transpose #2: each output block's spectrum back to its owner,
        # (2, C, T, bs) with the bin slices in order
        back = mesh.all_to_all(Yp, TIME_AXIS).permute(1, 2, 0, 3)
        Y = back.reshape(2, C, self._bins_pad)[:, :, :bins]
        y = torch.fft.irfft(torch.complex(Y[0], Y[1]), n=self._F, dim=-1)
        return {"zfdl": ext[T:]}, y[:, B:].contiguous()


class OLSGainStage(OLSStage):
    """Overlap-save convolution with a folded gain (sharded twin of
    ``ops.fused.OLSWithGain``): the live gain scales the stage output,
    exact since convolution is linear."""

    def __init__(self, ir, gain=1.0):
        super().__init__(ir)
        self._gain = _f32(gain)

    def build(self, c_global, c_local, n_local):
        if self._gain.ndim == 1:
            self._gain = self.pad_channels(self._gain, c_global, "gain")
        super().build(c_global, c_local, n_local)
        self.params["gain"] = self._gain
        self.param_spec["gain"] = (
            P() if self._gain.ndim == 0 else P(CH_AXIS)
        )

    def apply(self, carry, params, x):
        carry, y = super().apply(carry, params, x)
        g = params["gain"]
        if g.ndim == 1:
            g = g[:, None]
        return carry, y * g


def _sharded_envelope(carry_env, carry_lo, xa, release_coef, attack_oma):
    """Smoothed peak envelope over a time-sharded chunk: the (associative)
    max-decay release follower and one-pole attack smoother of
    ``pipe_tpu_torch.ops.dynamics`` run as local scans, then extend across
    ranks via an exclusive prefix of the per-rank scan totals, exactly the
    biquad mechanic. The attack smoother gets the same refinement pass as
    the streaming engine (``ops.dynamics.envelope_block``): the residual,
    with the dd coefficient complement and the dd state low word, is
    filtered as a second zero-entering cross-rank recurrence, so the sharded
    envelope holds the streaming engine's floor. Every product is
    elementwise: the same bits under every precision name.
    Returns ``(new_env (C,2), new_lo (C,), env (C,N))``."""
    C, N = xa.shape
    ones = torch.ones((C,), dtype=torch.float32, device=xa.device)
    zeros = torch.zeros((C,), dtype=torch.float32, device=xa.device)
    # 1) local max-decay scan, zero-seeded
    decay_cum, raw_loc = prefix_scan(
        _max_decay_combine, (release_coef.expand(C, N), xa))
    # 2) entering value via the cross-rank exclusive prefix of totals
    pre_a, pre_m = exclusive_prefix(
        TIME_AXIS, _max_decay_combine, (ones, zeros),
        (decay_cum[:, -1], raw_loc[:, -1]),
    )
    enter_raw = torch.maximum(pre_m, carry_env[:, 0] * pre_a)
    # 3) correction: raw[n] = max(raw_loc[n], enter_raw * r^(n+1))
    raw = torch.maximum(raw_loc, enter_raw[:, None] * decay_cum)

    # 4) attack smoother on corrected raw, same two-step structure. dd
    # coefficient: ca_hi + ca_lo == 1 - oma exactly (eager ops fold nothing,
    # see ops.dynamics.envelope_block)
    oma = attack_oma
    ca_hi = 1.0 - oma
    ca_lo = (1.0 - ca_hi) - oma
    e0 = carry_env[:, 1]
    cab = ca_hi.expand(C, N)
    # um is the rounded forcing oma*raw; ue its exact error term, reused by
    # the refinement residual
    um, ue = _two_prod(oma.expand(C, N), raw)

    def chunk_recurrence(v, enter):
        """y[n] = ca_hi y[n-1] + v[n] across the whole chunk, entering
        value ``enter`` (C,) at the chunk start."""
        cum, loc = prefix_scan(_affine1_combine, (cab, v))
        pca, pu = exclusive_prefix(
            TIME_AXIS, _affine1_combine, (ones, zeros),
            (cum[:, -1], loc[:, -1]),
        )
        return loc + (pca * enter + pu)[:, None] * cum

    y = chunk_recurrence(um, e0)

    # 5) refinement: accurate residual (the previous output crosses the
    # rank boundary as a one-sample halo), filtered as a second
    # zero-entering chunk recurrence
    yprev = torch.cat(
        [halo_from_left(y, 1, TIME_AXIS, e0[:, None]), y[:, :-1]], dim=1
    )
    p, pe = _two_prod(cab, yprev)
    s, se = _two_sum(p, um)
    res = (s - y) + (pe + se + ue) + ca_lo * yprev
    # the carried dd low word enters at the GLOBAL first sample only (local
    # arithmetic: no collective sits in this branch)
    if require_mesh().axis_index(TIME_AXIS) == 0:
        res[:, 0] += ca_hi * carry_lo
    dy = chunk_recurrence(res, zeros)
    env = y + dy

    eh, el = _two_sum(y[:, -1], dy[:, -1])
    new_env = last_shard(torch.stack([raw[:, -1], eh], dim=1), TIME_AXIS)
    new_lo = last_shard(el, TIME_AXIS)
    return new_env, new_lo, env


class _EnvelopeStage(Stage):
    """Shared build of the envelope-driven stages: the envelope carry
    (``env`` (C, 2) and its dd low word ``env_lo`` (C,)) and scalar params,
    all live."""

    _p: dict
    sample_rate: float

    def _gain(self, env, params):
        raise NotImplementedError

    def build(self, c_global, c_local, n_local):
        self.carry = {
            "env": np.zeros((c_global, 2), np.float32),
            "env_lo": np.zeros((c_global,), np.float32),
        }
        self.params = {k: _f32(v) for k, v in self._p.items()}
        self.carry_spec = {"env": P(CH_AXIS, None), "env_lo": P(CH_AXIS)}
        self.param_spec = {k: P() for k in self._p}
        self.out_c_global, self.out_c_local, self.out_n_local = (
            c_global, c_local, n_local,
        )

    def apply(self, carry, params, x):
        rc = _decay_coef(params["release_ms"], self.sample_rate)
        ao = _attack_oma(params["attack_ms"], self.sample_rate)
        new_env, new_lo, env = _sharded_envelope(
            carry["env"], carry["env_lo"], torch.abs(x), rc, ao
        )
        return ({"env": new_env, "env_lo": new_lo},
                x * self._gain(env, params))


class CompressorStage(_EnvelopeStage):
    """Peak compressor, time-sharded via :func:`_sharded_envelope`."""

    def __init__(self, threshold_db=-18.0, ratio=4.0, attack_ms=5.0,
                 release_ms=120.0, makeup_db=0.0, sample_rate=44100.0):
        self._p = dict(
            threshold_db=threshold_db, ratio=ratio, attack_ms=attack_ms,
            release_ms=release_ms, makeup_db=makeup_db,
        )
        self.sample_rate = float(sample_rate)

    def _gain(self, env, params):
        return compressor_gain(
            env, params["threshold_db"], params["ratio"], params["makeup_db"]
        )


class LimiterStage(CompressorStage):
    """Peak limiter: a compressor with an infinite ratio (gain above the
    threshold is fully cancelled after the attack window)."""

    def __init__(self, threshold_db=-1.0, attack_ms=0.5, release_ms=50.0,
                 makeup_db=0.0, sample_rate=44100.0):
        super().__init__(
            threshold_db=threshold_db, ratio=float("inf"),
            attack_ms=attack_ms, release_ms=release_ms,
            makeup_db=makeup_db, sample_rate=sample_rate,
        )


class GateStage(_EnvelopeStage):
    """Downward-expander noise gate (``pipe_tpu_torch.ops.dynamics
    .NoiseGate``), time-sharded: same envelope machinery as the compressor,
    hard gain split at the threshold."""

    def __init__(self, threshold_db=-50.0, range_db=80.0, attack_ms=1.0,
                 release_ms=200.0, sample_rate=44100.0):
        self._p = dict(
            threshold_db=threshold_db, range_db=range_db,
            attack_ms=attack_ms, release_ms=release_ms,
        )
        self.sample_rate = float(sample_rate)

    def _gain(self, env, params):
        env_db = 20.0 * torch.log10(torch.clamp_min(env, 1e-8))
        atten = torch.pow(10.0, -params["range_db"] / 20.0)
        return torch.where(env_db >= params["threshold_db"], 1.0, atten)


class DelayStage(Stage):
    """Pure delay / feedback echo, time-sharded, for ANY ``delay_frames``.

    The delay-line state is a TIME-SHARDED BLOCK RING: each rank carries its
    OWN last ``kc = ceil(D/N)`` local blocks of the delayed stream (``N`` =
    global chunk frames), so carry memory is O(C*D/T) per rank and the carry
    update is a local roll, zero collectives. The tap ``d[i] = s[global_i -
    D]`` is one n-wide window of the virtual block stream, split over at
    most two source blocks ``h = ceil(D/n)`` and ``h-1`` hops to the left:
    two cyclic shifts move EXACTLY the needed (n-r)- and r-sample slices
    (``r = h*n - D``), each source selecting the ring slot its destination's
    chunk-back distance asks for.

    Four regimes, the JAX package's choice:

    - **pure delay** (no feedback requested, ``D < N``): ring of the input
      stream x; feedback is structurally unavailable.
    - **feedback free** (``D >= N``): the tap reads only PREVIOUS chunks, so
      the recurrence ``s[n] = x[n] + fb*s[n-D]`` never crosses ranks within
      a chunk: the ring stores s and feedback is structurally free;
      ``feedback`` is a live parameter.
    - **feedback echo with** ``D <= n_local`` (ladder): the recurrence
      crosses rank boundaries; the D-history transfer across one m-sample
      segment is an affine map with a rotated index (lane j gets gain
      ``fb^{(m+j)//D}`` and rotation ``m % D``, both closed forms in m), so
      only the (C, D) offset vectors ride the cross-rank exclusive-prefix
      ladder of shifts. The carry is the replicated ``hist`` (C, D).
    - **feedback echo with** ``n_local < D < N`` (wave-DAG): the dependency
      distance D makes positions ``[w*D, (w+1)*D)`` a wave depending only
      on the wave before it, so the whole chunk evaluates in ``W =
      ceil(N/D)`` ELEMENTWISE passes, each fetching its D-back window with
      the pure tap's two exact-slice cyclic shifts (the CURRENT s in the
      send buffer): 2 W collectives a chunk, each a call from the host. The
      evaluation order is exactly the sequential recurrence, so the
      precision is the streaming engine's.

    The recurrences are elementwise and scans: nothing here consults the
    precision knob.
    """

    def __init__(self, delay_frames: int, feedback: float = 0.0,
                 wet: float = 1.0, dry: float = 0.0,
                 allow_feedback: Optional[bool] = None):
        if delay_frames < 1:
            raise ValueError("delay_frames must be >= 1")
        if allow_feedback is False and feedback != 0.0:
            raise ValueError(
                "contradictory arguments: nonzero feedback with "
                "allow_feedback=False (the pure-delay path would silently "
                "ignore the feedback)"
            )
        self.delay_frames = int(delay_frames)
        self._init = dict(feedback=feedback, wet=wet, dry=dry)
        self._allow_feedback = allow_feedback

    def build(self, c_global, c_local, n_local):
        D = self.delay_frames
        T = max(1, int(self.time_shards))
        N = n_local * T  # global chunk frames
        self._n, self._T, self._N = n_local, T, N
        # D >= N makes feedback structurally free (the tap only reads
        # previous chunks), mirroring the streaming ring at D >= block
        self.can_feedback = (
            D >= N
            or self._init["feedback"] != 0.0
            or bool(self._allow_feedback)
        )
        # Feedback regimes by D vs the sharding:
        #   D <= n_local : offsets-only affine prefix LADDER
        #   n_local < D < N : WAVE-DAG, ceil(N/D) elementwise waves of
        #                  exact-slice ring fetches; bitwise the sequential
        #                  evaluation order
        #   D >= N       : structurally free (ring of s, zero extra)
        self._wave = self.can_feedback and n_local < D < N
        self._ladder = self.can_feedback and D <= n_local
        self.params = {k: _f32(v) for k, v in self._init.items()}
        self.param_spec = {k: P() for k in self._init}
        if self._ladder:
            # D <= n_local: the replicated history is bounded by the chunk
            self.carry = {"hist": np.zeros((c_global, D), np.float32)}
            self.carry_spec = {"hist": P(CH_AXIS, None)}
        else:
            kc = -(-D // N)
            self._kc = kc
            # block ring: rank g's columns hold ITS OWN blocks from
            # chunk-back kc..1 (oldest first): carry memory /T
            self.carry = {"ring": np.zeros((c_global, kc * N), np.float32)}
            self.carry_spec = {"ring": P(CH_AXIS, TIME_AXIS)}
        self.out_c_global, self.out_c_local, self.out_n_local = (
            c_global, c_local, n_local,
        )

    # -- block-ring tap: exact-slice cyclic fetch ------------------------

    def _fetch(self, buf, k, lo, hi):
        """Columns ``[lo, hi)`` of virtual stream block ``g - k`` (``g`` =
        this rank's time index; block ``-m`` = the stream's m-th block
        back, owned by rank ``(g-k) mod T`` at chunk-back ``ceil((k -
        dst)/T)``). ``buf`` is the shared send buffer ``[zeros | ring |
        current]`` (zeros resolve reads past the ring depth, the stream's
        prehistory; the current slot is zeros on the D >= N feedback ring,
        where it is provably never selected). Each rank ships only the
        [lo, hi) window its single cyclic destination needs. Whether there
        is a call depends on ``k`` and the mesh only, never on the rank."""
        n, T, kc = self._n, self._T, self._kc
        w = hi - lo
        if w <= 0:
            return buf[:, :0]
        mesh = require_mesh()
        g = mesh.axis_index(TIME_AXIS)
        dst = (g + k) % T
        # chunk-backs my destination needs (0 = its current chunk)
        q = max((k - dst + T - 1) // T, 0)
        # send-buffer slots: [zeros | back-kc .. back-1 | current]; back-q
        # lives at slot kc+1-q, clamped onto the zero slot for prehistory
        slot = min(max(kc + 1 - q, 0), kc + 1)
        send = dynamic_slice(buf, slot * n + lo, w)
        # hops % T == 0: own ring slot, no communication
        return mesh.shift_right(send, TIME_AXIS, k % T, cyclic=True)

    def apply(self, carry, params, x):
        if self._ladder:
            return self._apply_ladder(carry, params, x)
        C, n = x.shape
        D = self.delay_frames
        ring = carry["ring"]  # (C, kc*n) own previous blocks
        h = -(-D // n)
        r = h * n - D  # 0 <= r < n: window offset in block g-h
        zero = torch.zeros_like(x)

        def tap(cur):
            # window [g*n - D, g*n - D + n) = block(g-h)[r:] ++
            # block(g-h+1)[:r]
            buf = torch.cat([zero, ring, cur], dim=1)
            return torch.cat(
                [self._fetch(buf, h, r, n), self._fetch(buf, h - 1, 0, r)],
                dim=1,
            )

        if self._wave:
            # positions [w*D, (w+1)*D) form wave w: each depends only on
            # the wave before it (s[p-D] is w-1's final value) or, for wave
            # 0, on the previous chunk's ring. Each wave is ONE elementwise
            # fma over a freshly fetched D-back window, masked to its own
            # positions.
            fb = params["feedback"]
            g = require_mesh().axis_index(TIME_AXIS)
            p = g * n + torch.arange(n, device=x.device)  # global position
            s = x
            delayed = zero
            for w in range(-(-self._N // D)):
                dfull = tap(s)
                mask = ((p >= w * D) & (p < (w + 1) * D))[None, :]
                s = torch.where(mask, x + fb * dfull, s)
                delayed = torch.where(mask, dfull, delayed)
        else:
            # for D >= N both pieces predate this chunk, so the ring may
            # store s and feedback is free (the current slot is then never
            # selected: pass zeros)
            delayed = tap(zero if self.can_feedback else x)
            s = x + params["feedback"] * delayed if self.can_feedback else x
        y = params["dry"] * x + params["wet"] * delayed
        return {"ring": torch.cat([ring[:, n:], s], dim=1)}, y

    def _apply_ladder(self, carry, params, x):
        C, n = x.shape
        D = self.delay_frames
        mesh = require_mesh()
        T = mesh.axis_size(TIME_AXIS)
        idx = mesh.axis_index(TIME_AXIS)
        hist = carry["hist"]  # (C, D): trailing D samples of s
        fb = params["feedback"]
        # 1) locally-driven response s0 (zero entering history): lane-
        # parallel scan over left-padded rows of D (pad lanes are zero, so
        # they do not perturb the real positions)
        w = (-n) % D
        m = (n + w) // D
        rows = F.pad(x, (w, 0)).reshape(C, m, D)
        _, s0_rows = prefix_scan(_affine1_combine,
                                 (fb.expand(rows.shape), rows))
        s0 = s0_rows.reshape(C, m * D)[:, w:]

        # 2) per-rank history transfer h_out[j] = fb^e_j h_in[(j+n)%D] + b_j
        # with e_j = (n+j)//D: the closed form of the lane-touch count over
        # an n-sample segment (0 for untouched lanes)
        j = torch.arange(D, device=x.device)

        def seg_map(seg):
            """(gains, rotation) of the composed transfer over a
            ``seg``-sample segment."""
            return _pow_int(fb, (seg + j) // D), seg % D

        a_dev, _ = seg_map(n)  # fb^0 = 1 on untouched lanes
        p = n - D + j  # position feeding lane j (negative = untouched)
        b_dev = torch.where(
            (p >= 0)[None, :], s0[:, p.clamp_min(0)], 0.0)  # (C, D)

        # cross-rank entering history via an OFFSETS-ONLY exclusive-prefix
        # ladder: the gain/rotation of any segment has a closed form, so
        # ranks derive them locally and only the (C, D) offsets ride the
        # shifts. Every rank calls every shift, whatever its index.
        # Hillis-Steele over seeds: acc_d covers segment [max(0, d-k), d)
        # before the step-k round, so the combine's later-segment map is
        # seg_map(min(d, k) * n)
        acc = mesh.shift_right(b_dev, TIME_AXIS, 1)  # zeros at index 0
        k = 1
        while k < T:
            recv = mesh.shift_right(acc, TIME_AXIS, k)
            if idx >= k:
                a_acc, r_acc = seg_map(min(idx, k) * n)
                acc = a_acc[None, :] * torch.roll(recv, -r_acc, dims=1) + acc
            k *= 2
        # entering history for this rank
        pre_a, pre_r = seg_map(idx * n)
        h_in = pre_a[None, :] * torch.roll(hist, -pre_r, dims=1) + acc

        # 3) boundary correction: s[i] = s0[i] + fb^{i//D + 1} h_in[i % D]
        i = torch.arange(n, device=x.device)
        s = s0 + _pow_int(fb, i // D + 1)[None, :] * h_in[:, i % D]

        # 4) delayed tap needs no exchange: history for the first D lanes,
        # the local stream after that
        if D >= n:
            delayed = h_in[:, :n]
        else:
            delayed = torch.cat([h_in, s[:, :-D]], dim=1)
        y = params["dry"] * x + params["wet"] * delayed

        # 5) carry: every rank applies its OWN transfer to its h_in; the
        # last rank's result is the global exit history
        h_out = a_dev[None, :] * torch.roll(h_in, -(n % D), dims=1) + b_dev
        return {"hist": broadcast_last(h_out, TIME_AXIS)}, y


class ChannelizerStage(Stage):
    """Polyphase DFT filterbank analysis bank, time-sharded: the branch-FIR
    history is a ``K*(S-1)``-sample input halo (the FIR tail mechanic); each
    rank channelizes its aligned local window independently. Output is ``C *
    2 * (K//2+1)`` stacked re/im channels at rate ``sr/K``
    (``pipe_tpu_torch.ops.channelizer`` layout)."""

    def __init__(self, num_channels: int, taps_per_branch: int = 16):
        if num_channels < 2 or num_channels % 2:
            raise ValueError("num_channels must be even and >= 2")
        self.K = int(num_channels)
        self._gp = _f32(polyphase_branches(
            design_prototype(num_channels, taps_per_branch), num_channels))

    def build(self, c_global, c_local, n_local):
        K = self.K
        S = int(self._gp.shape[1])
        H = K * (S - 1)
        if n_local % K:
            raise ShapeConstraintError(
                f"local chunk {n_local} must be a multiple of K={K}"
            )
        if H > n_local:
            raise ShapeConstraintError(
                f"channelizer halo {H} exceeds local chunk {n_local}"
            )
        self._H = H
        bins = K // 2 + 1
        self.carry = {"hist": np.zeros((c_global, H), np.float32)}
        self.params = {"gp": self._gp}
        self.carry_spec = {"hist": P(CH_AXIS, None)}
        self.param_spec = {"gp": P()}
        self.out_c_global = c_global * 2 * bins
        self.out_c_local = c_local * 2 * bins
        # C-major output layout: pad channels land at trailing rows
        self.out_c_user = self.user_channels(c_global) * 2 * bins
        self.out_n_local = n_local // K

    def apply(self, carry, params, x):
        C, N = x.shape
        K = self.K
        bins = K // 2 + 1
        left = halo_from_left(x, self._H, TIME_AXIS, carry["hist"])
        re, im = channelize_block(left, x, params["gp"], K)
        out = torch.stack([re, im], dim=2).reshape(C * bins * 2, N // K)
        new_hist = last_shard(_tail(x, self._H), TIME_AXIS)
        return {"hist": new_hist}, out


class IQMixStage(Stage):
    """Quadrature downconverter, time+channel sharded: exact integer-phase
    oscillator offset by each rank's global sample position. Output is
    ``(2*C, N)`` with each channel shard locally ordered [I..., Q...]
    (``pipe_tpu_torch.ops.demod.IQMix``; under channel sharding the I/Q
    pairing is per-shard, which downstream detector stages split locally).
    The carry ``n`` is the chunk's start index modulo the period: a host int
    on every rank, an int32 scalar among the global carries."""

    channel_pad_safe = False  # positional I/Q rail layout

    def __init__(self, freq_hz: float, sample_rate: float = 44100.0):
        self.freq_hz = float(freq_hz)
        self.num, self.den = _rationalize(freq_hz, sample_rate, 1 << 14)

    def build(self, c_global, c_local, n_local):
        self.carry = {"n": np.asarray(0, np.int32)}
        self.params = {}
        self.carry_spec = {"n": P()}
        self.param_spec = {}
        self._n_local = n_local
        self.out_c_global = 2 * c_global
        self.out_c_local = 2 * c_local
        self.out_n_local = n_local

    def apply(self, carry, params, x):
        C, N = x.shape
        mesh = require_mesh()
        # rank-local phase start: chunk start + my global offset
        n0 = (carry["n"]
              + mesh.axis_index(TIME_AXIS) * self._n_local) % self.den
        c, s, _ = osc_block(n0, self.num, self.den, N, x.device)
        i = x * c[None, :]
        q = x * (-s[None, :])
        new_n = (carry["n"]
                 + mesh.axis_size(TIME_AXIS) * self._n_local) % self.den
        return {"n": new_n}, torch.cat([i, q], dim=0)


class EnvelopeDetectorStage(Stage):
    """Magnitude over local I/Q pairs: ``(2C, N) -> (C, N)`` (AM detector,
    ``pipe_tpu_torch.ops.demod.EnvelopeDetector``). Stateless."""

    channel_pad_safe = False

    def build(self, c_global, c_local, n_local):
        if c_local % 2:
            raise ValueError("EnvelopeDetectorStage expects paired I/Q rails")
        self.carry = ()
        self.params = {}
        self.carry_spec = ()
        self.param_spec = {}
        self.out_c_global = c_global // 2
        self.out_c_local = c_local // 2
        self.out_n_local = n_local

    def apply(self, carry, params, x):
        half = x.shape[0] // 2
        i, q = x[:half], x[half:]
        return (), torch.sqrt(i * i + q * q)


class FMDiscriminatorStage(Stage):
    """Quadrature FM discriminator over local I/Q pairs: ``(2C, N) -> (C,
    N)`` of instantaneous frequency in cycles/sample
    (``pipe_tpu_torch.ops.demod.FMDiscriminator``). The previous I/Q sample
    is a one-sample halo from the left neighbour."""

    channel_pad_safe = False

    def build(self, c_global, c_local, n_local):
        if c_local % 2:
            raise ValueError("FMDiscriminatorStage expects paired I/Q rails")
        self.carry = {"prev": np.zeros((c_global, 1), np.float32)}
        self.params = {}
        self.carry_spec = {"prev": P(CH_AXIS, None)}
        self.param_spec = {}
        self.out_c_global = c_global // 2
        self.out_c_local = c_local // 2
        self.out_n_local = n_local

    def apply(self, carry, params, x):
        C, N = x.shape
        half = C // 2
        prev = halo_from_left(x, 1, TIME_AXIS, carry["prev"])  # (2C, 1)
        buf = torch.cat([prev, x], dim=1)  # (2C, 1+N)
        i, q = x[:half], x[half:]
        ip, qp = buf[:half, :N], buf[half:, :N]
        re = ip * i + qp * q
        im = ip * q - qp * i
        f = torch.atan2(im, re) / (2.0 * np.pi)
        new_prev = last_shard(_tail(x, 1), TIME_AXIS)
        return {"prev": new_prev}, f


class _SpectralStageBase(Stage):
    """Streaming STFT -> per-bin transform -> weighted-OLA, time-sharded.

    Two halos per chunk step, both one hop: the analysis history (each rank
    frames its windows against the left neighbour's trailing ``W - hop``
    samples, exactly the FIR tail mechanic) and the synthesis spill (the
    overlap-add contribution of each rank's last windows lands up to ``W -
    hop`` samples past its right edge, so it is sent to the right neighbour
    and added at its output start). The last rank's spill becomes the next
    chunk's carried OLA tail. Per-window transforms are memoryless, so
    sharded output matches the sequential stream (same windows at the same
    global hop alignment).
    """

    def __init__(self, window_size: int, hop: int):
        self.window_size = int(window_size)
        self.hop = int(hop)
        self._wa, self._ws = design_stft_window(self.window_size, self.hop)
        self._windows = {}  # device -> (analysis, synthesis) tensors

    @property
    def bins(self) -> int:
        return self.window_size // 2 + 1

    def _spectral_params(self):
        raise NotImplementedError

    def _spectral_param_specs(self):
        raise NotImplementedError

    def _transform(self, re, im, params):
        raise NotImplementedError

    def build(self, c_global, c_local, n_local):
        L = self.window_size - self.hop
        if n_local % self.hop != 0:
            raise ShapeConstraintError(
                f"local chunk {n_local} must be a multiple of hop {self.hop}"
            )
        if L > n_local:
            raise ShapeConstraintError(
                f"STFT halo {L} exceeds local chunk {n_local}; "
                "use a larger chunk or fewer time shards"
            )
        self.carry = {
            "hist": np.zeros((c_global, L), np.float32),
            "tail": np.zeros((c_global, L), np.float32),
        }
        self.params = self._spectral_params()
        self.carry_spec = {
            "hist": P(CH_AXIS, None),
            "tail": P(CH_AXIS, None),
        }
        self.param_spec = self._spectral_param_specs()
        self.out_c_global, self.out_c_local, self.out_n_local = (
            c_global, c_local, n_local,
        )

    def apply(self, carry, params, x):
        C, N = x.shape
        W, H = self.window_size, self.hop
        L = W - H
        win = self._windows.get(x.device)
        if win is None:
            win = self._windows[x.device] = (
                torch.from_numpy(self._wa).to(x.device),
                torch.from_numpy(self._ws).to(x.device),
            )
        left = halo_from_left(x, L, TIME_AXIS, carry["hist"])
        ext = torch.cat([left, x], dim=1)  # [history, chunk]
        spec = torch.fft.rfft(frame_hops(ext, W, H, N // H) * win[0], dim=-1)
        re, im = self._transform(spec.real, spec.imag, params)
        out = torch.fft.irfft(torch.complex(re, im), n=W, dim=-1) * win[1]
        acc = _ola_fold(out, H)  # (C, N + L)
        spill = acc[:, N:]  # lands on the right neighbour
        incoming = halo_from_left(spill, L, TIME_AXIS, carry["tail"])
        y = acc[:, :N].clone()
        y[:, :L] += incoming
        new_hist = last_shard(_tail(x, L), TIME_AXIS)
        new_tail = last_shard(spill, TIME_AXIS)
        return {"hist": new_hist, "tail": new_tail}, y


class SpectralGainStage(_SpectralStageBase):
    """Per-bin gain curve in the STFT domain, time+channel sharded. ``gains``
    is ``(bins,)`` shared (replicated) or ``(C, bins)`` per-channel (sharded
    over CH_AXIS); live-retunable between chunks."""

    def __init__(self, window_size: int, hop: int, gains=None):
        super().__init__(window_size, hop)
        if gains is None:
            gains = np.ones(self.bins, np.float32)
        g = _f32(gains)
        if g.ndim not in (1, 2) or g.shape[-1] != self.bins:
            raise ValueError(
                f"gains must be (bins,) or (C, bins) with bins={self.bins}"
            )
        self._gains = g

    def build(self, c_global, c_local, n_local):
        if self._gains.ndim == 2:
            self._gains = self.pad_channels(self._gains, c_global, "gains")
        super().build(c_global, c_local, n_local)

    def _spectral_params(self):
        return {"gains": self._gains}

    def _spectral_param_specs(self):
        return {"gains": P() if self._gains.ndim == 1 else P(CH_AXIS, None)}

    def _transform(self, re, im, params):
        g = params["gains"]
        g = g[None, None, :] if g.ndim == 1 else g[:, None, :]
        return re * g, im * g


class SpectralGateStage(_SpectralStageBase):
    """Per-bin noise gate (soft-knee downward expander) in the STFT domain,
    time+channel sharded. Threshold/reduction are live parameters."""

    def __init__(self, window_size: int, hop: int, threshold: float,
                 reduction_db: float = -80.0, knee_db: float = 6.0):
        super().__init__(window_size, hop)
        self._threshold = float(threshold)
        self._reduction_db = float(reduction_db)
        self.knee_db = max(float(knee_db), 1e-3)

    def _spectral_params(self):
        return {
            "threshold": np.float32(self._threshold),
            "reduction_db": np.float32(self._reduction_db),
        }

    def _spectral_param_specs(self):
        return {"threshold": P(), "reduction_db": P()}

    def _transform(self, re, im, params):
        mag = torch.sqrt(re * re + im * im) + 1e-30
        over_db = 20.0 * torch.log10(mag / params["threshold"])
        frac = torch.clamp(over_db / self.knee_db + 0.5, 0.0, 1.0)
        floor = 10.0 ** (params["reduction_db"] / 20.0)
        gain = floor + (1.0 - floor) * frac
        return re * gain, im * gain


def _zip_spec(tree, spec_tree):
    """``(leaves, specs, treedef)`` of a tree and its tree of ``P``."""
    leaves, treedef = tree_flatten(tree)
    specs, specdef = tree_flatten(spec_tree)
    if len(leaves) != len(specs):
        raise ValueError(
            f"tree {treedef} and its layout {specdef} do not match")
    return leaves, specs, treedef


def localize(mesh: Mesh, device, tree, spec_tree):
    """This rank's block of every leaf of a tree of global host arrays, as
    float32 tensors on ``device``; a 0-d integer leaf (a stream counter) as
    a host ``int``. A 0-d leaf stays 0-d."""
    leaves, specs, treedef = _zip_spec(tree, spec_tree)
    local = []
    for l, s in zip(leaves, specs):
        a = np.asarray(l)
        if a.ndim == 0 and np.issubdtype(a.dtype, np.integer):
            local.append(int(a))
            continue
        # np.array keeps a 0-d leaf 0-d (ascontiguousarray would not)
        block = mesh.local_block(a, s)
        local.append(torch.tensor(
            np.array(block, dtype=np.float32, order="C"), device=device))
    return tree_unflatten(treedef, local)


def globalize(mesh: Mesh, device, tree, spec_tree):
    """The global host arrays of a tree of this rank's tensors (a
    collective over every axis a leaf is sharded on; the other axes hold
    replicas). A host ``int`` comes back as an int32 scalar. ``device`` is
    where the transport takes its tensors from (a leaf elsewhere is moved
    there first)."""
    leaves, specs, treedef = _zip_spec(tree, spec_tree)
    out = []
    for l, s in zip(leaves, specs):
        if isinstance(l, int):
            out.append(np.asarray(l, np.int32))
            continue
        l = l.to(device)
        for dim, axis in enumerate(s.axes):
            if axis is None:
                continue
            parts = mesh.all_gather(l, axis)
            l = torch.cat(list(parts), dim=dim)
        out.append(l.cpu().numpy())
    return tree_unflatten(treedef, out)


class ShardedChain:
    """Compose stages into one chunk step over a mesh, with carried stream
    state. Every rank of the mesh builds the same chain and calls the same
    methods in the same order (they contain collectives).

    Args:
      mesh: a ``(ch, time)`` mesh from :func:`pipe_tpu_torch.parallel.make_mesh`.
      stages: stage list; :class:`MixStage` may only appear last.
      channels: global channel count (any count: non-dividing counts are
        zero-padded to the ch-axis multiple internally and sliced off the
        gathered output).
      chunk_frames: global frames per step (divisible by the time-axis size).
      device: where this rank computes; ``None``:
        :func:`pipe_tpu_torch.config.default_device` (the current card
        unless the CPU was asked for).
    """

    def __init__(self, mesh: Mesh, stages: Sequence[Stage], channels: int,
                 chunk_frames: int, device=None):
        self.mesh = mesh
        self.stages = list(stages)
        self.channels = channels
        self.chunk_frames = chunk_frames

        ch_shards = mesh.shape[CH_AXIS]
        t_shards = mesh.shape[TIME_AXIS]
        if chunk_frames % t_shards:
            raise ValueError(
                f"chunk_frames {chunk_frames} not divisible by {t_shards}"
            )
        c_user = channels
        c_global = -(-channels // ch_shards) * ch_shards  # padded
        self._c_pad_in = c_global
        c_local = c_global // ch_shards
        n_local = chunk_frames // t_shards
        self._c_local_in, self._n_local_in = c_local, n_local
        if not self.stages:
            raise ValueError("ShardedChain needs at least one stage")
        for st in self.stages:
            if c_user != c_global and not st.channel_pad_safe:
                raise ValueError(
                    f"{type(st).__name__} has a positional channel layout "
                    f"and needs channels divisible by the mesh channel "
                    f"axis ({ch_shards}); got {c_user}"
                )
            st.time_shards = t_shards
            st.c_user = c_user if c_user != c_global else None
            st.out_c_user = None
            st.build(c_global, c_local, n_local)
            if st.out_c_user is None:
                # channel-preserving stages keep the user count; channel-
                # changing stages either set out_c_user in build or are
                # pad-unsafe (c_user == c_global here)
                st.out_c_user = (
                    c_user if st.out_c_global == c_global
                    else st.out_c_global
                )
            c_user = st.out_c_user
            c_global, c_local, n_local = (
                st.out_c_global, st.out_c_local, st.out_n_local
            )
        final_reduces = any(
            getattr(st, "reduces_channels", False) for st in self.stages
        )
        if final_reduces and not getattr(self.stages[-1], "reduces_channels", False):
            raise ValueError("MixStage must be the last stage")
        self._reduces = final_reduces
        self.out_channels = c_user
        self.out_frames = n_local * t_shards
        self.out_c_local, self.out_n_local = c_local, n_local

        if not mesh.member:
            raise ValueError(
                f"rank {mesh.rank} lies outside the {ch_shards}x{t_shards} "
                "mesh and builds no chain")
        # the shape checks above depend on global shapes only, so every rank
        # has raised alike before anything below touches a device
        self.device = config.resolve_device(device)
        self.carries = tuple(
            self._localize(st.carry, st.carry_spec) for st in self.stages
        )
        self._param_cache: List[dict] = [{} for _ in self.stages]
        #: per stage, the collectives of the last step: {name: [calls, bytes]}
        self.last_comm: List[dict] = [{} for _ in self.stages]

    # -- global <-> local ----------------------------------------------------

    def _localize(self, tree, spec_tree):
        return localize(self.mesh, self.device, tree, spec_tree)

    def _globalize(self, tree, spec_tree):
        return globalize(self.mesh, self.device, tree, spec_tree)

    def params(self):
        """Every stage's parameters as this rank's tensors, read from
        ``stage.params`` now: a leaf replaced or edited in place since the
        last step is localized again (a live retune), the others are reused.
        Host arrays are compared by value, tensors by their version."""
        out = []
        for st, cache in zip(self.stages, self._param_cache):
            leaves, specs, treedef = _zip_spec(st.params, st.param_spec)
            local = []
            for i, (l, s) in enumerate(zip(leaves, specs)):
                hit = cache.get(i)
                if isinstance(l, torch.Tensor):
                    seen = l._version
                    fresh = hit is None or hit[0] is not l or hit[1] != seen
                    host = l.detach().cpu().numpy() if fresh else None
                else:
                    host = np.asarray(l)
                    fresh = (hit is None or hit[0] is not l
                             or not np.array_equal(hit[1], host))
                    seen = host.copy() if fresh else None
                if fresh:
                    hit = cache[i] = (l, seen, self._localize(host, s))
                local.append(hit[2])
            out.append(tree_unflatten(treedef, local))
        return tuple(out)

    def global_carries(self):
        """The stream state as global host arrays, stage by stage: the JAX
        chain's ``carries`` after ``np.asarray``. A collective."""
        return tuple(
            self._globalize(c, st.carry_spec)
            for c, st in zip(self.carries, self.stages)
        )

    def load_global_carries(self, carries) -> None:
        """Continue from ``carries``, a tuple of trees of global host arrays
        with the shapes of :meth:`global_carries` (for example a JAX
        chain's, built with the same stages on a mesh with the same channel
        axis)."""
        if len(carries) != len(self.stages):
            raise ValueError(
                f"{len(carries)} carry trees for {len(self.stages)} stages")
        new = []
        for c, st in zip(carries, self.stages):
            have, _, havedef = _zip_spec(st.carry, st.carry_spec)
            got, gotdef = tree_flatten(c)
            if gotdef != havedef:
                raise ValueError(
                    f"{type(st).__name__}: carry tree {gotdef} where the "
                    f"chain holds {havedef}")
            for h, g in zip(have, got):
                if tuple(np.shape(g)) != tuple(h.shape):
                    raise ValueError(
                        f"{type(st).__name__}: carry of shape {np.shape(g)} "
                        f"where the chain holds {h.shape}")
                if (np.issubdtype(np.asarray(g).dtype, np.integer)
                        != np.issubdtype(h.dtype, np.integer)):
                    raise ValueError(
                        f"{type(st).__name__}: carry of dtype "
                        f"{np.asarray(g).dtype} where the chain holds "
                        f"{h.dtype}")
            new.append(self._localize(c, st.carry_spec))
        self.carries = tuple(new)

    def _local_input(self, x) -> torch.Tensor:
        if isinstance(x, ShardedChunk):
            if tuple(x.local.shape) != (self._c_local_in, self._n_local_in):
                raise ValueError(
                    f"local block {tuple(x.local.shape)}, expected "
                    f"{(self._c_local_in, self._n_local_in)}")
            return x.local.to(self.device, torch.float32)
        if x.shape[1] != self.chunk_frames or x.shape[0] not in (
                self.channels, self._c_pad_in):
            raise ValueError(
                f"chunk of shape {tuple(x.shape)}, expected "
                f"({self.channels}, {self.chunk_frames})")
        ci = self.mesh.axis_index(CH_AXIS)
        ti = self.mesh.axis_index(TIME_AXIS)
        r0 = ci * self._c_local_in
        rows = max(0, min(r0 + self._c_local_in, x.shape[0]) - r0)
        blk = x[r0:r0 + rows,
                ti * self._n_local_in:(ti + 1) * self._n_local_in]
        blk = torch.as_tensor(blk).to(self.device, torch.float32)
        if rows < self._c_local_in:  # zero pad rows
            pad = blk.new_zeros((self._c_local_in - rows, self._n_local_in))
            blk = torch.cat([blk, pad], dim=0)
        return blk.contiguous()

    # -- the step ------------------------------------------------------------

    def step(self, x) -> torch.Tensor:
        """One chunk: the global ``x`` (channels, chunk_frames), or this
        rank's block from ``shard_host_chunk``, to THIS RANK'S BLOCK of the
        output ``(out_c_local, out_n_local)``, advancing carried state."""
        x = self._local_input(x)
        params = self.params()
        new_carries = []
        stats = self.mesh.stats
        with mesh_scope(self.mesh):
            for i, (st, c, p) in enumerate(zip(self.stages, self.carries, params)):
                before = {k: tuple(v) for k, v in stats.items()}
                c2, x = st.apply(c, p, x)
                new_carries.append(c2)
                self.last_comm[i] = {
                    k: [v[0] - before.get(k, (0, 0))[0],
                        v[1] - before.get(k, (0, 0))[1]]
                    for k, v in stats.items()
                    if tuple(v) != before.get(k, (0, 0))
                }
        self.carries = tuple(new_carries)
        return x

    def gather(self, y_local: torch.Tensor) -> torch.Tensor:
        """The global ``(out_channels, out_frames)`` output from every
        rank's block, on every rank (a collective)."""
        y = torch.cat(list(self.mesh.all_gather(y_local, TIME_AXIS)), dim=1)
        if not self._reduces:
            y = torch.cat(list(self.mesh.all_gather(y, CH_AXIS)), dim=0)
        return y[: self.out_channels]

    def process(self, x) -> np.ndarray:
        """Stream a long (channels, N) signal chunk by chunk (N divisible by
        chunk_frames) and return the concatenated global output as a host
        array, on every rank."""
        C, N = x.shape
        if N % self.chunk_frames:
            raise ValueError(f"N={N} not divisible by chunk {self.chunk_frames}")
        outs = []
        for i in range(N // self.chunk_frames):
            xc = x[:, i * self.chunk_frames: (i + 1) * self.chunk_frames]
            outs.append(self.gather(self.step(xc)).cpu().numpy())
        return np.concatenate(outs, axis=1)

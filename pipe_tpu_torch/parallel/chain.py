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

Stages so far (the sharded main path and the EQ): :class:`GainStage`,
:class:`FIRStage`, :class:`FIRCascadeStage`, :class:`ResampleStage`
(requires ``N_local*L % M == 0`` so every rank emits an equal count at
phase 0), :class:`FIRResampleStage`, :class:`BiquadStage` (float32 and
``precision='extended'``), :class:`BiquadCascadeStage`, :class:`MixStage`
(``all_reduce`` over the channel axis; must be last), :class:`FIRGainStage`,
:class:`MixGainStage`. The other stage names of the JAX package raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np
import torch

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
    split_f32_pair,
)
from pipe_tpu_torch.ops.fir import fir_apply
from pipe_tpu_torch.ops.fused import (
    cascade_taps,
    combine_bank,
    scaled_matrix,
    scaled_taps,
)
from pipe_tpu_torch.ops.resample import (
    _reduce_ratio,
    polyphase_design,
    resample_apply,
)
from pipe_tpu_torch.parallel.distributed import ShardedChunk
from pipe_tpu_torch.parallel.halo import (
    exclusive_prefix,
    halo_from_left,
    last_shard,
    psum,
)
from pipe_tpu_torch.parallel.mesh import CH_AXIS, TIME_AXIS, Mesh, P
from pipe_tpu_torch.parallel.meshctx import mesh_scope
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
    (``ops.biquad._iir_apply``: the CUDA tile kernel for a local block on
    the card that passes the tile gate):

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
    pass. On the card, each pass of a local block on the tile gate is one
    launch of ``kernels.iir_tiles``.

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
        entering states, shared by both passes. A (2, N) block fails the
        tile gate's channel rule and takes the float64 prefix-doubling
        path, log2(N) passes of small launches, so the result is kept until
        the coefficients change: the key is the coefficient tensor's
        address and version, and the tensor is held so that its address
        cannot be reused while the entry lives (``ShardedChain.params``
        hands over a new tensor whenever the host values changed)."""
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


def _not_ported(name: str):
    """A stage of the JAX package that the port does not have yet: its name
    exists and raises, instead of being absent silently."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"parallel.{name} is not ported to pipe_tpu_torch yet")

    return type(name, (Stage,), {"__init__": __init__, "__doc__": _not_ported.__doc__})


OLSStage = _not_ported("OLSStage")
OLSGainStage = _not_ported("OLSGainStage")
CompressorStage = _not_ported("CompressorStage")
LimiterStage = _not_ported("LimiterStage")
GateStage = _not_ported("GateStage")
DelayStage = _not_ported("DelayStage")
SpectralGainStage = _not_ported("SpectralGainStage")
SpectralGateStage = _not_ported("SpectralGateStage")
ChannelizerStage = _not_ported("ChannelizerStage")
IQMixStage = _not_ported("IQMixStage")
EnvelopeDetectorStage = _not_ported("EnvelopeDetectorStage")
FMDiscriminatorStage = _not_ported("FMDiscriminatorStage")


def _zip_spec(tree, spec_tree):
    """``(leaves, specs, treedef)`` of a tree and its tree of ``P``."""
    leaves, treedef = tree_flatten(tree)
    specs, specdef = tree_flatten(spec_tree)
    if len(leaves) != len(specs):
        raise ValueError(
            f"tree {treedef} and its layout {specdef} do not match")
    return leaves, specs, treedef


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
        """This rank's block of every leaf of a tree of global host arrays,
        as float32 tensors on the chain's device."""
        leaves, specs, treedef = _zip_spec(tree, spec_tree)
        local = [
            torch.tensor(np.ascontiguousarray(
                self.mesh.local_block(np.asarray(l, np.float32), s)),
                device=self.device)
            for l, s in zip(leaves, specs)
        ]
        return tree_unflatten(treedef, local)

    def _globalize(self, tree, spec_tree):
        """The global host arrays of a tree of local tensors (a collective
        over the channel axis; the time axis holds replicas)."""
        leaves, specs, treedef = _zip_spec(tree, spec_tree)
        out = []
        for l, s in zip(leaves, specs):
            for dim, axis in enumerate(s.axes):
                if axis is None:
                    continue
                parts = self.mesh.all_gather(l, axis)
                l = torch.cat(list(parts), dim=dim)
            out.append(l.cpu().numpy())
        return tree_unflatten(treedef, out)

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
            have, _, _ = _zip_spec(st.carry, st.carry_spec)
            got, _, _ = _zip_spec(c, st.carry_spec)
            for h, g in zip(have, got):
                if tuple(np.shape(g)) != tuple(h.shape):
                    raise ValueError(
                        f"{type(st).__name__}: carry of shape {np.shape(g)} "
                        f"where the chain holds {h.shape}")
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

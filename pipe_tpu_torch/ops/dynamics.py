"""Time-domain dynamics ops: delay/echo, peak compressor/limiter, noise
gate.

The PyTorch counterpart of :mod:`pipe_tpu.ops.dynamics`, with the same
state and params. The recurrences run as prefix scans over axis 1
(:func:`pipe_tpu_torch.ops.prims.prefix_scan`, the port of
``lax.associative_scan``):

- the release envelope follower ``env[n] = max(|x[n]|, r * env[n-1])`` over
  (decay, value) pairs, ``(a1, m1) . (a2, m2) = (a1*a2, max(m2, m1*a2))``;
- the attack smoother, a first-order IIR, over affine (a, u) pairs, with
  one refinement pass evaluated by error-free transforms;
- a feedback delay shorter than the block as D lane-parallel one-pole
  scans. Longer delays read carried state only.

On a CUDA block the envelope ops (``Compressor``, ``NoiseGate``) run the
two scans, the refinement and the gain as one hand-written kernel a block
(``kernels.envelope_block``, ``csrc/envelope.cu``); :func:`envelope_block`
and the gain functions here are its plain version, which CPU blocks run.

Tunables (times, thresholds, ratios, gains) are 0-d float32 param tensors,
and coefficients such as ``exp(-1/(tau*sr))`` are computed from them every
block, so retunes need no rebuild. Stream positions (the delay ring's
``pos``) are host ints.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pipe_tpu_torch import kernels
from pipe_tpu_torch.components import Processor, param_tensor
from pipe_tpu_torch.ops.biquad import _two_prod, _two_sum
from pipe_tpu_torch.ops.prims import (
    dynamic_slice,
    dynamic_update_slice_,
    prefix_scan,
)
from pipe_tpu_torch.signal import Signal, SignalProperties, zero_past


def _decay_coef(time_ms, sample_rate):
    """One-pole coefficient for a time constant in milliseconds."""
    t = torch.clamp_min(time_ms, 1e-3)
    return torch.exp(-1000.0 / (t * sample_rate))


def _attack_oma(time_ms, sample_rate):
    """``1 - coef`` for the attack smoother, computed directly with expm1,
    so its float32 rounding is relative to (1 - coef), not absolute near 1
    (for slow attacks the absolute rounding of ``exp`` would perturb the
    time constant enough to cap the refined smoother near 90 dB)."""
    t = torch.clamp_min(time_ms, 1e-3)
    return -torch.expm1(-1000.0 / (t * sample_rate))


def _max_decay_combine(left, right):
    """Associative combine for ``env[n] = max(v[n], a * env[n-1])``."""
    a1, m1 = left
    a2, m2 = right
    return a1 * a2, torch.maximum(m2, m1 * a2)


def _affine1_combine(left, right):
    """Associative combine for ``y[n] = a y[n-1] + u[n]`` (scalars)."""
    a1, u1 = left
    a2, u2 = right
    return a1 * a2, a2 * u1 + u2


def _pow_int(base, e):
    """``base ** e`` for an integer tensor of exponents ``e >= 0``, correct
    for a negative base. The JAX package takes libm's float32 ``powf`` of
    ``|base|``, within an ulp of the true power; here the power is taken
    in float64 and rounded once to float32, which agrees with it to that
    ulp."""
    mag = (torch.abs(base).double() ** e.double()).float()
    return torch.where((base < 0) & (e % 2 == 1), -mag, mag)


def envelope_block(env0, x_abs, frames: int, release_coef, attack_oma,
                   env0_lo=None):
    """Smoothed peak envelope over one block, the attack smoother refined
    to the float32 output-rounding floor.

    The release follower's max-decay scan injects only unamplified
    relative rounding; the attack one-pole amplifies its recurrence noise
    by kappa ~ 2*attack_ms*sr/1000. One refinement pass removes that: the
    residual of the scan against the accurate recurrence is formed with
    error-free transforms (including the dd complement of the float32
    coefficient and the dd low word of the carried state) and filtered
    once more.

    Args:
      env0: ``(C, 2)`` carried (release env, smoothed env) at the last valid
        frame of the previous block.
      x_abs: ``(C, B)`` rectified input, garbage past ``frames``.
      frames: valid count (host int).
      release_coef: 0-d tensor in (0, 1).
      attack_oma: 0-d tensor ``1 - attack_coef`` (:func:`_attack_oma`).
      env0_lo: ``(C,)`` dd low word of the carried smoothed env (zeros if
        None).

    Returns ``(new_env0, new_env0_lo, env)``, ``env`` (C, B).
    """
    C, B = x_abs.shape
    xa = zero_past(x_abs, frames)  # invalid frames only decay

    r = release_coef.expand(C, B)
    # seed the scan with the carried value: v[0] includes a * env0
    seed = torch.zeros_like(xa)
    seed[:, 0] = release_coef * env0[:, 0]
    _, raw = prefix_scan(_max_decay_combine, (r, torch.maximum(xa, seed)))

    # dd coefficient: ca_hi + ca_lo == 1 - oma exactly (both subtractions
    # are Sterbenz-exact; eager ops fold nothing)
    oma = attack_oma
    ca_hi = 1.0 - oma
    ca_lo = (1.0 - ca_hi) - oma
    e0 = env0[:, 1]
    if env0_lo is None:
        env0_lo = torch.zeros((C,), dtype=torch.float32, device=xa.device)
    cab = ca_hi.expand(C, B)
    # um is the rounded product oma*raw, the scan's forcing, and ue its
    # exact error term, reused by the refinement residual
    um, ue = _two_prod(oma.expand(C, B), raw)
    u_seeded = um.clone()
    u_seeded[:, 0] += ca_hi * e0
    _, y = prefix_scan(_affine1_combine, (cab, u_seeded))
    # refinement: the residual of y against the accurate recurrence,
    # filtered once more
    yprev = torch.cat([e0[:, None], y[:, :-1]], dim=1)
    p, pe = _two_prod(cab, yprev)
    s, se = _two_sum(p, um)
    res = (s - y) + (pe + se + ue) + ca_lo * yprev
    res[:, 0] += ca_hi * env0_lo
    _, dy = prefix_scan(_affine1_combine, (cab, res))
    env = y + dy

    # carry = values at the last valid frame; the smoothed-env carry keeps
    # its dd low word so the boundary does not re-quantize the state
    last = min(max(frames - 1, 0), B - 1)
    eh, el = _two_sum(y[:, last], dy[:, last])
    new0 = torch.stack([raw[:, last], eh], dim=1)
    return new0, el, env


def compressor_gain(env, threshold_db, ratio, makeup_db, floor=1e-8):
    """Hard-knee downward compression gain from a linear envelope."""
    env_db = 20.0 * torch.log10(torch.clamp_min(env, floor))
    over = torch.clamp_min(env_db - threshold_db, 0.0)
    # ratio may be inf (limiter): 1 - 1/ratio -> 1
    slope = 1.0 - 1.0 / torch.clamp_min(ratio, 1.0)
    gain_db = -over * slope + makeup_db
    return torch.pow(10.0, gain_db / 20.0)


class Delay:
    """Pure delay / feedback echo processor, for any ``delay_frames``.

    ``feedback`` feeds the delayed OUTPUT back (classic echo); ``wet`` and
    ``dry`` mix the delayed and direct paths; all three are live params.

    Feedback capability is structural: with ``D >= block_size`` the tap
    reads carried state only, so feedback is always available; for
    ``D < block_size`` the in-block recurrence runs only when requested
    (a nonzero ``feedback`` or ``allow_feedback=True`` at construction),
    else ``set_feedback`` raises.
    """

    def __init__(self, delay_frames: int, feedback: float = 0.0,
                 wet: float = 1.0, dry: float = 0.0, allow_feedback=None):
        if delay_frames < 1:
            raise ValueError("delay_frames must be >= 1")
        if allow_feedback is False and feedback != 0.0:
            raise ValueError(
                "contradictory arguments: nonzero feedback with "
                "allow_feedback=False"
            )
        self.delay_frames = delay_frames
        self._feedback = feedback
        self._wet = wet
        self._dry = dry
        self._allow_feedback = allow_feedback
        self._component = None
        self.context = None

    def processor(self):
        D = self.delay_frames

        def alloc(mctx, block_size, props: SignalProperties):
            can_feedback = (D >= block_size or self._feedback != 0.0
                            or bool(self._allow_feedback))
            self._can_feedback = can_feedback
            self.context = mctx
            C, B = props.channels, block_size
            scan_path = can_feedback and D < B
            # D >= B: the delay line is a MIRRORED RING of L = D + B
            # samples: every sample is written at its canonical index
            # (pos mod L) and at the mirror (pos mod L) + L, so any
            # L-window read is one contiguous slice and a block moves O(B)
            # samples, not O(D). Reads precede writes, so the tap window
            # [t-D, t-D+B) always holds valid history.
            #
            # Layout: [pad B | canonical L | mirror L | pad B]. A block
            # lands at three starts: B+pos (canonical, spilling into the
            # mirror when it wraps), B+pos+L (mirror, spilling into the
            # right pad) and pos+B-L. On a wrap the third writes exactly
            # the low canonical indices [0, pos+B-L) that the first write
            # reaches only as mirrors; without it those slots go stale
            # whenever delay_frames % block_size != 0 or after a partial
            # block. Without a wrap its start is <= 0, and lax's index rule
            # (prims.dynamic_update_slice_) lands it in the left pad (start
            # 0) or at mirror index >= pos + 2B or in the right pad: reads
            # reach the mirror only below index B, so nothing reads it.
            ring_path = D >= B
            L = D + B
            if scan_path:
                # sample i of a block sits on lane i % D, (i // D + 1)
                # feedback steps after the entering history
                i = torch.arange(B, device=props.device)
                lane, steps = i % D, i // D + 1

            def step(state, params, sig: Signal):
                # the delay line carries s = x + fb * s[n-D] (s = x without
                # feedback); the output is dry*x + wet*s[n-D]
                xm = zero_past(sig.data, sig.frames)
                fb = params["feedback"]
                if ring_path:
                    pos = state["pos"]  # stream position mod L
                    ring = state["ring"]
                    delayed = dynamic_slice(ring, B + (pos - D) % L, B)
                    s = xm + fb * delayed
                    ring = ring.clone()
                    for start in (B + pos, B + pos + L, pos + (B - L)):
                        dynamic_update_slice_(ring, s, start)
                    y = params["dry"] * xm + params["wet"] * delayed
                    new_state = {"ring": ring,
                                 "pos": (pos + sig.frames) % L}
                    return new_state, sig.with_data(y)
                hist = state["hist"]  # (C, D): trailing D samples of s
                if not scan_path:
                    delayed = torch.cat([hist, xm], dim=1)[:, :B]
                    s = xm
                else:
                    # in-block recurrence: D independent lanes, each a
                    # one-pole over its own samples, the carry being the
                    # entering history; lanes past `frames` compute
                    # garbage that the frames-sliced carry never reads
                    w = (-B) % D
                    m = (B + w) // D
                    rows = F.pad(xm, (w, 0)).reshape(C, m, D)
                    _, s0r = prefix_scan(_affine1_combine,
                                         (fb.expand(rows.shape), rows))
                    s0 = s0r.reshape(C, m * D)[:, w:]
                    s = s0 + _pow_int(fb, steps)[None, :] * hist[:, lane]
                    delayed = torch.cat([hist, s[:, : B - D]], dim=1)
                y = params["dry"] * xm + params["wet"] * delayed
                buf = torch.cat([hist, s], dim=1)
                return ({"hist": dynamic_slice(buf, sig.frames, D)},
                        sig.with_data(y))

            if ring_path:
                # B + 2L + B: the left pad absorbs the no-wrap repair
                # write, the right pad the mirror write's spill (pads are
                # never read)
                state0 = {
                    "ring": torch.zeros((C, 2 * L + 2 * B),
                                        dtype=torch.float32,
                                        device=props.device),
                    "pos": 0,
                }
            else:
                state0 = {"hist": torch.zeros((C, D), dtype=torch.float32,
                                              device=props.device)}
            self._component = Processor(
                output=props,
                step=step,
                state=state0,
                params={
                    "feedback": param_tensor(self._feedback, props.device),
                    "wet": param_tensor(self._wet, props.device),
                    "dry": param_tensor(self._dry, props.device),
                },
            )
            return self._component

        return alloc

    def set_feedback(self, fb):
        if not getattr(self, "_can_feedback", True):
            raise ValueError(
                "this Delay cannot do feedback: it was built pure with "
                "delay_frames < block_size (pass feedback=... or "
                "allow_feedback=True at construction)"
            )
        return self.context.mutate(
            lambda: self._component.replace_param("feedback", fb))

    def set_mix(self, wet, dry):
        def fn():
            self._component.replace_param("wet", wet)
            self._component.replace_param("dry", dry)

        return self.context.mutate(fn)


class _EnvelopeDynamics:
    """Shared plumbing of the envelope-driven processors: the envelope
    state (``env`` (C, 2) and its dd low word ``env_lo`` (C,)), scalar
    params, and :meth:`set`. A CUDA block goes through
    ``kernels.envelope_block`` (a gate's gain where ``_kind`` is
    ``"gate"``, else a compressor's), a CPU block through
    :func:`envelope_block` and :meth:`_gain`."""

    _kind = ""

    def __init__(self, **params):
        self._p = params
        self._component = None
        self.context = None

    def _gain(self, env, params):
        raise NotImplementedError

    def processor(self):
        def alloc(mctx, block_size, props: SignalProperties):
            self.context = mctx
            C, sr = props.channels, props.sample_rate

            def step(state, params, sig: Signal):
                if sig.data.is_cuda:
                    gate = self._kind == "gate"
                    y, new0, new_lo = kernels.envelope_block(
                        sig.data.contiguous(), sig.frames, state["env"],
                        state["env_lo"], params["attack_ms"],
                        params["release_ms"], sr, gate,
                        params["threshold_db"],
                        params["range_db" if gate else "ratio"],
                        params.get("makeup_db"))
                    return ({"env": new0, "env_lo": new_lo},
                            sig.with_data(y))
                rc = _decay_coef(params["release_ms"], sr)
                ao = _attack_oma(params["attack_ms"], sr)
                new0, new_lo, env = envelope_block(
                    state["env"], torch.abs(sig.data), sig.frames, rc, ao,
                    state["env_lo"],
                )
                g = self._gain(env, params)
                return ({"env": new0, "env_lo": new_lo},
                        sig.with_data(sig.data * g))

            # named for the subclass, as the other ops' steps are for
            # theirs: the span of the step is op.<subclass>
            step.__qualname__ = (f"{type(self).__qualname__}."
                                 "processor.<locals>.alloc.<locals>.step")

            self._component = Processor(
                output=props,
                step=step,
                state={
                    "env": torch.zeros((C, 2), dtype=torch.float32,
                                       device=props.device),
                    "env_lo": torch.zeros((C,), dtype=torch.float32,
                                          device=props.device),
                },
                params={k: param_tensor(v, props.device)
                        for k, v in self._p.items()},
            )
            return self._component

        return alloc

    def set(self, **kwargs):
        """Mutate any of the processor's params (the constructor's
        keywords)."""
        unknown = set(kwargs) - set(self._p)
        if unknown:
            raise KeyError(f"unknown {self._kind} params: {sorted(unknown)}")

        def fn():
            for k, v in kwargs.items():
                self._component.replace_param(k, v)

        return self.context.mutate(fn)


class Compressor(_EnvelopeDynamics):
    """Peak compressor / limiter (``ratio=inf``) with attack/release
    envelope. Every parameter is live."""

    _kind = "compressor"

    def __init__(self, threshold_db: float = -18.0, ratio: float = 4.0,
                 attack_ms: float = 5.0, release_ms: float = 120.0,
                 makeup_db: float = 0.0):
        super().__init__(threshold_db=threshold_db, ratio=ratio,
                         attack_ms=attack_ms, release_ms=release_ms,
                         makeup_db=makeup_db)

    def _gain(self, env, params):
        return compressor_gain(env, params["threshold_db"], params["ratio"],
                               params["makeup_db"])


class NoiseGate(_EnvelopeDynamics):
    """Downward expander gate: attenuates by ``range_db`` when the smoothed
    envelope falls below ``threshold_db``."""

    _kind = "gate"

    def __init__(self, threshold_db: float = -50.0, range_db: float = 80.0,
                 attack_ms: float = 1.0, release_ms: float = 200.0):
        super().__init__(threshold_db=threshold_db, range_db=range_db,
                         attack_ms=attack_ms, release_ms=release_ms)

    def _gain(self, env, params):
        env_db = 20.0 * torch.log10(torch.clamp_min(env, 1e-8))
        atten = torch.pow(10.0, -params["range_db"] / 20.0)
        return torch.where(env_db >= params["threshold_db"], 1.0, atten)

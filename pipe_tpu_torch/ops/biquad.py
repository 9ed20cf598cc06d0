"""Biquad IIR EQ: the FIR part of each section plus the all-pole recurrence
``y[n] = v[n] - a1 y[n-1] - a2 y[n-2]``, with one refinement pass.

The PyTorch counterpart of :mod:`pipe_tpu.ops.biquad`'s default float32
path. One predicate, ``kernels.section_gate`` (a channel count that is a
positive multiple of 8, any ``B >= 1``), decides which blocks on the card
reach the hand-written CUDA kernels (``csrc/iir_tiles.cu``), with no
fallback: a whole section (:func:`biquad_section_block`) is one
``kernels.biquad_section`` call (the FIR part, the recurrence, the
refinement pass and the state update together), the recurrence alone
(:func:`_iir_apply`, which the sharded ``BiquadStage`` runs) one
``kernels.iir_tiles`` call, the port of the TPU's Pallas tile kernel.
Every other block takes the plain versions, :func:`_biquad_section_ref`
and :func:`_iir_plain`, whose recurrence runs

- on a block that passes the gate as :func:`_iir_tiles`, the kernels'
  three passes over 256-sample tiles (:func:`_iir_tiles_ref`): every
  tile's product with the lower-triangular Toeplitz matrix of the impulse
  response at once, the (C, 2) carries from tile to tile, and the rank-2
  boundary term added to all tiles; a partial last tile is zero-padded, as
  the kernels read it;
- on any other block as :func:`_iir_assoc`: the affine recurrence over
  2-vectors, ``s[n] = A s[n-1] + u[n]``, by prefix doubling over
  ``(A, u)`` pairs in float64.

``Biquad(precision='extended')`` runs each section in double-f32 instead:
coefficients, forcing, recurrence and carried state are unevaluated
float32 pairs ``hi + lo`` (about 2^-48 relative), so the rounding noise
that the recurrence amplifies by ``kappa = ||1/A||_2`` (hundreds for
sections below 200 Hz at 44.1 kHz) no longer sets the floor; only the
block output is rounded once to float32. The pole recurrence runs as a
prefix-doubling scan of double-f32 affine maps (:func:`_dd_prefix_scan`),
log2(B) passes of a hundred or so elementwise tensor ops each: plain
PyTorch on the card, many small launches.
"""

from __future__ import annotations

import numpy as np
import torch

from pipe_tpu_torch import kernels
from pipe_tpu_torch.components import Processor, param_tensor
from pipe_tpu_torch.ops.prims import dynamic_slice, prefix_scan
from pipe_tpu_torch.signal import Signal, zero_past

_TILE_Q = kernels.IIR_TILE


def _iir_sequences(a1, a2, Q: int):
    """Length-Q impulse/boundary responses of ``y[n] = v[n] - a1 y[n-1] -
    a2 y[n-2]``, by the step-by-step recurrence in float64, each rounded
    once to float32 (the kernel's prologue does the same):

      g[i]     — response to v = delta (zero initial state)
      alpha[i] — response to y[-1] = 1 (v = 0)
      beta[i]  — response to y[-2] = 1 (v = 0)

    Every tile is then ``y = Tl @ v + y[-1] * alpha + y[-2] * beta`` with
    ``Tl[i, j] = g[i-j]``. Near DC these responses grow to ~100 from
    terms that cancel, and a float32 recurrence costs the streamed output
    ~9 dB on a 20 Hz section at 44.1 kHz.

    The recurrence runs on Python floats (IEEE float64, each product and
    difference rounded as a float64 tensor op rounds it): a few hundred
    tensor ops on scalars would cost milliseconds a call.
    """
    device = a1.device
    a1, a2 = float(a1), float(a2)
    seqs = []
    # values at i = 0 and i = -1 of g, alpha and beta
    for y1, y2 in ((1.0, 0.0), (-a1, 1.0), (-a2, 0.0)):
        seq = [y1]
        for _ in range(Q - 1):
            y1, y2 = -a1 * y1 - a2 * y2, y1
            seq.append(y1)
        seqs.append(seq)
    seqs = torch.tensor(seqs, dtype=torch.float64, device=device).float()  # (3, Q)
    return seqs[0], seqs[1], seqs[2]


def _iir_tiles_ref(v, s, TlT, ab, Q: int):
    """Plain version of the tile kernel, in its three passes; ``s`` and
    every carry are (C, 2) = (y[-1], y[-2]) of a tile. A partial last tile
    is zero-padded: the recurrence is causal, so the zeros past B change no
    output before it."""
    C, B = v.shape
    T = -(-B // Q)
    if T * Q != B:
        v = torch.nn.functional.pad(v, (0, T * Q - B))
    # 1. zero-state products of all tiles at once, in float64 and rounded
    # once: a float32 product on the card follows the precision knob of
    # pipe_tpu_torch.config (TF32 under 'default' and 'high'), and the
    # recurrence must not
    z = (v.reshape(C * T, Q).double() @ TlT.double()).float().reshape(C, T, Q)
    # 2. the carries, tile by tile: a tile's last two outputs
    carries, carry = [], s
    for t in range(T):
        carries.append(carry)
        last = (z[:, t, Q - 2:] + carry[:, 0:1] * ab[0, Q - 2:]
                + carry[:, 1:2] * ab[1, Q - 2:])
        carry = last.flip(1)
    c = torch.stack(carries, dim=1)  # (C, T, 2)
    # 3. the boundary term of every tile
    y = (z + c[:, :, 0:1] * ab[0] + c[:, :, 1:2] * ab[1]).reshape(C, T * Q)
    return y[:, :B].contiguous()


def _iir_assoc(v, s, a1, a2):
    """The recurrence as an inclusive prefix of affine maps
    ``(A, u) = ([[-a1, -a2], [1, 0]], (v[n], 0))`` by prefix doubling
    (Hillis-Steele): ``pref[i] = pref[i] after pref[i - k]`` for
    k = 1, 2, 4, ... The matrices are the same for every channel, so they
    stay ``(B,)`` entries while the vectors are ``(C, B)``.

    The prefix runs in float64 and the output is rounded once. Near DC the
    prefix products cancel: for a 20 Hz section at 44.1 kHz, ``A^512`` has
    entries near 150 while its eigenvalues are 0.36. Float32 loses about
    2 % of those entries, the block map carried from block to block then
    has eigenvalues near 5, and the stream diverges; float64 keeps the map
    to ~1e-11 and leaves only the float32 coefficients' own floor."""
    C, B = v.shape
    a = (-a1.double()).expand(B).clone()
    b = (-a2.double()).expand(B).clone()
    c = torch.ones_like(a)
    d = torch.zeros_like(a)
    ux = v.double()
    uy = torch.zeros_like(ux)
    k = 1
    while k < B:
        # right = pref[k:], left = pref[:-k]: (A2 A1, A2 u1 + u2)
        ra, rb, rc, rd = a[k:], b[k:], c[k:], d[k:]
        la, lb, lc, ld = a[:-k], b[:-k], c[:-k], d[:-k]
        lux, luy = ux[:, :-k], uy[:, :-k]
        nux = ra * lux + rb * luy + ux[:, k:]
        nuy = rc * lux + rd * luy + uy[:, k:]
        a, b, c, d = (
            torch.cat([a[:k], ra * la + rb * lc]),
            torch.cat([b[:k], ra * lb + rb * ld]),
            torch.cat([c[:k], rc * la + rd * lc]),
            torch.cat([d[:k], rc * lb + rd * ld]),
        )
        ux = torch.cat([ux[:, :k], nux], dim=1)
        uy = torch.cat([uy[:, :k], nuy], dim=1)
        k *= 2
    # y[n] = first row of (P[n] s + q[n])
    s = s.double()
    return (a * s[:, 0:1] + b * s[:, 1:2] + ux).float()


def _iir_tiles(v, s, a1, a2):
    """The recurrence as the kernels run it, in plain PyTorch: the tile
    responses of :func:`_iir_sequences`, the transposed Toeplitz matrix of
    ``g``, and :func:`_iir_tiles_ref`'s three passes."""
    Q = _TILE_Q
    g, alpha, beta = _iir_sequences(a1, a2, Q)
    i = torch.arange(Q, device=v.device)[:, None]
    j = torch.arange(Q, device=v.device)[None, :]
    TlT = torch.where(i <= j, g[(j - i).clamp(0, Q - 1)], 0.0)  # Tl^T (Q, Q)
    ab = torch.stack([alpha, beta], dim=0)  # (2, Q)
    return _iir_tiles_ref(v, s, TlT, ab, Q)


def _iir_plain(v, s, a1, a2):
    """The plain version of the kernels' recurrence: :func:`_iir_tiles` on
    a block they take (``kernels.section_gate``), :func:`_iir_assoc` on any
    other."""
    if kernels.section_gate(*v.shape):
        return _iir_tiles(v, s, a1, a2)
    return _iir_assoc(v, s, a1, a2)


def _iir_apply(v, s, a1, a2):
    """The recurrence ``y[n] = v[n] - a1 y[n-1] - a2 y[n-2]``:
    ``kernels.iir_tiles`` for a block on the card that passes
    ``kernels.section_gate``, :func:`_iir_plain` for every other."""
    if v.is_cuda and kernels.section_gate(*v.shape):
        return kernels.iir_tiles(v, s, a1, a2)
    return _iir_plain(v, s, a1, a2)


# ---------------------------------------------------------------------------
# Extended precision: the double-f32 (two-float) recurrence
#
# Error-free transforms need every product rounded before it enters a sum.
# Eager PyTorch runs each elementwise op as its own kernel, so nothing is
# contracted into an FMA behind the code's back, and ``_two_prod`` forms the
# exact product in float64 instead of by Veltkamp splitting.
# ---------------------------------------------------------------------------


def _two_sum(a, b):
    """Error-free a + b = s + e (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _fast_two_sum(a, b):
    """Error-free a + b = s + e, requiring |a| >= |b| (Dekker)."""
    s = a + b
    return s, b - (s - a)


def _two_prod(a, b):
    """Error-free a * b = p + e for float32 ``a``, ``b``: their product is
    exact in float64, ``p`` is its float32 rounding and ``e`` the
    remainder, which float32 holds exactly."""
    p64 = a.double() * b.double()
    p = p64.float()
    return p, (p64 - p.double()).float()


def _dd_add(x, y):
    """Accurate dd + dd (the QD library's 'ieee_add' shape): the sloppy
    single-renormalize variant loses its error channel under the heavy
    cancellation a resonant recurrence produces."""
    s1, s2 = _two_sum(x[0], y[0])
    t1, t2 = _two_sum(x[1], y[1])
    s1, s2 = _fast_two_sum(s1, s2 + t1)
    return _fast_two_sum(s1, s2 + t2)


def _dd_mul(x, y):
    p, e = _two_prod(x[0], y[0])
    return _fast_two_sum(p, e + (x[0] * y[1] + x[1] * y[0]))


def _dd_neg(x):
    return -x[0], -x[1]


def split_f32_pair(v) -> np.ndarray:
    """float64 array -> (2, ...) float32 [hi, lo] with hi + lo == v to
    f32-pair precision (host side)."""
    v = np.asarray(v, np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return np.stack([hi, lo])


def _dd_affine_combine(left, right):
    """Affine-map composition (right after left) in double-f32: elements
    are 6 dd pairs (a, b, c, d, ux, uy) for A = [[a, b], [c, d]],
    u = (ux, uy)."""
    la, lb, lc, ld, lux, luy = left
    ra, rb, rc, rd, rux, ruy = right
    a = _dd_add(_dd_mul(ra, la), _dd_mul(rb, lc))
    b = _dd_add(_dd_mul(ra, lb), _dd_mul(rb, ld))
    c = _dd_add(_dd_mul(rc, la), _dd_mul(rd, lc))
    d = _dd_add(_dd_mul(rc, lb), _dd_mul(rd, ld))
    ux = _dd_add(_dd_add(_dd_mul(ra, lux), _dd_mul(rb, luy)), rux)
    uy = _dd_add(_dd_add(_dd_mul(rc, lux), _dd_mul(rd, luy)), ruy)
    return a, b, c, d, ux, uy


def _dd_forcing(buf, coefs, coefs_lo):
    """v = b0 x + b1 x[-1] + b2 x[-2] over a float32 buffer (C, B+2) with
    double-f32 coefficients, accumulated error-free. Returns a dd pair."""
    x0, x1, x2 = buf[:, 2:], buf[:, 1:-1], buf[:, :-2]
    t = None
    for i, xk in enumerate((x0, x1, x2)):
        p, e = _two_prod(coefs[i], xk)
        term = _fast_two_sum(p, e + coefs_lo[i] * xk)
        t = term if t is None else _dd_add(t, term)
    return t


def _dd_prefix_scan(elems):
    """Inclusive prefix of :func:`_dd_affine_combine` over axis 1 by prefix
    doubling (:func:`pipe_tpu_torch.ops.prims.prefix_scan`)."""
    return prefix_scan(_dd_affine_combine, elems)


def _iir_scan_dd(v_dd, a1_dd, a2_dd):
    """Inclusive prefix of the companion-affine elements of
    ``y[n] = v[n] - a1 y[n-1] - a2 y[n-2]`` in double-f32, over axis 1:
    ``y[n] = a[n] s_x + b[n] s_y + ux[n]`` for the entering state
    s = (y[-1], y[-2])."""
    vh, vl = v_dd
    shape = vh.shape

    def bc(t):
        return t[0].expand(shape), t[1].expand(shape)

    zero = torch.zeros(shape, dtype=torch.float32, device=vh.device)
    unit = torch.ones(shape, dtype=torch.float32, device=vh.device)
    elems = (bc(_dd_neg(a1_dd)), bc(_dd_neg(a2_dd)), (unit, zero),
             (zero, zero), (vh, vl), (zero, zero))
    return _dd_prefix_scan(elems)


def _dd_apply_boundary(prefix, s_dd):
    """y[n] = a[n] s_x + b[n] s_y + ux[n] in dd; ``s_dd`` is the
    ((C, 2) hi, (C, 2) lo) state pair."""
    a, b, _, _, ux, _ = prefix
    sx = (s_dd[0][:, 0:1], s_dd[1][:, 0:1])
    sy = (s_dd[0][:, 1:2], s_dd[1][:, 1:2])
    return _dd_add(_dd_add(_dd_mul(a, sx), _dd_mul(b, sy)), ux)


def _iir_apply_dd(v_dd, s_dd, a1_dd, a2_dd):
    """Double-f32 pole recurrence over a block: the dd output pair
    ((C, B) hi, lo)."""
    return _dd_apply_boundary(_iir_scan_dd(v_dd, a1_dd, a2_dd), s_dd)


def _iir_refine(v, s, y, a1, a2):
    """One step of iterative refinement on the pole recurrence: compute the
    defect ``r[n] = v[n] - (y[n] + a1 y[n-1] + a2 y[n-2])`` and add the
    filtered defect back (the defect is ~2^-24 of the signal, so the
    correction pass runs in clean f32).

    The defect is formed in float64, where the products of float32 values
    are exact, and rounded once to float32. XLA fuses this expression into
    FMAs (exact products too); eager PyTorch would round each product, and
    those roundings are as large as the defect itself (~2 dB lost)."""
    yp = torch.cat([s.flip(1), y], dim=1).double()  # [y[-2], y[-1], y...]
    r = v.double() - (y.double() + a1.double() * yp[:, 1:-1]
                      + a2.double() * yp[:, :-2])
    return y + _iir_plain(r.float(), torch.zeros_like(s), a1, a2)


def _biquad_section_ref(state, x, frames: int, coefs, refine: bool = True):
    """One block through one biquad section as eager ops: the plain version
    of ``kernels.biquad_section``. Same contract as
    :func:`biquad_section_block`. The recurrence runs as
    :func:`_iir_plain`, never on the kernel."""
    b0, b1, b2 = coefs[0], coefs[1], coefs[2]
    a1, a2 = coefs[4], coefs[5]
    xm = zero_past(x, frames)

    # FIR part v[n] = b0 x[n] + b1 x[n-1] + b2 x[n-2] with carried tail
    buf = torch.cat([state["x_tail"], xm], dim=1)  # (C, B+2)
    v = b0 * buf[:, 2:] + b1 * buf[:, 1:-1] + b2 * buf[:, :-2]

    s_init = state["s"]
    y = _iir_plain(v, s_init, a1, a2)
    if refine:
        y = _iir_refine(v, s_init, y, a1, a2)

    # state after the last VALID frame: y_hist[k] = y[k-2], so it is
    # (y_hist[frames+1], y_hist[frames]); frames=0 keeps the carried state
    y_hist = torch.cat([s_init[:, 1:2], s_init[:, 0:1], y], dim=1)
    new_s = y_hist[:, frames: frames + 2].flip(1)
    new_x_tail = buf[:, frames: frames + 2].contiguous()
    return {"x_tail": new_x_tail, "s": new_s}, y


def biquad_section_block(state, x, frames: int, coefs, refine: bool = True):
    """One block through one biquad section.

    ``state``: dict with ``x_tail`` (C, 2) and ``s`` (C, 2) =
    (y[n-1], y[n-2]); ``x``: (C, B) valid to ``frames``; ``coefs``: (6,)
    [b0, b1, b2, 1, a1, a2]. Returns ``(new_state, y)``.

    A block on the card whose channel count is a multiple of 8
    (``kernels.section_gate``, any number of frames) is one call of the
    CUDA kernels (or raises: there is no fallback); every other block runs
    :func:`_biquad_section_ref`.
    """
    if x.is_cuda and kernels.section_gate(*x.shape):
        y, new_x_tail, new_s = kernels.biquad_section(
            x.contiguous(), frames, state["x_tail"].contiguous(),
            state["s"].contiguous(), coefs.contiguous(), refine)
        return {"x_tail": new_x_tail, "s": new_s}, y
    return _biquad_section_ref(state, x, frames, coefs, refine)


def biquad_section_block_extended(state, x, frames: int, coefs, coefs_lo):
    """One block through one section in double-f32 precision.

    Same contract as :func:`biquad_section_block` plus ``coefs_lo`` (the
    low float32 planes of the float64 coefficients, :func:`split_f32_pair`)
    and an ``s_lo`` state entry. The forcing, the pole recurrence and the
    carried state stay unevaluated float32 pairs; only the block output is
    rounded once. Signals between sections and blocks stay single float32.
    """
    a1 = (coefs[4], coefs_lo[4])
    a2 = (coefs[5], coefs_lo[5])
    xm = zero_past(x, frames)
    buf = torch.cat([state["x_tail"], xm], dim=1)
    v = _dd_forcing(buf, coefs, coefs_lo)
    yh, yl = _iir_apply_dd(v, (state["s"], state["s_lo"]), a1, a2)
    s, s_lo = state["s"], state["s_lo"]
    y_hist_h = torch.cat([s[:, 1:2], s[:, 0:1], yh], dim=1)
    y_hist_l = torch.cat([s_lo[:, 1:2], s_lo[:, 0:1], yl], dim=1)
    new_state = {
        "x_tail": dynamic_slice(buf, frames, 2),
        "s": dynamic_slice(y_hist_h, frames, 2).flip(1),
        "s_lo": dynamic_slice(y_hist_l, frames, 2).flip(1),
    }
    return new_state, yh


def biquad_block(state, x, frames: int, sections, refine: bool = True,
                 sections_lo=None):
    """Cascade of biquad sections. ``sections``: (S, 6) SOS matrix (scipy
    layout, a0 == 1). ``state``: list of per-section dicts. Passing
    ``sections_lo`` (the low float32 planes) selects the double-f32
    extended path for every section."""
    new_states = []
    y = x
    for i in range(sections.shape[0]):
        if sections_lo is None:
            st, y = biquad_section_block(state[i], y, frames, sections[i],
                                         refine=refine)
        else:
            st, y = biquad_section_block_extended(
                state[i], y, frames, sections[i], sections_lo[i])
        new_states.append(st)
    return new_states, y


def biquad_init_state(channels: int, n_sections: int, device=None,
                      extended: bool = False):
    def z2():
        return torch.zeros((channels, 2), dtype=torch.float32, device=device)

    return [{"x_tail": z2(), "s": z2(), **({"s_lo": z2()} if extended else {})}
            for _ in range(n_sections)]


class Biquad:
    """Biquad cascade processor from an SOS matrix (scipy ``sosfilt``
    layout: rows [b0 b1 b2 a0 a1 a2], a0 normalized to 1). Coefficients are
    a live parameter (section count fixed).

    ``precision='extended'`` runs the cascade in double-f32 (see the module
    docstring): near-DC or high-Q sections whose float32 floor sits below
    100 dB reach the float32 output-rounding floor instead, at many times
    the cost of the default path."""

    def __init__(self, sos, refine: bool = True, precision: str | None = None):
        if precision not in (None, "extended"):
            raise ValueError("precision must be None or 'extended'")
        self._extended = precision == "extended"
        self._sos64 = self._normalize(sos)
        self._sos, self._sos_lo = self._split(self._sos64)
        self._refine = bool(refine)
        self._component = None
        self._delegate = None  # set by pipe_tpu_torch.optimize.fuse
        self.context = None

    @staticmethod
    def _normalize(sos) -> np.ndarray:
        sos = np.asarray(sos, np.float64)
        if sos.ndim == 1:
            sos = sos[None, :]
        if sos.shape[-1] != 6:
            raise ValueError("sos rows must be [b0 b1 b2 a0 a1 a2]")
        return sos / sos[:, 3:4]

    @staticmethod
    def _split(sos64):
        """float64 SOS -> float32 (hi, lo) tensors with hi + lo == sos to
        f32-pair precision. The default path filters with hi; the extended
        path reads lo too."""
        hi, lo = split_f32_pair(sos64)
        return param_tensor(hi), param_tensor(lo)

    def processor(self):
        def alloc(mctx, block_size, props):
            self.context = mctx
            refine, extended = self._refine, self._extended

            def step(state, params, sig: Signal):
                new_state, y = biquad_block(
                    state, sig.data, sig.frames, params["sos"], refine=refine,
                    sections_lo=params["sos_lo"] if extended else None,
                )
                return new_state, sig.with_data(y)

            self._component = Processor(
                output=props,
                step=step,
                state=biquad_init_state(props.channels, self.n_sections,
                                        props.device, extended=extended),
                params={"sos": self._sos.to(props.device),
                        "sos_lo": self._sos_lo.to(props.device)},
            )
            return self._component

        alloc.fusion_tag = ("biquad", self)
        return alloc

    @property
    def n_sections(self) -> int:
        return int(self._sos.shape[0])

    def set_sos(self, sos):
        if self._delegate is not None:  # cascaded away by optimize.fuse
            return self._delegate.set_part_sos(self, sos)
        hi, lo = self._split(self._normalize(sos))

        def fn():
            dev = self._component.get_param("sos").device
            self._component.set_param("sos", hi.to(dev))
            self._component.set_param("sos_lo", lo.to(dev))

        return self.context.mutate(fn)


def _rbj_row(b0, b1, b2, a0, a1, a2) -> np.ndarray:
    return np.array([b0 / a0, b1 / a0, b2 / a0, 1.0, a1 / a0, a2 / a0])


def _rbj_wa(sample_rate: float, freq: float, q: float):
    w0 = 2.0 * np.pi * freq / sample_rate
    return w0, np.sin(w0) / (2.0 * q)


def design_peaking_eq(
    sample_rate: float, freq: float, q: float, gain_db: float
) -> np.ndarray:
    """RBJ cookbook peaking EQ, one SOS row, float64 host-side."""
    A = 10.0 ** (gain_db / 40.0)
    w0, alpha = _rbj_wa(sample_rate, freq, q)
    return _rbj_row(
        1 + alpha * A, -2 * np.cos(w0), 1 - alpha * A,
        1 + alpha / A, -2 * np.cos(w0), 1 - alpha / A,
    )


def design_lowpass_biquad(
    sample_rate: float, freq: float, q: float = 0.7071
) -> np.ndarray:
    """RBJ 2nd-order lowpass, one SOS row."""
    w0, alpha = _rbj_wa(sample_rate, freq, q)
    c = np.cos(w0)
    return _rbj_row(
        (1 - c) / 2, 1 - c, (1 - c) / 2, 1 + alpha, -2 * c, 1 - alpha
    )


def design_highpass_biquad(
    sample_rate: float, freq: float, q: float = 0.7071
) -> np.ndarray:
    """RBJ 2nd-order highpass, one SOS row."""
    w0, alpha = _rbj_wa(sample_rate, freq, q)
    c = np.cos(w0)
    return _rbj_row(
        (1 + c) / 2, -(1 + c), (1 + c) / 2, 1 + alpha, -2 * c, 1 - alpha
    )


def design_bandpass(sample_rate: float, freq: float, q: float) -> np.ndarray:
    """RBJ constant-0dB-peak bandpass, one SOS row."""
    w0, alpha = _rbj_wa(sample_rate, freq, q)
    return _rbj_row(
        alpha, 0.0, -alpha, 1 + alpha, -2 * np.cos(w0), 1 - alpha
    )


def design_notch(sample_rate: float, freq: float, q: float) -> np.ndarray:
    """RBJ notch, one SOS row."""
    w0, alpha = _rbj_wa(sample_rate, freq, q)
    c = np.cos(w0)
    return _rbj_row(1.0, -2 * c, 1.0, 1 + alpha, -2 * c, 1 - alpha)


def design_allpass(sample_rate: float, freq: float, q: float) -> np.ndarray:
    """RBJ allpass (unit magnitude, phase rotation), one SOS row."""
    w0, alpha = _rbj_wa(sample_rate, freq, q)
    c = np.cos(w0)
    return _rbj_row(
        1 - alpha, -2 * c, 1 + alpha, 1 + alpha, -2 * c, 1 - alpha
    )


def _design_shelf(
    sample_rate: float, freq: float, gain_db: float, slope: float, low: bool
) -> np.ndarray:
    A = 10.0 ** (gain_db / 40.0)
    w0 = 2.0 * np.pi * freq / sample_rate
    c = np.cos(w0)
    alpha = (
        np.sin(w0) / 2.0
        * np.sqrt((A + 1.0 / A) * (1.0 / slope - 1.0) + 2.0)
    )
    s2a = 2.0 * np.sqrt(A) * alpha
    p, m = A + 1, A - 1
    if low:
        return _rbj_row(
            A * ((p) - m * c + s2a), 2 * A * (m - p * c),
            A * (p - m * c - s2a),
            p + m * c + s2a, -2 * (m + p * c), p + m * c - s2a,
        )
    return _rbj_row(
        A * (p + m * c + s2a), -2 * A * (m + p * c),
        A * (p + m * c - s2a),
        p - m * c + s2a, 2 * (m - p * c), p - m * c - s2a,
    )


def design_lowshelf(
    sample_rate: float, freq: float, gain_db: float, slope: float = 1.0
) -> np.ndarray:
    """RBJ low shelf, one SOS row (``slope=1`` is the steepest monotonic
    shelf)."""
    return _design_shelf(sample_rate, freq, gain_db, slope, low=True)


def design_highshelf(
    sample_rate: float, freq: float, gain_db: float, slope: float = 1.0
) -> np.ndarray:
    """RBJ high shelf, one SOS row."""
    return _design_shelf(sample_rate, freq, gain_db, slope, low=False)

"""Uniformly-partitioned overlap-save FFT convolution (BASELINE config 4:
the 64k-tap convolution reverb).

The PyTorch counterpart of :mod:`pipe_tpu.ops.ols`, with the same state.
For an impulse response of P taps and block size B, the IR is split into
``K = ceil(P/B)`` partitions of B taps. Per block the engine does one rfft
of the 2B input window, writes its spectrum into a frequency-domain delay
line (FDL) ring, multiply-accumulates the ring against the partition
spectra and does one irfft: O(B log B + P) per block.

The FDL ring and the partition spectra are stored as float32 re/im planes
(``fdl`` (2, K, C, B+1), ``ir_spec`` (2, K, bins) or (2, K, C, bins)), the
JAX package's layout, so state and params cross packages. The planar
split was the TPU's workaround for complex arithmetic; here the FFTs run
on complex64 (cuFFT on the card, which has no TF32) and the MAC is an
elementwise complex product summed over the partitions, IEEE FP32: no
matrix product, so nothing here consults the precision knob of
:mod:`pipe_tpu_torch.config` (the JAX package's MAC is an einsum that
does).

The ring head ``pos`` is a host int (a stream counter, :mod:`convert`),
so the ring write and the roll of the reversed spectra index with host
ints: nothing is read back from the card per block.
"""

from __future__ import annotations

import numpy as np
import torch

from pipe_tpu_torch.components import Processor
from pipe_tpu_torch.ops.prims import dynamic_slice
from pipe_tpu_torch.signal import Signal, zero_past


def partition_ir(ir, block_size: int) -> np.ndarray:
    """Split and transform an IR into partition spectra planes, float64 on
    the host then rounded to float32.

    ``ir``: (P,) shared or (C, P) per-channel. Returns (2, n_parts, bins)
    or (2, n_parts, C, bins): re/im planes of the rfft of the 2B-padded
    partitions, ``bins = B + 1``.
    """
    ir = np.asarray(ir, np.float64)
    shared = ir.ndim == 1
    if shared:
        ir = ir[None, :]
    C, P = ir.shape
    B = block_size
    n_parts = -(-P // B)
    padded = np.zeros((C, n_parts * B), np.float64)
    padded[:, :P] = ir
    parts = padded.reshape(C, n_parts, B).transpose(1, 0, 2)  # (n_parts, C, B)
    spec = np.fft.rfft(
        np.concatenate([parts, np.zeros_like(parts)], axis=-1), axis=-1)
    planes = np.stack([spec.real, spec.imag]).astype(np.float32)
    if shared:
        return planes[:, :, 0, :]
    return planes


def ols_init_state(channels: int, block_size: int, n_parts: int,
                   device=None):
    """Zero state: the previous input block, the FDL ring (re/im planes) and
    the ring head (the slot of the next write, a host int)."""
    bins = block_size + 1
    return {
        "prev": torch.zeros((channels, block_size), dtype=torch.float32,
                            device=device),
        "fdl": torch.zeros((2, n_parts, channels, bins), dtype=torch.float32,
                           device=device),
        "pos": 0,
    }


def ols_block(state, x, frames: int, ir_spec):
    """One UPOLS block.

    Block t's spectrum goes to ring slot ``t mod K``; the MAC aligns the
    IR instead of shifting the ring: ``acc = sum_q fdl[q] * H_rot[q]`` with
    ``H_rot[q] = H[(pos - q) mod K]``, the reversed partition spectra
    rolled by ``pos + 1``.

    ``state``: ``prev`` (C, B), ``fdl`` (2, K, C, bins), ``pos`` (int);
    ``x``: (C, B) valid to ``frames``; ``ir_spec``: (2, K, bins) shared or
    (2, K, C, bins) per-channel planes. Returns ``(new_state, y)``, y (C, B).
    The new ``fdl`` is a copy with one slot rewritten, so the old state
    stays intact.
    """
    C, B = x.shape
    K = state["fdl"].shape[1]
    xm = zero_past(x, frames)
    buf = torch.cat([state["prev"], xm], dim=1)  # (C, 2B)
    X = torch.fft.rfft(buf, dim=-1)  # (C, bins) complex64
    s = state["pos"]
    fdl = state["fdl"].clone()
    fdl[0, s] = X.real
    fdl[1, s] = X.imag
    h_rot = torch.roll(torch.flip(ir_spec, (1,)), s + 1, dims=1)
    F = torch.complex(fdl[0], fdl[1])  # (K, C, bins)
    H = torch.complex(h_rot[0], h_rot[1])  # (K, bins) or (K, C, bins)
    if H.ndim == 2:
        H = H[:, None, :]
    acc = (F * H).sum(dim=0)  # (C, bins)
    y = torch.fft.irfft(acc, n=2 * B, dim=-1)[:, B:]  # keep the tail half
    # `prev` holds the last B samples of the valid stream: a mid-stream
    # partial block shifts it by `frames`, like the FIR tail
    prev = dynamic_slice(buf, frames, B)
    return {"prev": prev, "fdl": fdl, "pos": (s + 1) % K}, y.contiguous()


def _spec_tensor(ir, block_size: int, channels: int, device):
    spec = torch.from_numpy(partition_ir(ir, block_size)).to(device)
    if spec.ndim == 4 and spec.shape[2] != channels:
        raise ValueError(
            f"per-channel IR for {spec.shape[2]} channels, "
            f"line has {channels}"
        )
    return spec


class OLSConvolve:
    """Partitioned overlap-save convolution processor. ``ir`` may be (P,)
    shared or (C, P) per-channel. The partition spectra are a live
    parameter, so the IR can be swapped mid-stream (same P)."""

    def __init__(self, ir):
        self._ir = np.asarray(ir)
        self._component = None
        self._delegate = None  # set by pipe_tpu_torch.optimize.fuse
        self.context = None

    def processor(self):
        def alloc(mctx, block_size, props):
            self.context = mctx
            spec = _spec_tensor(self._ir, block_size, props.channels,
                                props.device)

            def step(state, params, sig: Signal):
                new_state, y = ols_block(state, sig.data, sig.frames,
                                         params["ir_spec"])
                return new_state, sig.with_data(y)

            self._component = Processor(
                output=props,
                step=step,
                state=ols_init_state(props.channels, block_size,
                                     spec.shape[1], props.device),
                params={"ir_spec": spec},
            )
            return self._component

        alloc.fusion_tag = ("ols", self)
        return alloc

    def set_ir(self, ir):
        """Swap the impulse response mid-stream (same length)."""
        if self._delegate is not None:  # fused away by optimize.fuse
            return self._delegate.set_ir(ir)
        ir = np.asarray(ir)

        def fn():
            block_size = self._component.state["prev"].shape[1]
            self._component.replace_param("ir_spec",
                                          partition_ir(ir, block_size))

        return self.context.mutate(fn)

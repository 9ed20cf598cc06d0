"""Smoke test of the PyTorch port (``pipe_tpu_torch``) on one CUDA card.

Run from anywhere with ``python3 chip_smoke.py``; it imports the package
that sits beside this file and builds its CUDA kernels from
``pipe_tpu_torch/csrc`` into ``build/``. It drives the port's main path on
the card (``cuda:0``), in phases, each printing one line:

1. a CUDA card is present (no card: the script fails, it never runs on
   the CPU instead);
2. the card's name and power limit, as ``nvidia-smi`` prints them;
3. IEEE FP32 is pinned for cuBLAS and cuDNN, and a float32 convolution on
   the card agrees with float64;
4. the CUDA kernels build (seconds printed);
5. both entry points of the biquad kernels against their plain PyTorch
   versions at (8, 4096), (16, 8192) (config 4's and the optimizer's
   blocks) and (64, 10240), both EQ sections: ``iir_tiles`` (the
   recurrence) >= 110 dB against the plain version and >= 90 dB against a
   float64 recurrence; ``biquad_section`` (a whole section in one call)
   >= 110 dB against the eager section and >= 90 dB against float64, with
   and without the refinement pass, for blocks valid to B, 6824 (config
   4's last block; B - 1 where B is smaller), 1 and 0 frames, the new
   ``x_tail`` exactly, the new ``s`` exactly the kernel's own last two
   valid outputs and >= 110 dB from the plain version's (the output's own
   bar: the state is two samples a channel of it, so its SNR scatters
   more than the whole block's); both timed with CUDA events, back to
   back and as a replayed CUDA graph (device time alone), beside their
   bound. ``iir_tiles`` alone is held and timed the same way at the local
   blocks that the sharded chain of phases 15 and 16 gives it: (64,
   327680), (32, 20480) and (64, 40960). Then the recurrence streamed: 43
   blocks of (64, 10240) through ``_iir_apply`` with the state carried,
   >= 90 dB against a float64 ``lfilter``, one ``iir_tiles`` launch a
   block;
6. ``make_flagship(64, 147*64)``, fused and unfused, four chained chunks:
   >= 100 dB against the same chunks run by the port on the CPU, and
   >= 100 dB between fused and unfused;
7. the slice: ``run(9408, Line(host feed of 64 channels x 10 s at 44.1
   kHz -> FIR(255) -> Resampler(48000, 44100) -> Biquad EQ -> 64->2 mix
   -> host receive))`` on the card: exactly (2, 480000) frames out, >= 100 dB
   against the same line run on the CPU and >= 100 dB against a float64
   scipy oracle of the chain, ``biquad_section`` launched 2 times per
   block (once a section), samples/s printed, and a profile of 10 blocks
   (device time by kernel group, launches per block, the device's idle
   share). The run is given no ``device``: the port's default, the card,
   is what is driven;
8. the slice through the async ``Pipe`` on the card (``lookahead=4``), with
   live surgery while it streams: an EQ retune pushed for block 12, a
   low-shelf ``Biquad`` inserted before the mix at block 24, and a second
   line (mock source -> resampler -> EQ -> mock sink) added live on its
   own executor thread. Checks: line A's output is exactly (2, 480000),
   >= 100 dB against the same scenario run by the port on the CPU, >= 120
   dB against the card at ``lookahead=1``; the first sample that differs
   from a run without the retune is 12 * 10240; the ``biquad_section``
   launches per executor thread are exact (line A 2 per block, 3 after the
   insert; line B 2 per block); both surgery handles complete without
   error. Samples/s of the plain slice through ``Pipe`` at lookahead 1 and
   4 and at ``batch_blocks=4``;
9. dispatch cost of the streaming runtime on the card (BASELINE configs 1
   and 2): a mono 512-frame mock source -> gain -> mock sink, microseconds
   per block at ``batch_blocks`` 1 and 32; a stereo gain + mix under 50
   live pushes, blocks per second;
10. BASELINE config 4 at full width: ``run(8192, Line(host feed of 16
    channels x 10 s at 44.1 kHz -> OLSConvolve(65,536-tap IR) -> peaking
    EQ -> host receive))`` on the card: exactly (16, 441000) frames out,
    >= 90 dB against a float64 scipy oracle (fftconvolve, sosfilt) and
    against the same line run by the port on the CPU, ``biquad_section``
    launched once per block; samples/s, the device time of one
    ``ols_block`` at (16, 8192) and of both kernel entry points there
    (CUDA events; each >= 110 dB against its plain version on the same
    peaking section), and a profile of the run's device time (FFT, biquad
    kernels, other), launches per block and the device's idle share, in
    which neither the eager section nor a float64 kernel may appear;
11. the optimizer at full width: the same feed through ``Gain(0.5) -> OLS
    -> peaking -> high shelf`` in ``Pipe(8192, lookahead=4)`` with
    ``optimize=True`` and ``False``: the fused line is ``OLSWithGain ->
    BiquadCascade``; the two pipes' outputs are identical (or >= 120 dB
    apart) without retunes and with an EQ retune; the EQ retune through the
    original ``Biquad`` at block 20 first changes output sample 20 * 8192,
    a ``set_gain(0.25)`` through the original ``Gain`` at block 30 first
    changes sample 30 * 8192, in both pipes; 2 ``biquad_section`` launches
    per block on the executor thread of every run;
12. the rest of the op kit, each op on the card against the port on the
    CPU at >= 100 dB (dB and times printed): ``Delay`` (ring and in-block
    scan regimes, with feedback), ``Compressor`` (50 ms attack),
    ``NoiseGate``, ``SpectralGain``/``SpectralGate`` (W 1024, H 256), a
    16-bin ``Channelizer``, the AM and FM demod chains, and
    ``Biquad(precision='extended')`` on a 20 Hz kappa-floor section (also
    against float64, and timed against the default path);
13. WAV files on the card: phase 10's feed written with the native
    ``WavWriter`` to a temporary directory, ``WavSource -> OLS + peaking EQ
    -> WavSink`` through ``run`` at block 8192 with no ``device``; the file
    read back equals phase 10's output bit for bit; the native library is
    required (``native.available()``); samples/s printed;
14. the precision table: FIR(255), the resampler and a seeded random 64->2
    mix at (64, 9408) and the slice as a whole, dB against float64 and ms (CUDA events
    for the ops, synchronized wall for the slice) under ``'highest'``,
    ``'high'`` (3xTF32) and ``'default'``; ``'high'`` must read >= 100 dB on
    the slice; and the biquad's bits do not move with the knob on the
    kernel path and in a sharded ``BiquadStage`` (phase 3 holds the plain
    versions to the same);
15. the sharded main path on one rank at full width: a 1x1 mesh (no process
    group), 64 channels, ``FIRStage(255) -> ResampleStage(48000, 44100, 32)
    -> BiquadStage(peaking 1 kHz) -> BiquadStage(high shelf 8 kHz) ->
    MixStage(64->2)`` at chunks of 147*2048 frames, 4 chunks: >= 100 dB
    against the float64 oracle of phase 7 and against the streaming slice
    of phase 7 fed the same samples; ``iir_tiles`` launched exactly 2 passes
    x 2 sections x 4 chunks = 16 times; samples/s printed;
16. four ranks: the same chain at chunks of 4*9408 frames on a 1x4 and a 2x2
    mesh in four spawned processes, on four cards over NCCL where the
    machine has them, else all on the one card over gloo with the host
    transport (printed); every rank's ``iir_tiles`` launches exactly 16 a
    mesh; the gathered output >= 100 dB against the 1x1 chain's for the same
    input and identical on all ranks; the carries after the last chunk
    equal on the ranks of one channel row; samples/s printed (on one card
    this measures the transport). Then, in the same ranks and on both
    meshes: phase 17's chain (BASELINE config 4) at chunks of 4*8192 frames
    (a local block of (16, 8192) on 1x4, (8, 16384) on 2x2): output >= 100 dB
    against a 1x1 chain at chunks of 8192, ``iir_tiles`` exactly 2 a chunk
    and rank, exactly 2 ``all_to_all`` a chunk and rank for the OLS stage
    (from ``ShardedChain.last_comm`` and ``Mesh.stats``), the biquad's
    carries equal inside a channel row, and the 1x4 mesh's bin-sharded
    delay line, gathered, >= 100 dB against the 1x1 chain's; and phase 18's
    two chains, each >= 100 dB against the port's streaming ops on the CPU,
    with the delay in its wave-DAG regime (its shifts a chunk printed);
17. BASELINE config 4 at full width through the sharded chain:
    ``ShardedChain([OLSStage(65,536-tap IR), BiquadStage(peaking EQ)])`` on a
    1x1 mesh, 16 channels, phase 10's feed (zero-padded to 54 chunks of
    8192): the partitioned regime (``P > n_local``, K = 8 partitions, the
    frequency-domain delay line), >= 100 dB against phase 10's output and
    >= 90 dB against its float64 oracle; ``iir_tiles`` launched exactly 2 a
    chunk (one section, two passes), ``biquad_section`` never; no collective
    on one rank; samples/s and a profile of 10 chunks printed;
18. the rest of the sharded stages on a 1x1 mesh on the card, against the
    port's streaming ops on the CPU at >= 100 dB: ``CompressorStage ->
    DelayStage(20000, feedback 0.5) -> SpectralGateStage(1024, 256)`` on 8
    channels at chunks of 32768 (on one rank the delay is in its ladder
    regime, on four ranks in the wave-DAG), and an FM signal through
    ``IQMixStage -> FIRStage(127) -> FMDiscriminatorStage ->
    ChannelizerStage(16)`` on 2 channels at chunks of 8192;
19. BASELINE config 5 through ``Pipe(mesh=)`` on a 1x1 mesh at full width:
    phase 15's chain built from ``parallel.sharded`` ops as a ``Line``,
    host-fed phase 15's samples in blocks of 301,056 frames, 4 blocks. The
    output equals phase 15's ``ShardedChain`` output bit for bit (also
    when the feed returns random packet sizes); ``iir_tiles`` launched
    exactly 2 x 2 x 4 = 16 times and ``biquad_section`` never; a
    ``Biquad.set_sos`` pushed ``at_block=2`` first changes output sample
    2 x 327,680 exactly; with ``optimize=True`` (3 stages instead of 5)
    the output is >= 110 dB from the plain run's (the fused FIR+resample
    bank sums in another order); >= 100 dB against phase
    15's float64 oracle; samples/s beside phase 15's, launches a block and
    the device's idle share printed. Then live surgery on that pipe: a
    ``sharded.Biquad`` (peaking, 2.5 kHz) inserted before the mix
    ``at_block=2`` first changes sample 2 x 327,680 exactly, ``iir_tiles``
    is launched 16 + 2 x 2 times, and the output is >= 100 dB against the
    ``Pipe`` without a mesh (the streaming ops) doing the same insert at the
    same block; the same insert with no ``at_block``, pushed once two blocks
    went out, lands on a block boundary (block 2 or 3) with ``iir_tiles``
    16 + 2 for each block after it; a second line (8 channels, resampler
    and one EQ section) added ``at_block=2`` into the sync group equals that
    line run alone, bit for bit;
20. in phase 16's four ranks (``--four-ranks`` too), on 1x4 and 2x2, the
    main path through ``Pipe(mesh=)`` in 4 blocks of 37,632 frames at 64
    channels, with the health rounds of ``pipe_tpu_torch.parallel.hostsync``:
    (a) ``host_sync_every=1``: the sink equals phase 16's bit for bit,
    exactly the rounds that the protocol predicts (one a dispatch and one
    after the no-op sweep that pads the stream's end), ``iir_tiles`` 4 a
    sweep (20 a rank: the 4 blocks and the no-op sweep, which computes as a
    block does), the rounds' host time in us a round (the wait for the
    slowest rank included) and the exchange's alone (200 back to back), and
    the rate beside phase 16's pipe (one round at the end); (b) a
    ``set_sos`` pushed with no ``at_block`` on every rank before the feed
    opens lands on block 2 everywhere, bit for bit the targeted push's
    output; (d) a ``sharded.Biquad`` inserted ``at_block=2`` on every rank:
    first change at sample 81,920, the ranks equal, ``iir_tiles`` 26 a
    rank (20 + 2 for each of the 3 sweeps from block 2), >= 100 dB against a 1x1 ``Pipe(mesh=)`` with the same insert that
    the parent process runs on the same input; (e) a ``sharded.Resample``
    inserted at the head, whose new width breaks the downstream resampler's
    shape rule: the handle fails with a ``ValueError`` naming the shape
    rule and the output equals the plain run's; (c) rank 2's sink raises at
    block 2: every rank's ``wait()`` raises within 15 s with the group
    timeout left at 60 s, rank 2 with its own error, the others with a
    ``RunError`` from ``PeerAbortError``.

Phase 16 also runs, in the same ranks and on both meshes, the same two
``Line``s through ``Pipe(mesh=)``: the main path in blocks of 37,632 frames
(plain, and with the ``set_sos`` pushed ``at_block=2`` on every rank) and
config 4 as ``sharded.OLS -> sharded.Biquad`` in blocks of 32,768, each
with one health round, at the end of the stream. On every rank the sink's
output equals the four-rank chain's gathered output bit for bit and is
identical across ranks; each sweep, the blocks' and the one no-op sweep
that pads the stream to its round, launches ``iir_tiles`` as often as the
chain does a chunk (4 and 2 a rank: 20 and 30 a run) and makes the chain's
data collectives of one chunk, by name in calls and bytes (its stages' plus
the gather of the output); the round is counted apart.

``python3 chip_smoke.py --four-ranks`` runs phases 16 and 20 alone (after
phases 1, 2 and the build), for a machine with four cards, where they take
NCCL.

Then one JSON line with each kernel entry point's launches on each path,
error, times and bound, and last ``{"ok": true, "device": {...}}``. Any
failure raises (an
executor thread's failure reaches ``Pipe.wait``), so the exit code is
non-zero and no result line is printed.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

SR_IN, SR_OUT = 44100, 48000
CHANNELS = 64
BLOCK = 147 * 64  # 9408 input frames -> 10240 = 40 * 256 resampled frames
SECONDS = 10
C4, B4 = 16, 8192  # BASELINE config 4: 16 channels, 8192-frame blocks
# every shape the streaming paths give either kernel; the last one is the
# slice's (the sharded chain's shapes, for ``iir_tiles`` alone, are
# SHARDED_SHAPES below)
KERNEL_SHAPES = ((8, 4096), (C4, B4), (CHANNELS, 10240))
N4 = SR_IN * SECONDS
EQ_AT, GAIN_AT = 20, 30  # phase 11's retune blocks
# the card's peaks for the kernels' bounds (NVIDIA's H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def say(phase, msg: str) -> None:
    print(f"[phase {phase}] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def import_port():
    """Import the package beside this script (never an installed copy)."""
    sys.path.insert(0, str(HERE))
    import pipe_tpu_torch

    where = Path(pipe_tpu_torch.__file__).resolve()
    require(HERE in where.parents, f"pipe_tpu_torch imported from {where}")
    return pipe_tpu_torch


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` back-to-back calls,
    by CUDA events, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int = 20, replays: int = 20) -> float:
    """Device time of one ``fn()`` in ms with no host in the way: ``calls``
    calls captured into a CUDA graph on a side stream, replayed."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, iters=replays) / calls


def bound_ms(n_bytes: int, flops: int) -> tuple:
    """The least time the card could take, in ms, and what sets it: the
    bytes over the memory rate or the operations over the FP32 rate."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def eq_sos(peak_db: float = 3.0):
    """The slice's EQ: a peaking section at 1 kHz and a high shelf at 8 kHz."""
    from pipe_tpu_torch import ops

    return np.stack([ops.design_peaking_eq(SR_OUT, 1000, 1.0, peak_db),
                     ops.design_highshelf(SR_OUT, 8000, -2.0)])


def recurrence_f64(v, s, a1, a2):
    """y[n] = v[n] - a1 y[n-1] - a2 y[n-2] in float64, from s = (y[-1], y[-2])."""
    v = np.asarray(v, np.float64)
    y = np.empty_like(v)
    y1, y2 = s[:, 0].astype(np.float64), s[:, 1].astype(np.float64)
    for n in range(v.shape[1]):
        yn = v[:, n] - a1 * y1 - a2 * y2
        y[:, n] = yn
        y1, y2 = yn, y1
    return y


def check_kernel(dev, shape, seed: int) -> dict:
    """``iir_tiles`` against its plain version and float64, for both EQ
    sections' poles; times both at section 0. Its bound: v read and y
    written once (plus the state and two coefficients), 4 operations a
    sample."""
    import torch

    from pipe_tpu_torch import kernels
    from pipe_tpu_torch.ops.biquad import _iir_apply
    from pipe_tpu_torch.signal import snr_db

    rng = np.random.default_rng(seed)
    sos = eq_sos().astype(np.float32)
    C, B = shape
    v = torch.tensor(rng.standard_normal((C, B)), dtype=torch.float32, device=dev)
    s = torch.tensor(rng.standard_normal((C, 2)), dtype=torch.float32, device=dev)
    res = {"shape": list(shape), "snr_plain_db": [], "snr_f64_db": [],
           "max_abs_err": 0.0}
    for row in sos:
        a1 = torch.tensor(row[4], device=dev)
        a2 = torch.tensor(row[5], device=dev)
        y_k = kernels.iir_tiles(v, s, a1, a2)
        y_p = _iir_apply(v, s, a1, a2, force="tiles")
        torch.cuda.synchronize()
        yk, yp = y_k.cpu().numpy(), y_p.cpu().numpy()
        ref = recurrence_f64(v.cpu().numpy(), s.cpu().numpy(),
                             float(row[4]), float(row[5]))
        require(np.isfinite(yk).all(), "kernel output finite")
        res["snr_plain_db"].append(round(float(snr_db(yp, yk)), 1))
        res["snr_f64_db"].append(round(float(snr_db(ref, yk)), 1))
        res["max_abs_err"] = max(res["max_abs_err"],
                                 float(np.max(np.abs(yk - yp))))
        require(res["snr_plain_db"][-1] >= 110, f"kernel vs plain >= 110 dB {res}")
        require(res["snr_f64_db"][-1] >= 90, f"kernel vs float64 >= 90 dB {res}")
    a1 = torch.tensor(sos[0, 4], device=dev)
    a2 = torch.tensor(sos[0, 5], device=dev)
    res["ms"] = cuda_ms(lambda: kernels.iir_tiles(v, s, a1, a2), iters=200)
    res["device_ms"] = graph_ms(lambda: kernels.iir_tiles(v, s, a1, a2))
    res["plain_ms"] = cuda_ms(
        lambda: _iir_apply(v, s, a1, a2, force="tiles"), iters=5)
    res["bound_ms"], res["bound_by"] = bound_ms(
        4 * (2 * C * B + 2 * C + 2), 4 * C * B)
    return res


def section_f64(x, frames, x_tail, s, row):
    """One section in float64 from the float32 coefficients ``row``: the
    output over the whole block (the input zeroed from ``frames`` on)."""
    b0, b1, b2, _, a1, a2 = (float(c) for c in row)
    buf = np.concatenate([x_tail, x], axis=1).astype(np.float64)
    buf[:, 2 + frames:] = 0.0
    v = b0 * buf[:, 2:] + b1 * buf[:, 1:-1] + b2 * buf[:, :-2]
    return recurrence_f64(v, s, a1, a2)


def check_section(dev, shape, seed: int) -> dict:
    """``biquad_section`` against the eager section (its plain version) and
    float64, for both EQ sections, with and without the refinement pass,
    at four valid lengths; times both at section 0 with the refinement.
    Its bound: x read and y written once (plus the states and the
    coefficient row); operations a sample: 5 for the FIR part, 4 for the
    recurrence, and with the refinement 5 for the defect, 4 for its
    recurrence and 1 to add it."""
    import torch

    from pipe_tpu_torch import kernels
    from pipe_tpu_torch.ops.biquad import _biquad_section_ref
    from pipe_tpu_torch.signal import snr_db

    rng = np.random.default_rng(seed)
    C, B = shape

    def on_card(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    x = on_card(rng.standard_normal((C, B)))
    x_tail, s = (on_card(rng.standard_normal((C, 2))) for _ in range(2))
    state = {"x_tail": x_tail, "s": s}
    host = [t.cpu().numpy() for t in (x, x_tail, s)]
    res = {"shape": list(shape), "snr_plain_db": [], "snr_f64_db": [],
           "snr_state_db": [], "max_abs_err": 0.0}
    for row in eq_sos().astype(np.float32):
        coefs = on_card(row)
        for refine in (True, False):
            for frames in (B, 6824 if B > 6824 else B - 1, 1, 0):
                y, new_x_tail, new_s = kernels.biquad_section(
                    x, frames, x_tail, s, coefs, refine)
                ref_state, y_p = _biquad_section_ref(state, x, frames, coefs,
                                                     refine)
                torch.cuda.synchronize()
                what = f"biquad_section {shape} refine={refine} frames={frames}"
                yk, yp = y.cpu().numpy(), y_p.cpu().numpy()
                require(np.isfinite(yk).all(), f"{what}: output finite")
                plain_db = float(snr_db(yp, yk))
                require(plain_db >= 110, f"{what}: vs plain {plain_db:.1f} dB")
                require(torch.equal(new_x_tail, ref_state["x_tail"]),
                        f"{what}: new x_tail differs from the plain version's")
                # the new s is the kernel's own output at the last two
                # valid frames (the carried state before them), exactly
                y_hist = torch.cat([s.flip(1), y], dim=1)
                require(torch.equal(new_s, y_hist[:, frames: frames + 2].flip(1)),
                        f"{what}: new s is not the last two valid outputs")
                same = torch.equal(new_s, ref_state["s"])
                state_db = float("inf") if same else float(snr_db(
                    ref_state["s"].cpu().numpy(), new_s.cpu().numpy()))
                require(state_db >= 110, f"{what}: new s {state_db:.1f} dB")
                res["snr_plain_db"].append(round(plain_db, 1))
                res["snr_state_db"].append(round(min(state_db, 999.0), 1))
                res["max_abs_err"] = max(res["max_abs_err"],
                                         float(np.max(np.abs(yk - yp))))
                if refine and frames == B:
                    f64_db = float(snr_db(section_f64(
                        host[0], frames, host[1], host[2], row), yk))
                    require(f64_db >= 90, f"{what}: vs float64 {f64_db:.1f} dB")
                    res["snr_f64_db"].append(round(f64_db, 1))
    coefs = on_card(eq_sos().astype(np.float32)[0])
    res["ms"] = cuda_ms(
        lambda: kernels.biquad_section(x, B, x_tail, s, coefs), iters=200)
    res["device_ms"] = graph_ms(
        lambda: kernels.biquad_section(x, B, x_tail, s, coefs))
    res["plain_ms"] = cuda_ms(
        lambda: _biquad_section_ref(state, x, B, coefs), iters=5)
    res["bound_ms"], res["bound_by"] = bound_ms(
        4 * (2 * C * B + 8 * C + 6), 19 * C * B)
    return res


def check_streamed_recurrence(dev, x) -> dict:
    """The recurrence as a stream: ``x`` in blocks of 10240 frames through
    ``_iir_apply`` on the card (one ``iir_tiles`` launch a block), each
    block starting from the last two outputs of the one before, against
    ``scipy.signal.lfilter`` in float64."""
    import scipy.signal
    import torch

    from pipe_tpu_torch import kernels
    from pipe_tpu_torch.ops.biquad import _iir_apply
    from pipe_tpu_torch.signal import snr_db

    B = 10240
    row = eq_sos().astype(np.float32)[0]
    a1, a2 = (torch.tensor(c, device=dev) for c in row[4:6])
    s = torch.zeros((x.shape[0], 2), dtype=torch.float32, device=dev)
    blocks = x.shape[1] // B
    kernels.reset_counts()
    out = []
    for t in range(blocks):
        y = _iir_apply(torch.from_numpy(x[:, t * B:(t + 1) * B]).to(dev), s,
                       a1, a2)
        s = y[:, -2:].flip(1).contiguous()
        out.append(y)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["iir_tiles"]
    require(launches == blocks,
            f"iir_tiles launched {launches} times for {blocks} blocks")
    y = torch.cat(out, dim=1).cpu().numpy()
    ref = scipy.signal.lfilter(
        [1.0], [1.0, float(row[4]), float(row[5])],
        x[:, : blocks * B].astype(np.float64), axis=1)
    db = float(snr_db(ref, y))
    require(np.isfinite(y).all() and db >= 90,
            f"streamed recurrence vs float64 {db:.1f} dB")
    return {"blocks": blocks, "launches": launches, "f64_db": db}


def check_flagship(dev, n_chunks: int = 4) -> dict:
    """make_flagship fused and unfused on the card against the CPU port."""
    import torch

    from pipe_tpu_torch.flagship import make_flagship
    from pipe_tpu_torch.signal import snr_db

    rng = np.random.default_rng(2)
    chunks = [rng.standard_normal((CHANNELS, BLOCK)).astype(np.float32)
              for _ in range(n_chunks)]
    outs, res = {}, {}
    for fused in (True, False):
        ys = {}
        for where in (dev, torch.device("cpu")):
            fn, state, _ = make_flagship(CHANNELS, BLOCK, fused=fused,
                                         device=where)
            got = []
            for x in chunks:
                state, y = fn(state, torch.from_numpy(x).to(where))
                got.append(y.cpu().numpy())
            ys[where.type] = np.concatenate(got, 1)
        name = "fused" if fused else "unfused"
        require(ys["cuda"].shape == (2, n_chunks * 10240), f"{name} shape")
        require(np.isfinite(ys["cuda"]).all(), f"{name} finite")
        res[f"{name}_vs_cpu_db"] = snr_db(ys["cpu"], ys["cuda"])
        require(res[f"{name}_vs_cpu_db"] >= 100, f"{name} card vs CPU {res}")
        outs[name] = ys["cuda"]
    res["fused_vs_unfused_db"] = snr_db(outs["unfused"], outs["fused"])
    require(res["fused_vs_unfused_db"] >= 100, f"fused vs unfused {res}")
    return res


def slice_line(port, x, out: list, fed: list, gate=None):
    """The slice's line over the host array ``x``: a host feed, FIR(255),
    44.1k->48k resampler, the two-section biquad EQ, a 64->2 mix, and a
    host receive collecting into ``out``. ``fed`` counts fed blocks; the
    feed waits for ``gate`` (a ``threading.Event``) when one is given.
    Returns the line and its EQ."""
    from pipe_tpu_torch import ops

    C, N = x.shape
    pos = [0]
    eq = ops.Biquad(eq_sos())

    def feed(block_size):
        if gate is not None and not gate.wait(60):
            raise RuntimeError("feed gate never opened")
        if pos[0] >= N:
            return None
        chunk = x[:, pos[0]: pos[0] + block_size]
        pos[0] += chunk.shape[1]
        fed.append(chunk.shape[1])
        return chunk

    def source(mctx, block_size):
        return port.Source(
            output=port.SignalProperties(sample_rate=float(SR_IN), channels=C),
            feed=feed)

    def sink(mctx, block_size, props):
        return port.Sink(receive=lambda a: out.append(a))

    return port.Line(
        source=source,
        processors=[
            ops.FIR(ops.design_lowpass(255, 4000, SR_IN)).processor(),
            ops.Resampler(SR_OUT, SR_IN).processor(),
            eq.processor(),
            ops.ChannelMix(np.ones((2, C)) / C).processor(),
        ],
        sink=sink,
    ), eq


def run_slice(port, x, device=None):
    """The slice through ``run``; with no ``device``, on the port's default
    (the card)."""
    out, fed = [], []
    port.run(BLOCK, slice_line(port, x, out, fed)[0], device=device)
    return np.concatenate(out, axis=1), len(fed)


def slice_oracle(x):
    """The slice's chain in float64 with scipy, from the port's float32
    coefficients: FIR, polyphase resample (upfirdn of the prototype whose
    phases are the bank's rows), biquad cascade, mix."""
    import scipy.signal

    from pipe_tpu_torch import ops

    f32 = lambda a: np.asarray(a, np.float32).astype(np.float64)  # noqa: E731
    C, N = x.shape
    h = f32(ops.design_lowpass(255, 4000, SR_IN))
    y = scipy.signal.oaconvolve(x.astype(np.float64), h[None, :], axes=1)[:, :N]
    hp = f32(ops.polyphase_design(160, 147, 32))  # (L, K): hp[p, i] = h[i*L + p]
    n_out = -(-N * 160 // 147)
    y = scipy.signal.upfirdn(hp.T.reshape(-1), y, up=160, down=147,
                             axis=1)[:, :n_out]
    y = scipy.signal.sosfilt(f32(eq_sos()), y, axis=1)
    return f32(np.ones((2, C)) / C) @ y


RETUNE_AT, INSERT_AT, ADD_AFTER, B_BLOCKS = 12, 24, 8, 20


def wait_until(cond, what: str, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise RuntimeError(f"timed out waiting for {what}")
        time.sleep(0.001)


def surgery_scenario(port, x, device, lookahead: int = 4,
                     retune: bool = True):
    """Phase 8's scenario: the slice (line A) in ``Pipe(9408, lookahead)``
    on ``device``, its feed held until the targeted surgery is queued; the
    EQ retuned (peak -3 dB) at block 12, a 200 Hz low shelf inserted before
    the mix at block 24, and after block 8 a second line (B) added live.
    Returns line A's and line B's outputs."""
    from pipe_tpu_torch import mock, ops

    out_a, gate = [], threading.Event()
    line_a, eq = slice_line(port, x, out_a, [], gate=gate)
    p = port.Pipe(BLOCK, line_a, lookahead=lookahead, device=device)
    p.start()
    targets = [INSERT_AT]
    if retune:
        p.push(eq.set_sos(eq_sos(-3.0)), at_block=RETUNE_AT)
        targets = [RETUNE_AT, INSERT_AT]
    shelf = ops.Biquad(ops.design_lowshelf(SR_OUT, 200, -2.0))
    h_insert = p.insert_processor(0, 3, shelf.processor(), at_block=INSERT_AT)
    dest = p._exec_of_route[0].dest
    wait_until(lambda: sorted(dest.pending_targets()) == targets,
               "the targeted surgery to reach line A")
    gate.set()
    wait_until(lambda: len(out_a) >= ADD_AFTER or not p._running,
               f"{ADD_AFTER} blocks of line A")
    sink_b = mock.Sink()
    h_add = p.add_line(port.Line(
        source=mock.Source(value=0.25, channels=CHANNELS,
                           sample_rate=float(SR_IN),
                           limit=B_BLOCKS * BLOCK).source(),
        processors=[ops.Resampler(SR_OUT, SR_IN).processor(),
                    ops.Biquad(eq_sos()).processor()],
        sink=sink_b.sink()))
    for name, h in (("insert_processor", h_insert), ("add_line", h_add)):
        require(h.wait(60), f"{name} handle completed")
        require(h.error is None, f"{name} handle error {h.error!r}")
    p.wait(300)  # raises the first executor-thread error
    return np.concatenate(out_a, axis=1), sink_b.values


def pipe_rate(port, x, device, lookahead: int, batch_blocks: int) -> float:
    """Input samples/s of the plain slice through ``Pipe`` on ``device``
    (host clock from ``start`` to the end of ``wait``, synchronized)."""
    import torch

    out = []
    p = port.Pipe(BLOCK, slice_line(port, x, out, [])[0], device=device,
                  lookahead=lookahead, batch_blocks=batch_blocks)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p.start()
    p.wait(300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(sum(a.shape[1] for a in out) == SR_IN * SECONDS * 160 // 147,
            "Pipe rate run output length")
    return x.size / wall


def check_pipe_slice(port, dev, x) -> dict:
    """Phase 8 (see the module docstring)."""
    import torch

    from pipe_tpu_torch import kernels
    from pipe_tpu_torch.signal import snr_db

    n_out = SR_IN * SECONDS * 160 // 147
    blocks = -(-x.shape[1] // BLOCK)
    surgery_scenario(port, x[:, : 30 * BLOCK], dev)  # warm-up
    kernels.reset_counts()
    t0 = time.perf_counter()
    y4, b4 = surgery_scenario(port, x, dev, lookahead=4)
    wall = time.perf_counter() - t0
    by_thread = kernels.launch_counts(by_thread=True)
    launches = {t: c.get("biquad_section", 0) for t, c in by_thread.items()}
    want_a = 2 * blocks + (blocks - INSERT_AT)
    want = {"pipe-exec-line0": want_a, "pipe-exec-line1": 2 * B_BLOCKS}
    require(launches == want,
            f"biquad_section launches per thread {launches} != {want}")
    require(kernels.launch_counts()["iir_tiles"] == 0,
            "the Pipe launched the recurrence kernel outside a section")
    require(y4.shape == (2, n_out), f"line A output {y4.shape} != (2, {n_out})")
    require(b4.shape == (CHANNELS, B_BLOCKS * 10240), f"line B output {b4.shape}")
    require(np.isfinite(y4).all() and np.isfinite(b4).all(), "outputs finite")

    y1, b1 = surgery_scenario(port, x, dev, lookahead=1)
    la_diff = float(np.max(np.abs(y4 - y1)))
    la_db = snr_db(y1, y4)
    require(la_db >= 120, f"lookahead 4 vs 1 on the card {la_db:.1f} dB")
    require(np.array_equal(b4, b1), "line B at lookahead 4 vs 1")

    y_keep, _ = surgery_scenario(port, x, dev, retune=False)
    differs = np.flatnonzero(np.any(y_keep != y4, axis=0))
    first = int(differs[0]) if differs.size else -1
    require(first == RETUNE_AT * 10240,
            f"first sample changed by the retune {first} != {RETUNE_AT * 10240}")

    t_cpu = time.perf_counter()
    yc, bc = surgery_scenario(port, x, torch.device("cpu"))
    t_cpu = time.perf_counter() - t_cpu
    cpu_db, cpu_b_db = snr_db(yc, y4), snr_db(bc, b4)
    require(cpu_db >= 100, f"line A card vs CPU port {cpu_db:.1f} dB")
    require(cpu_b_db >= 100, f"line B card vs CPU port {cpu_b_db:.1f} dB")

    rates = {}
    for la, bb in ((1, 1), (4, 1), (1, 4), (1, 4), (4, 1), (1, 1)):
        rates.setdefault(f"lookahead {la} batch_blocks {bb}", []).append(
            pipe_rate(port, x, dev, la, bb))
    return {"launches": launches, "la_db": la_db, "la_diff": la_diff,
            "first": first, "cpu_db": cpu_db, "cpu_b_db": cpu_b_db,
            "wall": wall, "cpu_wall": t_cpu, "rates": rates}


def check_dispatch(port, dev) -> dict:
    """Phase 9: BASELINE configs 1 and 2 through the port's runtime on the
    card (no kernel on this path)."""
    import torch

    from pipe_tpu_torch import mock, ops

    res = {}
    blocks, block = 2000, 512
    for bb in (1, 32):
        for timed in (False, True):  # warm-up, then timed
            src = mock.Source(value=1.0, channels=1, limit=blocks * block)
            sink = mock.Sink(discard=True)
            line = port.Line(source=src.source(), sink=sink.sink(),
                             processors=[ops.Gain(0.5).processor()])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            port.run(block, line, lookahead=32, batch_blocks=bb, device=dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            require(sink.samples == blocks * block, "config 1 samples")
        res[f"config1 batch_blocks {bb} us/block"] = dt / blocks * 1e6

    blocks = 1000
    src = mock.Source(value=1.0, channels=2, limit=blocks * block)
    sink = mock.Sink(discard=True)
    g = ops.Gain(1.0)
    mx = ops.ChannelMix(np.eye(2, dtype=np.float32))
    p = port.Pipe(block, port.Line(source=src.source(), sink=sink.sink(),
                                   processors=[g.processor(), mx.processor()]),
                  lookahead=32, device=dev)
    t0 = time.perf_counter()
    p.start()
    for i in range(50):
        p.push(g.set_gain(1.0 - i * 0.01))
    p.wait(600)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    require(sink.samples == blocks * block, "config 2 samples")
    res["config2 blocks/s (50 pushes)"] = blocks / dt
    return res


def feed_line(port, x, processors, out: list, gate=None, context=None,
              hold_at: int = 0):
    """Host feed of ``x`` (``gate``: a ``threading.Event`` the feed waits
    for before reading frame ``hold_at`` and on) -> ``processors`` -> host
    receive into ``out``, in the mutable ``context`` when one is given."""
    pos = [0]

    def feed(block_size):
        if gate is not None and pos[0] >= hold_at and not gate.wait(60):
            raise RuntimeError("feed gate never opened")
        if pos[0] >= x.shape[1]:
            return None
        pos[0] += block_size
        return x[:, pos[0] - block_size: pos[0]]

    return port.Line(
        source=lambda m, b: port.Source(
            output=port.SignalProperties(sample_rate=float(SR_IN),
                                         channels=x.shape[0]),
            feed=feed),
        processors=processors,
        sink=lambda m, b, p: port.Sink(receive=out.append),
        **({} if context is None else {"context": context}))


def config4_ir():
    """BASELINE config 4's reverb IR (benchmarks/configs.py, seed 1)."""
    rng = np.random.default_rng(1)
    return rng.standard_normal(65536) * np.exp(-np.arange(65536) / 8000)


def peaking_sos():
    from pipe_tpu_torch import ops

    return ops.design_peaking_eq(SR_IN, 1000, 1.0, 3.0)


def device_profile(fn, n_blocks: int) -> dict:
    """Device time of ``fn()`` by kernel group (ms), the mean time of each
    biquad kernel (us), kernel launches per block and the names of the
    kernels that work in float64, from ``torch.profiler``'s
    ``key_averages``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    groups = {"biquad kernels": 0.0, "fft": 0.0, "memcpy": 0.0, "other": 0.0}
    launches, float64_kernels, biquad_us = 0, [], {}
    for evt in prof.key_averages():
        if evt.key == "cudaLaunchKernel":
            launches += evt.count
        t = evt.self_device_time_total / 1000.0  # us -> ms
        if t <= 0:
            continue
        name = evt.key.lower()
        if "double" in name:
            float64_kernels.append(evt.key)
        if "biquad_" in name:
            groups["biquad kernels"] += t
            short = re.search(r"biquad_\w+(<[^>]*>)?", evt.key).group(0)
            biquad_us[short] = round(1e3 * t / evt.count, 2)
        elif "fft" in name:
            groups["fft"] += t
        elif "memcpy" in name:
            groups["memcpy"] += t
        else:
            groups["other"] += t
    total = sum(groups.values())
    require(total > 0, "the profiler recorded device time")
    return {"device_ms": total, "ms": groups,
            "share": {k: v / total for k, v in groups.items()},
            "launches_per_block": launches / n_blocks,
            "biquad_us": biquad_us, "float64_kernels": float64_kernels}


def check_config4(port, dev, x) -> dict:
    """Phase 10 (see the module docstring)."""
    import scipy.signal
    import torch

    from pipe_tpu_torch import kernels, ops
    from pipe_tpu_torch.ops import biquad as biquad_ops
    from pipe_tpu_torch.ops.biquad import _biquad_section_ref, _iir_apply
    from pipe_tpu_torch.ops.ols import ols_block, ols_init_state, partition_ir
    from pipe_tpu_torch.signal import snr_db

    ir = config4_ir()

    def run_c4(xs, device):
        out = []
        port.run(B4, feed_line(port, xs, [ops.OLSConvolve(ir).processor(),
                                          ops.Biquad(peaking_sos()).processor()],
                               out), device=device)
        return np.concatenate(out, axis=1)

    blocks = -(-x.shape[1] // B4)
    run_c4(x[:, : 2 * B4], dev)  # warm-up
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y = run_c4(x, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()["biquad_section"]
    require(y.shape == x.shape, f"config 4 output {y.shape} != {x.shape}")
    require(np.isfinite(y).all(), "config 4 output finite")
    want = blocks if dev.type == "cuda" else 0
    require(launches == want,
            f"biquad_section launched {launches} times for {blocks} blocks")
    require(kernels.launch_counts()["iir_tiles"] == 0,
            "config 4 launched the recurrence kernel outside a section")
    t_cpu = time.perf_counter()
    y_cpu = run_c4(x, torch.device("cpu"))
    t_cpu = time.perf_counter() - t_cpu
    cpu_db = snr_db(y_cpu, y)
    require(cpu_db >= 90, f"config 4 card vs CPU port {cpu_db:.1f} dB")
    oracle = scipy.signal.fftconvolve(x.astype(np.float64), ir[None, :],
                                      axes=1)[:, : x.shape[1]]
    oracle = scipy.signal.sosfilt(peaking_sos(), oracle, axis=1)
    f64_db = snr_db(oracle, y)
    require(f64_db >= 90, f"config 4 card vs float64 {f64_db:.1f} dB")

    rng = np.random.default_rng(40)
    spec = torch.from_numpy(partition_ir(ir, B4)).to(dev)
    st = ols_init_state(C4, B4, spec.shape[1], dev)
    xb = torch.tensor(rng.standard_normal((C4, B4)), dtype=torch.float32,
                      device=dev)
    ols_ms = cuda_ms(lambda: ols_block(st, xb, B4, spec), iters=50)
    s = torch.tensor(rng.standard_normal((C4, 2)), dtype=torch.float32, device=dev)
    a1, a2 = (torch.tensor(c, dtype=torch.float32, device=dev)
              for c in np.float32(peaking_sos()[4:6]))
    kernel_db = snr_db(_iir_apply(xb, s, a1, a2, force="tiles").cpu().numpy(),
                       kernels.iir_tiles(xb, s, a1, a2).cpu().numpy())
    require(kernel_db >= 110, f"iir_tiles ({C4}, {B4}) vs plain {kernel_db:.1f} dB")
    kernel_ms = cuda_ms(lambda: kernels.iir_tiles(xb, s, a1, a2), iters=200)
    plain_ms = cuda_ms(lambda: _iir_apply(xb, s, a1, a2, force="tiles"), iters=5)
    coefs = torch.tensor(np.float32(peaking_sos()), device=dev)
    st = {"x_tail": s.flip(1).contiguous(), "s": s}
    section_db = snr_db(
        _biquad_section_ref(st, xb, 6824, coefs)[1].cpu().numpy(),
        kernels.biquad_section(xb, 6824, st["x_tail"], s, coefs)[0].cpu().numpy())
    require(section_db >= 110,
            f"biquad_section ({C4}, {B4}) vs plain {section_db:.1f} dB")
    section_ms = cuda_ms(
        lambda: kernels.biquad_section(xb, B4, st["x_tail"], s, coefs), iters=200)
    section_plain_ms = cuda_ms(
        lambda: _biquad_section_ref(st, xb, B4, coefs), iters=5)

    # the profiled run must stay inside the kernels: no eager section, no
    # eager recurrence, no float64 kernel (the eager refinement's defect)
    eager = []
    spied = {n: getattr(biquad_ops, n) for n in ("_biquad_section_ref", "_iir_apply")}
    for n, fn in spied.items():
        setattr(biquad_ops, n,
                lambda *a, _n=n, _fn=fn, **k: eager.append(_n) or _fn(*a, **k))
    try:
        prof = device_profile(lambda: run_c4(x[:, : 10 * B4], dev), 10)
    finally:
        for n, fn in spied.items():
            setattr(biquad_ops, n, fn)
    if dev.type == "cuda":
        require(not eager, f"eager biquad functions ran on the card: {eager[:4]}")
        require(not prof["float64_kernels"],
                f"float64 kernels in config 4's profile: {prof['float64_kernels']}")
    return {"blocks": blocks, "launches": launches, "wall": wall, "y": y,
            "oracle": oracle,
            "rate": x.size / wall, "cpu_db": cpu_db, "f64_db": f64_db,
            "cpu_wall": t_cpu, "ols_ms": ols_ms, "kernel_ms": kernel_ms,
            "kernel_db": kernel_db, "plain_ms": plain_ms,
            "section_ms": section_ms, "section_db": section_db,
            "section_plain_ms": section_plain_ms, "profile": prof}


def optimizer_pipe(port, x, dev, optimize: bool, retunes=()):
    """Phase 11's pipe: ``Gain(0.5) -> OLS -> peaking -> high shelf`` in
    ``Pipe(8192, lookahead=4)``. ``retunes`` may hold "eq" (peak -3 dB at
    block 20, through the original Biquad) and "gain" (0.25 at block 30,
    through the original Gain); the feed waits until they reached the
    line. Returns the output, the line's components, its kernel launches
    and the run's wall time."""
    import torch

    from pipe_tpu_torch import kernels, ops

    gate, out = threading.Event(), []
    g, peq = ops.Gain(0.5), ops.Biquad(peaking_sos())
    procs = [g.processor(), ops.OLSConvolve(config4_ir()).processor(),
             peq.processor(),
             ops.Biquad(ops.design_highshelf(SR_IN, 8000, -2.0)).processor()]
    p = port.Pipe(B4, feed_line(port, x, procs, out, gate), lookahead=4,
                  optimize=optimize, device=dev)
    kernels.reset_counts()
    t0 = time.perf_counter()
    p.start()
    targets = []
    if "eq" in retunes:
        p.push(peq.set_sos(ops.design_peaking_eq(SR_IN, 1000, 1.0, -3.0)),
               at_block=EQ_AT)
        targets.append(EQ_AT)
    if "gain" in retunes:
        p.push(g.set_gain(0.25), at_block=GAIN_AT)
        targets.append(GAIN_AT)
    dest = p._exec_of_route[0].dest
    wait_until(lambda: sorted(dest.pending_targets()) == targets,
               "phase 11's targets to reach the line")
    gate.set()
    p.wait(300)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts(by_thread=True)
    launches = counts.get("pipe-exec-line0", {}).get("biquad_section", 0)
    return {"y": np.concatenate(out, axis=1), "gain": g, "eq": peq,
            "n_procs": len(p.routes[0].processors), "launches": launches,
            "wall": wall}


def first_change(a, b) -> int:
    require(a.shape == b.shape, f"shapes {a.shape} and {b.shape}")
    d = np.flatnonzero(np.any(a != b, axis=0))
    return int(d[0]) if d.size else -1


def check_optimizer(port, dev, x) -> dict:
    """Phase 11 (see the module docstring)."""
    from pipe_tpu_torch.signal import snr_db

    blocks = -(-x.shape[1] // B4)
    want = 2 * blocks if dev.type == "cuda" else 0
    runs, res = {}, {"launches": {}, "walls": {}}
    for opt in (True, False):
        for retunes in ((), ("eq",), ("eq", "gain")):
            r = optimizer_pipe(port, x, dev, opt, retunes)
            name = ("optimized" if opt else "plain") + "+" + "+".join(retunes)
            require(r["y"].shape == x.shape, f"{name} output {r['y'].shape}")
            require(np.isfinite(r["y"]).all(), f"{name} output finite")
            require(r["launches"] == want,
                    f"{name}: {r['launches']} kernel launches != {want}")
            res["launches"][name] = r["launches"]
            res["walls"][name] = r["wall"]
            runs[(opt, retunes)] = r
    fused = runs[(True, ())]
    kinds = [type(fused["gain"]._delegate).__name__,
             type(fused["eq"]._delegate).__name__]
    require(kinds == ["OLSWithGain", "BiquadCascade"] and fused["n_procs"] == 2,
            f"fused line {kinds}, {fused['n_procs']} stages")
    require(runs[(False, ())]["gain"]._delegate is None, "plain line unfused")
    res["fused"] = kinds
    for retunes in ((), ("eq",)):
        a, b = runs[(True, retunes)]["y"], runs[(False, retunes)]["y"]
        same = bool(np.array_equal(a, b))
        db = float("inf") if same else snr_db(b, a)
        require(same or db >= 120, f"optimized vs plain {retunes}: {db:.1f} dB")
        res["identical" + "+".join(("",) + retunes)] = same
        res["db" + "+".join(("",) + retunes)] = db
    for opt in (True, False):
        eq_first = first_change(runs[(opt, ("eq",))]["y"], runs[(opt, ())]["y"])
        gain_first = first_change(runs[(opt, ("eq", "gain"))]["y"],
                                  runs[(opt, ("eq",))]["y"])
        name = "optimized" if opt else "plain"
        require(eq_first == EQ_AT * B4, f"{name} EQ retune lands at {eq_first}")
        require(gain_first == GAIN_AT * B4,
                f"{name} gain retune lands at {gain_first}")
        res[f"{name} landings"] = (eq_first, gain_first)
    return res


def timed_run(port, x, make_procs, block: int, device):
    """Output and synchronized wall time of ``run`` over ``x``."""
    import torch

    out = []
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    port.run(block, feed_line(port, x, make_procs(), out), device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return np.concatenate(out, axis=1), time.perf_counter() - t0


def check_kit(port, dev) -> dict:
    """Phase 12 (see the module docstring)."""
    import scipy.signal
    import torch

    from pipe_tpu_torch import ops
    from pipe_tpu_torch.signal import snr_db

    rng = np.random.default_rng(12)
    C, N, block = 8, 2 * SR_IN, 4096
    t = np.arange(N) / SR_IN
    noise = (0.5 * rng.standard_normal((C, N))).astype(np.float32)
    bursts = np.where((t // 0.25) % 2 == 0, 0.5, 1e-4) * np.sin(
        2 * np.pi * 440 * t)
    bursts = np.tile(bursts, (C, 1)).astype(np.float32)
    msg = np.sin(2 * np.pi * 40.0 * t)
    carrier = 2 * np.pi * 8000.0 * t
    am = ((0.5 + 0.4 * msg) * np.cos(carrier)).astype(np.float32)
    fm = np.cos(carrier + 2 * np.pi * 1500.0 * np.cumsum(msg) / SR_IN)
    am, fm = np.tile(am, (C, 1)), np.tile(fm.astype(np.float32), (C, 1))
    lp = ops.design_lowpass(127, 3000.0, SR_IN)
    cases = [
        ("Delay ring D=3000 fb 0.5", noise, lambda: [
            ops.Delay(3000, feedback=0.5, wet=0.7, dry=0.5).processor()]),
        ("Delay scan D=300 fb 0.6", noise, lambda: [
            ops.Delay(300, feedback=0.6, wet=0.7, dry=0.3).processor()]),
        ("Compressor 50 ms attack", noise, lambda: [
            ops.Compressor(-15.0, 4.0, attack_ms=50.0,
                           release_ms=120.0).processor()]),
        ("NoiseGate", bursts, lambda: [
            ops.NoiseGate(-40.0, 60.0, attack_ms=1.0,
                          release_ms=20.0).processor()]),
        ("SpectralGain W1024 H256", noise, lambda: [
            ops.SpectralGain(1024, 256, np.linspace(1.0, 0.1, 513)).processor()]),
        ("SpectralGate W1024 H256", noise, lambda: [
            ops.SpectralGate(1024, 256, threshold=8.0,
                             reduction_db=-40.0).processor()]),
        ("Channelizer 16", noise, lambda: [ops.Channelizer(16).processor()]),
        ("AM demod", am, lambda: ops.am_demod_factory(8000.0, lp)),
        ("FM demod", fm, lambda: ops.fm_demod_factory(8000.0, lp)),
    ]
    res = {}
    cpu = torch.device("cpu")
    for name, x, make in cases:
        timed_run(port, x[:, :block], make, block, dev)  # warm-up
        y, t_card = timed_run(port, x, make, block, dev)
        y_cpu, t_cpu = timed_run(port, x, make, block, cpu)
        require(y.shape == y_cpu.shape and np.isfinite(y).all(),
                f"{name}: output {y.shape}")
        db = snr_db(y_cpu, y)
        require(db >= 100, f"{name}: card vs CPU port {db:.1f} dB")
        res[name] = {"db": db, "ms": 1e3 * t_card, "cpu_ms": 1e3 * t_cpu}

    rows = np.stack([ops.design_peaking_eq(SR_IN, 20.0, 0.5, 6.0),
                     ops.design_peaking_eq(SR_IN, 1000.0, 4.0, -4.0)])
    x = rng.standard_normal((2, 8 * 2048)).astype(np.float32)
    ext = lambda: [ops.Biquad(rows, precision="extended").processor()]  # noqa: E731
    std = lambda: [ops.Biquad(rows).processor()]  # noqa: E731
    timed_run(port, x[:, :2048], ext, 2048, dev)  # warm-up
    y, t_ext = timed_run(port, x, ext, 2048, dev)
    y_cpu, t_ext_cpu = timed_run(port, x, ext, 2048, cpu)
    y_std, t_std = timed_run(port, x, std, 2048, dev)
    ref = scipy.signal.sosfilt(rows, x.astype(np.float64), axis=1)
    db, f64_db, std_db = snr_db(y_cpu, y), snr_db(ref, y), snr_db(ref, y_std)
    require(db >= 100, f"extended biquad card vs CPU port {db:.1f} dB")
    require(f64_db >= 100, f"extended biquad vs float64 {f64_db:.1f} dB")
    res["Biquad extended 20 Hz + 1 kHz"] = {
        "db": db, "f64_db": f64_db, "ms": 1e3 * t_ext, "cpu_ms": 1e3 * t_ext_cpu,
        "default_ms": 1e3 * t_std, "default_f64_db": std_db}
    return res


PRECISIONS = ("highest", "high", "default")
CHUNK15 = 147 * 2048  # BASELINE config 5's chunk: 301056 frames, 77 MB at 64 ch
CHUNKS15 = 4
CHUNK16 = 4 * BLOCK  # 37632 frames: 10240 resampled frames a rank on 1x4
CHUNKS16 = 4
MESHES16 = ((1, 4), (2, 2))
SEED16 = 16
# the local blocks that the sharded chain's BiquadStage gives ``iir_tiles``
# beyond KERNEL_SHAPES: phase 15's chunk, phase 16's 2x2 mesh and 1x1
# chain (its 1x4 mesh gives the slice's shape), and the sharded
# chain of config 4 on a 2x2 mesh (its 1x1 and 1x4 blocks are (C4, B4))
SHARDED_SHAPES = ((CHANNELS, CHUNK15 * 160 // 147),
                  (CHANNELS // 2, CHUNK16 * 160 // 147 // 2),
                  (CHANNELS, CHUNK16 * 160 // 147),
                  (C4 // 2, 2 * B4))
CHUNK4S = 4 * B4  # config 4 on four ranks: 32768 frames, 8192 a rank on 1x4
# phase 18's chains: (channels, chunk, chunks)
EFFECTS18 = (8, 32768, 4)
RECEIVER18 = (2, 8192, 4)
DELAY18 = 20000  # <= a 1x1 chunk: ladder; between n_local and the chunk on
#                  1x4 and 2x2: wave-DAG


def check_knob_on_plain_biquad(dev) -> int:
    """Phase 3: the biquad's plain versions on the card give the same bits
    under every precision name (their products do not follow the backends'
    TF32 flags). Returns the number of paths compared."""
    import torch

    from pipe_tpu_torch import config
    from pipe_tpu_torch.ops import biquad

    rng = np.random.default_rng(30)
    sos = eq_sos()[0]
    coefs = torch.tensor(np.float32(sos), device=dev)
    hi, lo = (torch.tensor(a, device=dev) for a in biquad.split_f32_pair(sos))
    x = torch.tensor(rng.standard_normal((8, 2560)), dtype=torch.float32, device=dev)
    s = torch.tensor(rng.standard_normal((8, 2)), dtype=torch.float32, device=dev)
    paths = {
        "_iir_apply(force='tiles')": lambda: biquad._iir_apply(
            x, s, coefs[4], coefs[5], force="tiles"),
        "_iir_apply(force='assoc')": lambda: biquad._iir_apply(
            x, s, coefs[4], coefs[5], force="assoc"),
        "_biquad_section_ref": lambda: biquad._biquad_section_ref(
            {"x_tail": s, "s": s}, x, 2560, coefs)[1],
        "biquad_section_block_extended": lambda: biquad.biquad_section_block_extended(
            {"x_tail": s, "s": s, "s_lo": torch.zeros_like(s)}, x, 2560, hi, lo)[1],
    }
    for what, fn in paths.items():
        outs = []
        for name in PRECISIONS:
            with config.matmul_precision_scope(name):
                outs.append(fn())
        require(all(torch.equal(o, outs[0]) for o in outs[1:]),
                f"{what} moves with the precision knob on the card")
    require(config.fp32_pinned(), "the precision is back at 'highest'")
    return len(paths)


def read_wav(native, path):
    r = native.WavReader(str(path))
    try:
        return r.read(r.total_frames + 1).T, r.sample_rate
    finally:
        r.close()


def check_wav(port, x, want) -> dict:
    """Phase 13 (see the module docstring): ``x`` is phase 10's feed,
    ``want`` phase 10's output."""
    import tempfile

    import torch

    from pipe_tpu_torch import kernels, native, ops

    require(native.available(),
            f"the native library did not build: {native.build_error()}")
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.wav", Path(tmp) / "out.wav"
        w = native.WavWriter(str(src), x.shape[0], SR_IN, 32)
        require(w.write(np.ascontiguousarray(x.T)) == x.shape[1], "WAV frames written")
        w.close()
        source = port.WavSource(str(src))
        require((source.channels, source.sample_rate, source.total_frames)
                == (x.shape[0], SR_IN, x.shape[1]), "WAV header read back")
        sink = port.WavSink(str(dst), bits=32)
        kernels.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        port.run(B4, port.Line(
            source=source.source(),
            processors=[ops.OLSConvolve(config4_ir()).processor(),
                        ops.Biquad(peaking_sos()).processor()],
            sink=sink.sink()))  # no device: the port's default, the card
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()["biquad_section"]
        got, rate = read_wav(native, dst)
    blocks = -(-x.shape[1] // B4)
    require(rate == SR_IN and got.shape == want.shape,
            f"WAV out {got.shape} at {rate} Hz, expected {want.shape}")
    require(sink.frames_written == x.shape[1], "WavSink.frames_written")
    require(launches == blocks,
            f"biquad_section launched {launches} times for {blocks} blocks")
    require(np.array_equal(got, want),
            "the WAV file differs from phase 10's output "
            f"(max abs diff {np.max(np.abs(got - want)):.3g})")
    return {"blocks": blocks, "launches": launches, "wall": wall,
            "rate": x.size / wall}


def check_precision(port, dev, x, oracle) -> dict:
    """Phase 14 (see the module docstring): ``x`` and ``oracle`` are phase
    7's feed and float64 oracle."""
    import torch

    from pipe_tpu_torch import config, kernels, ops, parallel
    from pipe_tpu_torch.ops.fir import fir_apply
    from pipe_tpu_torch.ops.mix import channel_mix_block
    from pipe_tpu_torch.ops.resample import resample_apply
    from pipe_tpu_torch.signal import snr_db

    rng = np.random.default_rng(14)
    host = {
        "x": rng.standard_normal((CHANNELS, BLOCK)).astype(np.float32),
        "tail": rng.standard_normal((CHANNELS, 254)).astype(np.float32),
        "h": np.float32(ops.design_lowpass(255, 4000, SR_IN)),
        "hp": np.float32(ops.polyphase_design(160, 147, 32)),
        # seeded and not TF32-exact, so that all three products of 'high'
        # carry weight (the slice's 1/64 has no remainder)
        "m": np.float32(rng.standard_normal((2, CHANNELS)) / CHANNELS),
    }
    card = {k: torch.tensor(v, device=dev) for k, v in host.items()}
    f64 = {k: torch.tensor(v, dtype=torch.float64) for k, v in host.items()}
    sites = {
        "FIR(255)": lambda d: fir_apply(d["tail"], d["x"], d["h"]),
        "resampler 160/147": lambda d: resample_apply(
            d["tail"][:, :31], d["x"], d["hp"], 160, 147),
        "mix 64->2": lambda d: channel_mix_block(d["x"], d["m"]),
    }
    res = {}
    for what, fn in sites.items():
        ref = fn(f64).numpy()
        res[what] = {}
        for name in PRECISIONS:
            with config.matmul_precision_scope(name):
                y = fn(card).cpu().numpy()
                ms = cuda_ms(lambda: fn(card), iters=50)
            res[what][name] = {"db": float(snr_db(ref, y)), "ms": ms}
    res["slice"] = {}
    for name in PRECISIONS:
        with config.matmul_precision_scope(name):
            run_slice(port, x[:, : 2 * BLOCK])  # warm-up: cuDNN plans
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, _ = run_slice(port, x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        res["slice"][name] = {"db": float(snr_db(oracle, y)), "ms": 1e3 * wall}
    require(config.fp32_pinned(), "the precision is back at 'highest'")
    require(res["slice"]["high"]["db"] >= 100,
            f"the slice under 'high' {res['slice']['high']['db']:.1f} dB < 100")
    require(res["slice"]["highest"]["db"] >= 100, "the slice under 'highest'")

    # the knob does not move the biquad: the kernel and a sharded stage
    sos = eq_sos()[0]
    coefs = torch.tensor(np.float32(sos), device=dev)
    xb = torch.tensor(rng.standard_normal((CHANNELS, 10240)), dtype=torch.float32,
                      device=dev)
    s = torch.tensor(rng.standard_normal((CHANNELS, 2)), dtype=torch.float32,
                     device=dev)

    def sharded():
        chain = parallel.ShardedChain(parallel.make_mesh(1, 1),
                                      [parallel.BiquadStage(sos)], CHANNELS, 10240)
        return chain.step(xb)

    fixed = {
        "kernels.iir_tiles": lambda: kernels.iir_tiles(xb, s, coefs[4], coefs[5]),
        "kernels.biquad_section": lambda: kernels.biquad_section(
            xb, 10240, s, s, coefs)[0],
        "ShardedChain BiquadStage": sharded,
    }
    for what, fn in fixed.items():
        outs = []
        for name in PRECISIONS:
            with config.matmul_precision_scope(name):
                outs.append(fn())
        require(all(torch.equal(o, outs[0]) for o in outs[1:]),
                f"{what} moves with the precision knob")
    res["fixed"] = list(fixed)
    return res


def main_path_stages(parallel):
    """The sharded main path: BASELINE config 5 (FIR -> resample -> merged
    mix) with the slice's two EQ sections before the mix."""
    from pipe_tpu_torch import ops

    sos = eq_sos()
    return [parallel.FIRStage(ops.design_lowpass(255, 4000, SR_IN)),
            parallel.ResampleStage(SR_OUT, SR_IN, 32),
            parallel.BiquadStage(sos[0]), parallel.BiquadStage(sos[1]),
            parallel.MixStage(np.ones((2, CHANNELS)) / CHANNELS)]


def run_chain(chain, x, chunk: int):
    """Stream ``x`` through ``chain`` chunk by chunk; the gathered output on
    the host and the synchronized wall time."""
    import torch

    outs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(x.shape[1] // chunk):
        outs.append(chain.gather(chain.step(x[:, i * chunk:(i + 1) * chunk])))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return torch.cat(outs, dim=1).cpu().numpy(), wall


def check_sharded_one_rank(port, dev) -> dict:
    """Phase 15 (see the module docstring)."""
    from pipe_tpu_torch import kernels, parallel
    from pipe_tpu_torch.signal import snr_db

    x = np.random.default_rng(15).standard_normal(
        (CHANNELS, CHUNKS15 * CHUNK15)).astype(np.float32)
    mesh = parallel.make_mesh(1, 1)
    require(mesh.size == 1 and mesh.transport is None, "a 1x1 mesh needs no group")
    warm = parallel.ShardedChain(mesh, main_path_stages(parallel), CHANNELS, CHUNK15)
    run_chain(warm, x[:, :CHUNK15], CHUNK15)
    del warm
    chain = parallel.ShardedChain(mesh, main_path_stages(parallel), CHANNELS, CHUNK15)
    require(chain.device == dev, f"the chain's device {chain.device} is the card")
    kernels.reset_counts()
    y, wall = run_chain(chain, x, CHUNK15)
    launches = kernels.launch_counts()
    n_out = x.shape[1] * 160 // 147
    require(y.shape == (2, n_out) and np.isfinite(y).all(),
            f"sharded output {y.shape} != (2, {n_out})")
    want = 2 * 2 * CHUNKS15
    require(launches["iir_tiles"] == want,
            f"iir_tiles launched {launches['iir_tiles']} times, expected {want}")
    require(launches["biquad_section"] == 0,
            "the sharded stage launched the one-section kernel")
    oracle = slice_oracle(x)
    f64_db = float(snr_db(oracle, y))
    require(f64_db >= 100, f"sharded 1x1 vs float64 oracle {f64_db:.1f} dB")
    y_stream, _ = run_slice(port, x)
    stream_db = float(snr_db(y_stream, y))
    require(stream_db >= 100, f"sharded 1x1 vs the streaming slice {stream_db:.1f} dB")
    prof = device_profile(lambda: run_chain(chain, x[:, :CHUNK15], CHUNK15), 1)
    return {"launches": launches["iir_tiles"], "wall": wall,
            "rate": x.size / wall, "f64_db": f64_db, "stream_db": stream_db,
            "comm": chain.last_comm, "profile": prof, "x": x, "y": y,
            "oracle": oracle}


def main_path_ops(parallel):
    """The sharded main path (:func:`main_path_stages`) as ops of
    ``parallel.sharded``, for a ``Line``."""
    from pipe_tpu_torch import ops

    sh, sos = parallel.sharded, eq_sos()
    return [sh.FIR(ops.design_lowpass(255, 4000, SR_IN)),
            sh.Resample(SR_OUT, SR_IN, 32),
            sh.Biquad(sos[0]), sh.Biquad(sos[1]),
            sh.Mix(np.ones((2, CHANNELS)) / CHANNELS)]


def config4_ops(parallel):
    """BASELINE config 4 (:func:`config4_stages`) as ops of
    ``parallel.sharded``."""
    sh = parallel.sharded
    return [sh.OLS(config4_ir()), sh.Biquad(peaking_sos())]


def packet_line(port, x, processors, out: list, seed: int):
    """Like :func:`feed_line`, but every read returns a random number of
    frames between 1 and what was asked for."""
    pos, r = [0], np.random.default_rng(seed)

    def feed(n):
        if pos[0] >= x.shape[1]:
            return None
        take = min(int(r.integers(1, n + 1)), x.shape[1] - pos[0])
        pos[0] += take
        return x[:, pos[0] - take: pos[0]]

    return port.Line(
        source=lambda m, b: port.Source(
            output=port.SignalProperties(sample_rate=float(SR_IN),
                                         channels=x.shape[0]),
            feed=feed),
        processors=processors,
        sink=lambda m, b, p: port.Sink(receive=out.append))


def run_mesh_pipe(port, mesh, make_ops, x, block: int, push=None,
                  optimize: bool = False, packets=None, every: int = 16,
                  before=None, out=None, context=None, hold_at: int = 0):
    """Stream ``x`` through ``Pipe(block, Line(make_ops(...)), mesh=mesh,
    host_sync_every=every)`` with a host feed. ``push``: ``(op index,
    at_block)``: the op's ``set_sos`` to the -3 dB peaking section,
    delivered before the feed opens. ``before(pipe, ops)`` runs after
    ``start`` while the feed is held before frame ``hold_at`` (surgery,
    untargeted pushes). ``out`` is the list the sink appends to and
    ``context`` the line's mutable context. Returns the sink's output, the
    synchronized wall time of the stream (the pipe's build left out) and
    the pipe."""
    import torch

    from pipe_tpu_torch import parallel

    line_ops = make_ops(parallel)
    out = [] if out is None else out
    gate = threading.Event()
    procs = [o.processor() for o in line_ops]
    line = (feed_line(port, x, procs, out, gate, context, hold_at)
            if packets is None else packet_line(port, x, procs, out, packets))
    p = port.Pipe(block, line, mesh=mesh, optimize=optimize,
                  host_sync_every=every)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p.start()
    if push is not None:
        p.push(line_ops[push[0]].set_sos(eq_sos(-3.0)[0]), at_block=push[1])
        dest = p._executors[0].dest
        wait_until(lambda: dest.pending_targets() == [push[1]],
                   "the targeted push")
    if before is not None:
        before(p, line_ops)
    gate.set()
    p.wait(600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return np.concatenate(out, axis=1), wall, p


def check_mesh_pipe_one_rank(port, dev, s15) -> dict:
    """Phase 19 (see the module docstring); ``s15`` is phase 15's result."""
    from pipe_tpu_torch import kernels, parallel
    from pipe_tpu_torch.signal import snr_db

    x, y15 = s15["x"], s15["y"]
    mesh = parallel.make_mesh(1, 1)
    out_width = CHUNK15 * 160 // 147
    run_mesh_pipe(port, mesh, main_path_ops, x[:, :CHUNK15], CHUNK15)  # warm-up
    kernels.reset_counts()
    y, wall, p = run_mesh_pipe(port, mesh, main_path_ops, x, CHUNK15)
    launches = kernels.launch_counts()
    require(p.routes[0].device == dev, "the mesh pipe's line is on the card")
    require(p._agg == 1 and len(p.routes[0].processors) == 5, "5 stages, no aggregation")
    require(y.shape == y15.shape and np.array_equal(y, y15),
            "Pipe(mesh=1x1) equals phase 15's ShardedChain bit for bit")
    want = 2 * 2 * CHUNKS15
    require(launches["iir_tiles"] == want,
            f"iir_tiles launched {launches['iir_tiles']} times, expected {want}")
    require(launches["biquad_section"] == 0,
            "a sharded Biquad launched the one-section kernel")
    f64_db = float(snr_db(s15["oracle"], y))
    require(f64_db >= 100, f"mesh pipe vs float64 oracle {f64_db:.1f} dB")

    y_push, _, _ = run_mesh_pipe(port, mesh, main_path_ops, x, CHUNK15,
                                 push=(2, 2))
    first = first_change(y, y_push)
    require(first == 2 * out_width,
            f"the push's first changed sample {first} != {2 * out_width}")

    kernels.reset_counts()
    y_opt, wall_opt, p_opt = run_mesh_pipe(port, mesh, main_path_ops, x, CHUNK15,
                                           optimize=True)
    n_opt = len(p_opt.routes[0].processors)
    require(n_opt < 5, f"optimize=True left {n_opt} stages")
    opt_db = float("inf") if np.array_equal(y_opt, y) else float(snr_db(y, y_opt))
    # the fused FIR+resample bank sums in another order: float32
    # reassociation noise, not the bits of the plain run
    require(opt_db >= 110, f"optimized vs plain mesh pipe {opt_db:.1f} dB")
    require(kernels.launch_counts()["iir_tiles"] == want,
            "the cascade launches iir_tiles as the two sections do")

    y_pk, _, _ = run_mesh_pipe(port, mesh, main_path_ops, x, CHUNK15, packets=7)
    require(np.array_equal(y_pk, y), "a short-read feed gives the same bits")

    # the profile: one block through a pipe that has streamed before, as
    # phase 15 profiles a chain that has (a section's first block computes
    # its unit responses, ~1000 launches that no later block repeats)
    pos = [0]

    def feed(n):
        if pos[0] >= CHUNK15:
            return None
        pos[0] += n
        return x[:, pos[0] - n: pos[0]]

    p_prof = port.Pipe(CHUNK15, port.Line(
        source=lambda m, b: port.Source(
            output=port.SignalProperties(sample_rate=float(SR_IN),
                                         channels=CHANNELS), feed=feed),
        processors=[o.processor() for o in main_path_ops(parallel)],
        sink=lambda m, b, pr: port.Sink(receive=lambda a: None)), mesh=mesh)

    def one_block():
        pos[0] = 0
        p_prof.start()
        p_prof.wait(600)

    one_block()
    prof = device_profile(one_block, 1)
    return {"launches": launches["iir_tiles"], "wall": wall,
            "rate": x.size / wall, "f64_db": f64_db, "first": first,
            "opt_db": opt_db, "opt_stages": n_opt, "opt_rate": x.size / wall_opt,
            "profile": prof,
            "idle": 1 - prof["device_ms"] / (1e3 * wall / CHUNKS15), "y": y}


SURGERY_POS, SURGERY_AT = 4, 2  # live inserts of phases 19 and 20: before the mix


def insert_sos():
    """The section inserted live in phases 19 and 20: a peaking EQ at 2.5 kHz."""
    from pipe_tpu_torch import ops

    return ops.design_peaking_eq(SR_OUT, 2500, 1.2, 4.0)


def inserter(handles: list, pos: int = SURGERY_POS, at_block=SURGERY_AT,
             make=lambda sh: sh.Biquad(insert_sos())):
    """A ``before`` of :func:`run_mesh_pipe`: insert ``make(parallel.sharded)``
    at ``pos`` of line 0, adopted at ``at_block`` (held until the target is
    in the line's mailbox) or, with ``at_block=None``, at the next block
    boundary once the stream dispatched 2 blocks (held until the insert is
    in the mailbox or adopted, so it lands on block 2 or 3). The handle
    goes to ``handles``."""
    def before(p, line_ops):
        from pipe_tpu_torch import parallel

        dest = p._executors[0].dest
        if at_block is None:
            wait_until(lambda: p.block_index() >= 2, "2 dispatched blocks")
        handles.append(p.insert_processor(
            0, pos, make(parallel.sharded).processor(), at_block=at_block))
        if at_block is None:
            # in the mailbox, or already taken from it by the executor
            # (which then adopts it at once and completes the handle)
            wait_until(lambda: dest._pending is not None or handles[-1].done(),
                       "the insert's delivery")
        else:
            wait_until(lambda: dest.pending_targets() == [at_block],
                       "the targeted insert")
    return before


def handle_error(h):
    """The surgery handle's error once it completed (None: adopted)."""
    require(h.wait(60), "the surgery handle completed")
    return h.error


def side_ops(parallel):
    """The line that phase 19 adds live: a resampler and the EQ's peaking
    section on 8 of the 64 channels."""
    sh = parallel.sharded
    return [sh.Resample(SR_OUT, SR_IN, 32), sh.Biquad(eq_sos()[0])]


def streaming_insert(port, dev, x, block: int, at_block: int):
    """The main path as a ``Line`` of the streaming ops (each EQ section an
    op of its own) through ``Pipe`` without a mesh, with phase 19's section
    inserted before the mix at ``at_block``: the reference of the mesh
    pipes' inserts."""
    from pipe_tpu_torch import ops

    sos, out, gate = eq_sos(), [], threading.Event()
    procs = [ops.FIR(ops.design_lowpass(255, 4000, SR_IN)).processor(),
             ops.Resampler(SR_OUT, SR_IN).processor(),
             ops.Biquad(sos[:1]).processor(), ops.Biquad(sos[1:]).processor(),
             ops.ChannelMix(np.ones((2, CHANNELS)) / CHANNELS).processor()]
    p = port.Pipe(block, feed_line(port, x, procs, out, gate), device=dev)
    p.start()
    h = p.insert_processor(0, SURGERY_POS, ops.Biquad(insert_sos()[None]).processor(),
                           at_block=at_block)
    dest = p._exec_of_route[0].dest
    wait_until(lambda: dest.pending_targets() == [at_block], "the targeted insert")
    gate.set()
    p.wait(600)
    require(handle_error(h) is None, f"the streaming insert failed: {h.error!r}")
    return np.concatenate(out, axis=1)


def check_mesh_pipe_surgery(port, dev, x, y) -> dict:
    """Phase 19's live surgery on the 1x1 mesh (see the module docstring):
    ``x`` is phase 15's samples, ``y`` phase 19's plain output."""
    from pipe_tpu_torch import kernels, parallel
    from pipe_tpu_torch.signal import snr_db

    mesh = parallel.make_mesh(1, 1)
    out_width = CHUNK15 * 160 // 147
    plain = 2 * 2 * CHUNKS15
    res = {}
    for key, at in (("at_block", SURGERY_AT), ("untargeted", None)):
        handles = []
        kernels.reset_counts()
        yi, _, _ = run_mesh_pipe(port, mesh, main_path_ops, x, CHUNK15,
                                 before=inserter(handles, at_block=at),
                                 hold_at=0 if at is not None else 2 * CHUNK15)
        launches = kernels.launch_counts()
        require(handle_error(handles[0]) is None,
                f"the {key} insert failed: {handles[0].error!r}")
        first = first_change(y, yi)
        landed = first // out_width
        require(first % out_width == 0 and (landed == at if at is not None
                                            else 2 <= landed <= 3),
                f"the {key} insert first changes sample {first}")
        want = plain + 2 * (CHUNKS15 - landed)
        require(launches["iir_tiles"] == want and launches["biquad_section"] == 0,
                f"the {key} insert: iir_tiles launched {launches['iir_tiles']} "
                f"times, expected {want}")
        res[key] = {"first": first, "landed": landed,
                    "launches": launches["iir_tiles"], "y": yi}
    kernels.reset_counts()
    y_ref = streaming_insert(port, dev, x, CHUNK15, SURGERY_AT)
    res["ref_sections"] = kernels.launch_counts()["biquad_section"]
    want = 2 * CHUNKS15 + (CHUNKS15 - SURGERY_AT)
    require(res["ref_sections"] == want,
            f"the no-mesh insert launched biquad_section {res['ref_sections']} "
            f"times, expected {want}")
    res["db"] = float(snr_db(y_ref, res["at_block"]["y"]))
    require(res["db"] >= 100, f"the 1x1 insert vs the no-mesh Pipe's {res['db']:.1f} dB")

    # a second line joining the running sync group at block 2
    xs = x[:8, :2 * CHUNK15]
    side_out, handles = [], []
    ctx = port.mutable.mutable()

    def add(p, line_ops):
        procs = [o.processor() for o in side_ops(parallel)]
        handles.append(p.add_line(feed_line(port, xs, procs, side_out, context=ctx),
                                  at_block=SURGERY_AT))
        dest = p._executors[0].dest
        wait_until(lambda: dest.pending_targets() == [SURGERY_AT], "the added line")

    kernels.reset_counts()
    y_main, _, _ = run_mesh_pipe(port, mesh, main_path_ops, x, CHUNK15,
                                 context=ctx, before=add)
    launches = kernels.launch_counts()["iir_tiles"]
    require(handle_error(handles[0]) is None, f"add_line failed: {handles[0].error!r}")
    require(np.array_equal(y_main, y), "the main line with a line added beside it")
    alone, _, _ = run_mesh_pipe(port, mesh, side_ops, xs, CHUNK15)
    side = np.concatenate(side_out, axis=1)
    require(side.shape == alone.shape and np.array_equal(side, alone),
            "the added line's output equals that line run alone")
    want = plain + 2 * 2
    require(launches == want, f"add_line run: iir_tiles {launches}, expected {want}")
    res["add_line"] = {"launches": launches, "shape": side.shape}
    return res


def input4():
    """Phase 10's feed: 16 channels x 10 s."""
    return np.random.default_rng(4).standard_normal((C4, N4)).astype(np.float32)


def pad_to(x, chunk: int):
    """``x`` with zeros appended up to a whole number of chunks."""
    n = -(-x.shape[1] // chunk) * chunk
    return np.concatenate(
        [x, np.zeros((x.shape[0], n - x.shape[1]), x.dtype)], axis=1)


def config4_stages(parallel):
    """BASELINE config 4 as sharded stages: the 65,536-tap reverb and the
    peaking EQ."""
    return [parallel.OLSStage(config4_ir()), parallel.BiquadStage(peaking_sos())]


def check_config4_sharded(port, dev, x, y10, oracle) -> dict:
    """Phase 17 (see the module docstring): ``x`` is phase 10's feed, ``y10``
    its output and ``oracle`` its float64 oracle."""
    from pipe_tpu_torch import kernels, parallel
    from pipe_tpu_torch.signal import snr_db

    xp = pad_to(x, B4)
    chunks = xp.shape[1] // B4
    mesh = parallel.make_mesh(1, 1)
    run_chain(parallel.ShardedChain(mesh, config4_stages(parallel), C4, B4),
              xp[:, : 2 * B4], B4)  # warm-up
    chain = parallel.ShardedChain(mesh, config4_stages(parallel), C4, B4)
    ols = chain.stages[0]
    require(ols._partitioned and ols._K == 8 and chain.device == dev,
            f"the OLS stage is partitioned into 8 on the card (K = {ols._K})")
    require(tuple(chain.carries[0]["zfdl"].shape) == (8, 2, C4, B4 + 1),
            f"the delay line's shape {tuple(chain.carries[0]['zfdl'].shape)}")
    kernels.reset_counts()
    y, wall = run_chain(chain, xp, B4)
    launches = kernels.launch_counts()
    y = y[:, : x.shape[1]]
    require(y.shape == x.shape and np.isfinite(y).all(),
            f"sharded config 4 output {y.shape}")
    require(launches["iir_tiles"] == 2 * chunks,
            f"iir_tiles launched {launches['iir_tiles']} times for {chunks} "
            f"chunks of one section, expected {2 * chunks}")
    require(launches["biquad_section"] == 0,
            "the sharded stage launched the one-section kernel")
    require(chain.last_comm == [{}, {}],
            f"collectives on a 1x1 mesh: {chain.last_comm}")
    db10 = float(snr_db(y10, y))
    require(db10 >= 100, f"sharded config 4 vs phase 10's run {db10:.1f} dB")
    f64_db = float(snr_db(oracle, y))
    require(f64_db >= 90, f"sharded config 4 vs float64 {f64_db:.1f} dB")
    prof = device_profile(lambda: run_chain(chain, xp[:, : 10 * B4], B4), 10)
    return {"chunks": chunks, "launches": launches["iir_tiles"], "wall": wall,
            "rate": x.size / wall, "db10": db10, "f64_db": f64_db,
            "profile": prof, "parts_ms": step_parts_ms(chain, xp, B4, 20)}


def step_parts_ms(chain, x, chunk: int, n: int) -> dict:
    """Where a chunk's wall goes: ms a chunk, over ``n`` chunks, of the
    parts of ``ShardedChain.step`` and of ``gather``, each closed by a
    ``synchronize`` (so the sum exceeds an unbroken step's wall, where the
    host runs ahead of the card)."""
    import torch

    from pipe_tpu_torch.parallel import mesh_scope

    parts = {"input": 0.0, "params": 0.0}
    parts.update({f"{i}:{type(st).__name__}": 0.0
                  for i, st in enumerate(chain.stages)})
    parts["gather"] = 0.0

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[key] += 1e3 * (time.perf_counter() - t0) / n
        return out

    for i in range(n):
        xc = x[:, i * chunk:(i + 1) * chunk]
        local = timed("input", lambda: chain._local_input(xc))
        params = timed("params", chain.params)
        carries = []
        with mesh_scope(chain.mesh):
            for j, (st, c, p) in enumerate(zip(chain.stages, chain.carries, params)):
                c2, local = timed(f"{j}:{type(st).__name__}",
                                  lambda: st.apply(c, p, local))
                carries.append(c2)
        chain.carries = tuple(carries)
        timed("gather", lambda: chain.gather(local))
    return parts


def effects18():
    """Phase 18's first chain: ``(stages of parallel, processors of ops,
    input)``."""
    C, chunk, chunks = EFFECTS18
    x = (0.5 * np.random.default_rng(18).standard_normal(
        (C, chunks * chunk))).astype(np.float32)

    def stages(parallel):
        return [parallel.CompressorStage(-15.0, 4.0, attack_ms=5.0,
                                         release_ms=120.0, sample_rate=SR_IN),
                parallel.DelayStage(DELAY18, feedback=0.5, wet=0.7, dry=0.5),
                parallel.SpectralGateStage(1024, 256, threshold=8.0,
                                           reduction_db=-40.0)]

    def processors(ops):
        return [ops.Compressor(-15.0, 4.0, attack_ms=5.0,
                               release_ms=120.0).processor(),
                ops.Delay(DELAY18, feedback=0.5, wet=0.7, dry=0.5).processor(),
                ops.SpectralGate(1024, 256, threshold=8.0,
                                 reduction_db=-40.0).processor()]

    return stages, processors, x


def receiver18():
    """Phase 18's second chain: an FM receiver (IQ mix, lowpass, quadrature
    discriminator) and a 16-bin channelizer over the demodulated message.
    The channelizer comes last: a discriminator fed a channelizer's real
    rails reads ``atan2(+-0, +-0)`` on the rails that are zero by
    construction, and half a cycle more wherever a rail changes sign, so
    its output there depends on the sign of a rounding error."""
    from pipe_tpu_torch import ops

    C, chunk, chunks = RECEIVER18
    t = np.arange(chunks * chunk) / SR_IN
    msg = np.sin(2 * np.pi * 40.0 * t) + 0.5 * np.sin(2 * np.pi * 700.0 * t)
    fm = np.cos(2 * np.pi * 8000.0 * t
                + 2 * np.pi * 1500.0 * np.cumsum(msg) / SR_IN)
    x = (np.linspace(0.5, 1.0, C)[:, None] * fm).astype(np.float32)
    lp = ops.design_lowpass(127, 3000.0, SR_IN)

    def stages(parallel):
        return [parallel.IQMixStage(8000.0, sample_rate=SR_IN),
                parallel.FIRStage(lp), parallel.FMDiscriminatorStage(),
                parallel.ChannelizerStage(16)]

    def processors(ops):
        return ops.fm_demod_factory(8000.0, lp) + [ops.Channelizer(16).processor()]

    return stages, processors, x


CHAINS18 = {"effects": (effects18, EFFECTS18), "receiver": (receiver18, RECEIVER18)}


def streamed18(port, name):
    """Phase 18's chain ``name`` through the port's streaming ops on the
    CPU."""
    import torch

    from pipe_tpu_torch import ops

    make, _ = CHAINS18[name]
    _, processors, x = make()
    y, _ = timed_run(port, x, lambda: processors(ops), 4096, torch.device("cpu"))
    return y


def check_kit_sharded(port, dev) -> dict:
    """Phase 18 (see the module docstring)."""
    from pipe_tpu_torch import kernels, parallel
    from pipe_tpu_torch.signal import snr_db

    res = {}
    mesh = parallel.make_mesh(1, 1)
    for name, (make, (C, chunk, chunks)) in CHAINS18.items():
        stages, _, x = make()
        run_chain(parallel.ShardedChain(mesh, stages(parallel), C, chunk),
                  x[:, :chunk], chunk)  # warm-up
        chain = parallel.ShardedChain(mesh, stages(parallel), C, chunk)
        require(chain.device == dev, f"{name}: the chain's device is the card")
        kernels.reset_counts()
        y, wall = run_chain(chain, x, chunk)
        require(sum(kernels.launch_counts().values()) == 0,
                f"{name}: no biquad in the chain, yet a kernel was launched")
        y_cpu = streamed18(port, name)
        require(y.shape == y_cpu.shape and np.isfinite(y).all(),
                f"{name}: output {y.shape}, streamed {y_cpu.shape}")
        db = float(snr_db(y_cpu, y))
        require(db >= 100, f"{name}: sharded 1x1 vs the streaming ops on the "
                           f"CPU {db:.1f} dB")
        res[name] = {"db": db, "wall": wall, "rate": x.size / wall,
                     "out": y.shape}
        if name == "effects":
            require(chain.stages[1]._ladder, "the 1x1 delay is in its ladder regime")
    return res


def input16():
    return np.random.default_rng(SEED16).standard_normal(
        (CHANNELS, CHUNKS16 * CHUNK16)).astype(np.float32)


def rank_main(rank: int, world: int, port_no: int, transport: str, out_dir: str):
    """One rank of phase 16: the main path's chain on every mesh of
    ``MESHES16``; writes ``rank<r>.npz`` (launch counts, walls, the local
    carries, and from rank 0 the gathered outputs) into ``out_dir``."""
    import torch

    port = import_port()
    from pipe_tpu_torch import kernels, parallel
    from pipe_tpu_torch.convert import tree_to_numpy
    from pipe_tpu_torch.tree import tree_flatten

    torch.cuda.set_device(rank if transport == "nccl" else 0)
    parallel.initialize(f"localhost:{port_no}", num_processes=world,
                        process_id=rank, transport=transport)
    x = input16()
    saved = {}
    for c, t in MESHES16:
        mesh = parallel.make_mesh(c, t)
        require(mesh.member and mesh.transport == transport, f"mesh {c}x{t}")
        warm = parallel.ShardedChain(mesh, main_path_stages(parallel), CHANNELS,
                                     CHUNK16)
        run_chain(warm, x[:, :CHUNK16], CHUNK16)
        chain = parallel.ShardedChain(mesh, main_path_stages(parallel), CHANNELS,
                                      CHUNK16)
        mesh.reset_stats()
        kernels.reset_counts()
        y, wall = run_chain(chain, x, CHUNK16)
        key = f"{c}x{t}"
        saved[f"{key}/launches"] = kernels.launch_counts()["iir_tiles"]
        saved[f"{key}/sections"] = kernels.launch_counts()["biquad_section"]
        saved[f"{key}/wall"] = wall
        saved[f"{key}/position"] = [mesh.axis_index(parallel.CH_AXIS),
                                    mesh.axis_index(parallel.TIME_AXIS)]
        saved[f"{key}/comm_calls"] = sum(v[0] for v in mesh.stats.values())
        saved[f"{key}/comm_bytes"] = sum(v[1] for v in mesh.stats.values())
        saved[f"{key}/comm_seconds"] = sum(mesh.seconds.values())
        saved[f"{key}/y"] = y
        for i, leaf in enumerate(tree_flatten(tree_to_numpy(chain.carries))[0]):
            saved[f"{key}/carry{i}"] = leaf
        chain_comm = {k: list(v) for k, v in mesh.stats.items()}
        y_pipe = rank_pipe(port, mesh, f"{key}/pipe", saved, main_path_ops, x,
                           CHUNK16, y, chain_comm, push=(2, 2))
        rank_extra(rank, mesh, key, saved, port)
        rank_rounds(rank, port, mesh, key, saved, x, y_pipe)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **saved)
    parallel.shutdown()


def rank_pipe(port, mesh, key: str, saved: dict, make_ops, x, block: int,
              y_chain, chain_comm: dict, push=None):
    """One rank's run of a ``Line`` of sharded ops through ``Pipe(mesh=)``,
    beside the chain's run of the same stages (its gathered output
    ``y_chain`` and the collectives ``chain_comm`` of that run): whether the
    sink holds the chain's bits, the launch counts, the collectives by name,
    the sweeps, the wall and the host seconds inside collectives; with
    ``push`` a second run with the targeted retune: its digest and first
    changed sample. Returns the sink's output."""
    from pipe_tpu_torch import kernels

    # a health round at the end of the stream only: the least a mesh pipe
    # of several ranks makes (one no-op sweep pads to it)
    every = x.shape[1] // block + 1
    run_mesh_pipe(port, mesh, make_ops, x[:, :block], block, every=1)  # warm-up
    mesh.reset_stats()
    kernels.reset_counts()
    y, wall, p = run_mesh_pipe(port, mesh, make_ops, x, block, every=every)
    saved[f"{key}/equal"] = bool(y.shape == y_chain.shape
                                 and np.array_equal(y, y_chain))
    saved[f"{key}/launches"] = kernels.launch_counts()["iir_tiles"]
    saved[f"{key}/sections"] = kernels.launch_counts()["biquad_section"]
    saved[f"{key}/sweeps"] = p.block_index()
    saved[f"{key}/wall"] = wall
    saved[f"{key}/comm"] = json.dumps({k: list(v) for k, v in mesh.stats.items()},
                                      sort_keys=True)
    saved[f"{key}/chain_comm"] = json.dumps(chain_comm, sort_keys=True)
    saved[f"{key}/comm_seconds"] = sum(mesh.seconds.values())
    if push is not None:
        y_push, _, _ = run_mesh_pipe(port, mesh, make_ops, x, block, push=push,
                                     every=every)
        saved[f"{key}/push_sha"] = digest(y_push)
        saved[f"{key}/push_first"] = first_change(y, y_push)
    return y


class FailingSink(list):
    """A sink's list that raises when it is handed block ``at`` (never
    when ``at`` is None)."""

    def __init__(self, at=None):
        super().__init__()
        self.at = at

    def append(self, block) -> None:
        if self.at is not None and len(self) == self.at:
            raise IOError(f"sink failed at block {self.at}")
        super().append(block)


ABORT_RANK, ABORT_AT = 2, 2  # phase 20 (c): this rank's sink fails at this block
EXCHANGES = 200  # phase 20 (a): health exchanges timed back to back


def rank_rounds(rank: int, port, mesh, key: str, saved: dict, x, y) -> None:
    """One rank's share of phase 20 on ``mesh`` (see the module docstring):
    the main path in blocks of ``CHUNK16`` with health rounds every
    dispatch, an untargeted ``set_sos``, an insert at block 2, a
    width-changing insert that breaks the downstream resampler's shape
    rule, and the abort that ``ABORT_RANK``'s sink starts. ``y`` is phase
    16's output of the same pipe."""
    from pipe_tpu_torch import kernels
    from pipe_tpu_torch.parallel import mesh as mesh_mod

    k = f"{key}/p20"
    mesh.reset_stats()
    kernels.reset_counts()
    ya, wall, p = run_mesh_pipe(port, mesh, main_path_ops, x, CHUNK16, every=1)
    saved[f"{k}/a/equal"] = bool(np.array_equal(ya, y))
    saved[f"{k}/a/launches"] = kernels.launch_counts()["iir_tiles"]
    saved[f"{k}/a/sweeps"] = p.block_index()
    saved[f"{k}/a/health"] = list(mesh.stats.get("health", [0, 0]))
    saved[f"{k}/a/health_s"] = mesh.seconds.get("health", 0.0)
    saved[f"{k}/a/wall"] = wall
    # the exchange alone: a round inside a stream also waits for the
    # slowest rank to reach it; back to back the ranks arrive together
    times = []
    for _ in range(EXCHANGES):
        t0 = time.perf_counter()
        mesh.health_allgather(np.zeros(2, np.int32))
        times.append(time.perf_counter() - t0)
    saved[f"{k}/a/exchange_s"] = float(np.median(times))

    # pushed on every rank before the feed opens: every rank holds it at
    # the first round (block 1), which targets the round after (block 2)
    yb, _, _ = run_mesh_pipe(port, mesh, main_path_ops, x, CHUNK16, every=1,
                             before=lambda p, ops: p.push(
                                 ops[2].set_sos(eq_sos(-3.0)[0])))
    saved[f"{k}/b/sha"] = digest(yb)
    saved[f"{k}/b/first"] = first_change(y, yb)

    handles = []
    kernels.reset_counts()
    yd, _, _ = run_mesh_pipe(port, mesh, main_path_ops, x, CHUNK16, every=1,
                             before=inserter(handles))
    saved[f"{k}/d/launches"] = kernels.launch_counts()["iir_tiles"]
    saved[f"{k}/d/error"] = repr(handle_error(handles[0]))
    saved[f"{k}/d/sha"] = digest(yd)
    saved[f"{k}/d/first"] = first_change(y, yd)
    if rank == 0:
        saved[f"{k}/d/y"] = yd

    handles = []
    ye, _, _ = run_mesh_pipe(
        port, mesh, main_path_ops, x, CHUNK16, every=1,
        before=inserter(handles, pos=0,
                        make=lambda sh: sh.Resample(SR_OUT, SR_IN, 32)))
    err = handle_error(handles[0])
    saved[f"{k}/e/error"] = [type(err).__name__, str(err)]
    saved[f"{k}/e/equal"] = bool(np.array_equal(ye, y))

    saved[f"{k}/c/group_timeout"] = mesh_mod.GROUP_TIMEOUT_S
    t0 = time.perf_counter()
    try:
        run_mesh_pipe(port, mesh, main_path_ops, x, CHUNK16, every=1,
                      out=FailingSink(ABORT_AT if rank == ABORT_RANK else None))
        saved[f"{k}/c/error"] = ["", "", ""]
    except Exception as e:  # noqa: BLE001 - held to the contract by the parent
        cause = e.__cause__
        saved[f"{k}/c/error"] = [type(e).__name__, str(e),
                                 type(cause).__name__ if cause else ""]
    saved[f"{k}/c/wall"] = time.perf_counter() - t0


def check_rounds(ranks, key: str, y_ins, push_sha: list) -> dict:
    """Phase 20 on one mesh, from what the ranks saved in
    :func:`rank_rounds`; ``y_ins`` is the parent's 1x1 ``Pipe(mesh=)`` with
    the same insert, ``push_sha`` every rank's digest of phase 16's
    targeted push."""
    from pipe_tpu_torch.signal import snr_db

    k, world = f"{key}/p20", len(ranks)
    out_width = CHUNK16 * 160 // 147
    rounds = rounds_predicted(CHUNKS16, 1)
    # a round after each block, then one no-op sweep pads to the closing
    # round; every sweep launches iir_tiles 2 a section
    sweeps = CHUNKS16 + 1
    want = 2 * 2 * sweeps
    res = {"rounds": rounds}
    for i, r in enumerate(ranks):
        require(bool(r[f"{k}/a/equal"]), f"{k} (a), rank {i}: the output with a "
                                         "round every dispatch differs from phase 16's")
        require(int(r[f"{k}/a/launches"]) == want
                and int(r[f"{k}/a/sweeps"]) == sweeps,
                f"{k} (a), rank {i}: iir_tiles {r[f'{k}/a/launches']} in "
                f"{r[f'{k}/a/sweeps']} sweeps, expected {want} in {sweeps}")
        health = [int(v) for v in r[f"{k}/a/health"]]
        require(health == [rounds, rounds * world * 2 * 4],
                f"{k} (a), rank {i}: health rounds [calls, bytes] {health}, "
                f"predicted {rounds}")
        require(str(r[f"{k}/b/sha"]) == str(push_sha[i])
                and int(r[f"{k}/b/first"]) == SURGERY_AT * out_width,
                f"{k} (b), rank {i}: the untargeted push first changed sample "
                f"{r[f'{k}/b/first']}, or its output differs from the targeted "
                "push at block 2")
        require(str(r[f"{k}/d/error"]) == "None"
                and int(r[f"{k}/d/first"]) == SURGERY_AT * out_width
                and int(r[f"{k}/d/launches"]) == want + 2 * (sweeps - SURGERY_AT),
                f"{k} (d), rank {i}: insert {r[f'{k}/d/error']}, first changed "
                f"sample {r[f'{k}/d/first']}, iir_tiles {r[f'{k}/d/launches']}")
        err = [str(v) for v in r[f"{k}/e/error"]]
        require(err[0] == "ValueError" and "shape rule" in err[1]
                and bool(r[f"{k}/e/equal"]),
                f"{k} (e), rank {i}: {err}; output equal to the plain run: "
                f"{bool(r[f'{k}/e/equal'])}")
        err = [str(v) for v in r[f"{k}/c/error"]]
        wall = float(r[f"{k}/c/wall"])
        require(float(r[f"{k}/c/group_timeout"]) == 60.0 and wall < 15.0,
                f"{k} (c), rank {i}: wait ended after {wall:.2f} s")
        if i == ABORT_RANK:
            require(err[0] == "RunError" and "sink failed" in err[1],
                    f"{k} (c), rank {i}: {err}")
        else:
            require(err[0] == "RunError" and err[2] == "PeerAbortError",
                    f"{k} (c), rank {i}: {err}")
    require(len({str(r[f"{k}/d/sha"]) for r in ranks}) == 1,
            f"{k} (d): the ranks' outputs differ")
    yd = ranks[0][f"{k}/d/y"]
    res["insert_db"] = float(snr_db(y_ins, yd))
    require(yd.shape == y_ins.shape and res["insert_db"] >= 100,
            f"{k} (d): vs the 1x1 Pipe(mesh=) with the same insert "
            f"{res['insert_db']:.1f} dB")
    res["launches"] = int(ranks[0][f"{k}/a/launches"])
    res["insert_launches"] = int(ranks[0][f"{k}/d/launches"])
    res["sweeps"] = int(ranks[0][f"{k}/a/sweeps"])
    res["round_us"] = [1e6 * float(r[f"{k}/a/health_s"]) / rounds for r in ranks]
    res["exchange_us"] = [1e6 * float(r[f"{k}/a/exchange_s"]) for r in ranks]
    res["wall"] = max(float(r[f"{k}/a/wall"]) for r in ranks)
    res["abort_s"] = [float(r[f"{k}/c/wall"]) for r in ranks]
    res["refusal"] = str(ranks[0][f"{k}/e/error"][1])
    return res


def digest(y) -> str:
    import hashlib

    return hashlib.sha1(np.ascontiguousarray(y).tobytes()).hexdigest()


def rounds_predicted(n_blocks: int, every: int) -> int:
    """Health rounds of a stream of ``n_blocks`` dispatches that ends
    cleanly: one at every multiple of ``every`` it dispatches, then one
    after the no-op sweeps that pad the end of the stream to the next
    multiple (:mod:`pipe_tpu_torch.parallel.hostsync`)."""
    return n_blocks // every + 1


def check_rank_pipes(ranks, key: str, per_sweep: int, n_samples: int,
                     chunks: int, push_first=None) -> dict:
    """What every rank saved in :func:`rank_pipe`, held to the contract.
    Every sweep of a mesh pipe computes a block and makes the collectives
    of one chunk of the chain, the no-op sweeps that pad the stream's end
    to its last health round too: ``iir_tiles`` is launched ``per_sweep``
    times a sweep, the run's data collectives are the chain's run's, by
    name, calls and bytes, times ``sweeps / chunks``, and the health rounds
    are counted apart."""
    world = len(ranks)
    for i, r in enumerate(ranks):
        sweeps = int(r[f"{key}/sweeps"])
        require(bool(r[f"{key}/equal"]),
                f"{key}, rank {i}: the sink's output differs from the chain's")
        require(int(r[f"{key}/launches"]) == per_sweep * sweeps
                and int(r[f"{key}/sections"]) == 0,
                f"{key}, rank {i}: iir_tiles launched {r[f'{key}/launches']} "
                f"times in {sweeps} sweeps, expected {per_sweep} a sweep")
        chain = json.loads(str(r[f"{key}/chain_comm"]))
        comm = json.loads(str(r[f"{key}/comm"]))
        want = {k: [c * sweeps // chunks, b * sweeps // chunks]
                for k, (c, b) in chain.items()}
        want["health"] = [1, world * 2 * 4]
        require(sweeps == chunks + 1 and comm == want
                and all(c % chunks == 0 and b % chunks == 0
                        for c, b in chain.values()),
                f"{key}, rank {i}: collectives {comm} in {sweeps} sweeps, the "
                f"chain's run made {chain} in {chunks} chunks")
    out = {"launches": [int(r[f"{key}/launches"]) for r in ranks],
           "comm": json.loads(str(ranks[0][f"{key}/comm"])),
           "sweeps": int(ranks[0][f"{key}/sweeps"]),
           "wall": max(float(r[f"{key}/wall"]) for r in ranks),
           "comm_seconds": [float(r[f"{key}/comm_seconds"]) for r in ranks]}
    out["rate"] = n_samples / out["wall"]
    if push_first is not None:
        require(len({str(r[f"{key}/push_sha"]) for r in ranks}) == 1,
                f"{key}: the pushed run differs across ranks")
        firsts = [int(r[f"{key}/push_first"]) for r in ranks]
        require(firsts == [push_first] * len(ranks),
                f"{key}: the push landed at {firsts}, expected {push_first}")
        out["push_first"] = push_first
    return out


def rank_extra(rank: int, mesh, key: str, saved: dict, port) -> None:
    """One rank's share of phase 16's second half on ``mesh``: config 4's
    chain, the same line through ``Pipe(mesh=)``, and phase 18's two chains.
    Rank 0 keeps the gathered outputs, every rank their digests, launch
    counts, collectives and carries."""
    from pipe_tpu_torch import kernels, parallel
    from pipe_tpu_torch.convert import tree_to_numpy

    def keep(name, y):
        saved[f"{key}/{name}/sha"] = digest(y)
        if rank == 0:
            saved[f"{key}/{name}/y"] = y

    x = pad_to(input4(), CHUNK4S)
    run_chain(parallel.ShardedChain(mesh, config4_stages(parallel), C4, CHUNK4S),
              x[:, :CHUNK4S], CHUNK4S)  # warm-up
    chain = parallel.ShardedChain(mesh, config4_stages(parallel), C4, CHUNK4S)
    mesh.reset_stats()
    kernels.reset_counts()
    y, wall = run_chain(chain, x, CHUNK4S)
    keep("c4", y)
    saved[f"{key}/c4/launches"] = kernels.launch_counts()["iir_tiles"]
    saved[f"{key}/c4/sections"] = kernels.launch_counts()["biquad_section"]
    saved[f"{key}/c4/wall"] = wall
    saved[f"{key}/c4/a2a_last"] = list(chain.last_comm[0].get("all_to_all", [0, 0]))
    saved[f"{key}/c4/ols_comm"] = sorted(chain.last_comm[0])
    saved[f"{key}/c4/a2a_run"] = list(mesh.stats.get("all_to_all", [0, 0]))
    saved[f"{key}/c4/comm_seconds"] = sum(mesh.seconds.values())
    chain_comm = {k: list(v) for k, v in mesh.stats.items()}
    local = tree_to_numpy(chain.carries)
    saved[f"{key}/c4/zfdl_local_shape"] = local[0]["zfdl"].shape
    for name in ("x_tail", "s"):  # replicated over the time axis
        saved[f"{key}/c4/{name}"] = local[1][name]
    glob = chain.global_carries()  # a collective: every rank calls it
    if rank == 0:
        saved[f"{key}/c4/zfdl"] = glob[0]["zfdl"]
    parts = step_parts_ms(chain, x, CHUNK4S, 6)  # collectives: every rank
    saved[f"{key}/c4/parts"] = [f"{k} {v:.3f}" for k, v in parts.items()]
    rank_pipe(port, mesh, f"{key}/c4/pipe", saved, config4_ops, x, CHUNK4S, y,
              chain_comm)

    for name, (make, (C, chunk, chunks)) in CHAINS18.items():
        stages, _, x18 = make()
        run_chain(parallel.ShardedChain(mesh, stages(parallel), C, chunk),
                  x18[:, :chunk], chunk)  # warm-up
        chain = parallel.ShardedChain(mesh, stages(parallel), C, chunk)
        mesh.reset_stats()
        y, wall = run_chain(chain, x18, chunk)
        keep(name, y)
        saved[f"{key}/{name}/wall"] = wall
        saved[f"{key}/{name}/comm_calls"] = sum(v[0] for v in mesh.stats.values())
        if name == "effects":
            require(chain.stages[1]._wave, f"mesh {key}: the delay is a wave-DAG")
            saved[f"{key}/effects/delay_shifts"] = chain.last_comm[1].get(
                "send_recv", [0, 0])[0]


def check_ranks_extra(ranks, key, mesh_shape, x4, y_ref4, zfdl_ref, streamed):
    """Phase 16's second half on one mesh, from what the ranks saved."""
    from pipe_tpu_torch.signal import snr_db

    c, t = mesh_shape
    chunks = x4.shape[1] // CHUNK4S
    out = {}

    def gathered(name):
        shas = {str(r[f"{key}/{name}/sha"]) for r in ranks}
        require(len(shas) == 1, f"mesh {key}, {name}: the ranks gathered "
                                "different outputs")
        return ranks[0][f"{key}/{name}/y"]

    y = gathered("c4")
    require(y.shape == y_ref4.shape and np.isfinite(y).all(),
            f"mesh {key}: config 4 output {y.shape}")
    db = float(snr_db(y_ref4, y))
    require(db >= 100, f"mesh {key}: config 4 vs the 1x1 chain {db:.1f} dB")
    launches = [int(r[f"{key}/c4/launches"]) for r in ranks]
    require(launches == [2 * chunks] * len(ranks),
            f"mesh {key}: config 4 iir_tiles launches per rank {launches}, "
            f"expected {2 * chunks}")
    require(all(int(r[f"{key}/c4/sections"]) == 0 for r in ranks),
            f"mesh {key}: config 4 launched the one-section kernel")
    n_local, c_local = CHUNK4S // t, C4 // c
    bs = -(-(n_local + 1) // t)
    a2a_bytes = t * 2 * c_local * bs * 4
    K = 65536 // n_local
    for i, r in enumerate(ranks):
        require([int(v) for v in r[f"{key}/c4/a2a_last"]] == [2, 2 * a2a_bytes]
                and [str(v) for v in r[f"{key}/c4/ols_comm"]] == ["all_to_all"],
                f"mesh {key}, rank {i}: the OLS stage's collectives a chunk "
                f"{r[f'{key}/c4/ols_comm']} {r[f'{key}/c4/a2a_last']}, expected "
                f"2 all_to_all of {a2a_bytes} bytes")
        require([int(v) for v in r[f"{key}/c4/a2a_run"]]
                == [2 * chunks, 2 * chunks * a2a_bytes],
                f"mesh {key}, rank {i}: all_to_all over the run "
                f"{r[f'{key}/c4/a2a_run']}")
        require(tuple(int(v) for v in r[f"{key}/c4/zfdl_local_shape"])
                == (K, 2, c_local, bs),
                f"mesh {key}, rank {i}: local delay line "
                f"{r[f'{key}/c4/zfdl_local_shape']}")
    rows = {}
    for i, r in enumerate(ranks):
        rows.setdefault(i // t, []).append(r)
    for row in rows.values():
        for other in row[1:]:
            for name in ("x_tail", "s"):
                require(np.array_equal(row[0][f"{key}/c4/{name}"],
                                       other[f"{key}/c4/{name}"]),
                        f"mesh {key}: config 4's {name} differs inside a row")
    out["c4"] = {"db": db, "launches": launches, "a2a": [2, 2 * a2a_bytes],
                 "wall": max(float(r[f"{key}/c4/wall"]) for r in ranks),
                 "comm_seconds": [float(r[f"{key}/c4/comm_seconds"])
                                  for r in ranks]}
    out["c4"]["rate"] = C4 * N4 / out["c4"]["wall"]
    out["c4"]["parts"] = [str(v) for v in ranks[0][f"{key}/c4/parts"]]
    if n_local == B4:  # the reference's partition size: the same delay line
        zfdl = ranks[0][f"{key}/c4/zfdl"][..., : B4 + 1]
        zdb = float(snr_db(zfdl_ref, zfdl))
        require(zfdl.shape == zfdl_ref.shape and zdb >= 100,
                f"mesh {key}: the gathered delay line vs the 1x1 chain's "
                f"{zdb:.1f} dB")
        out["c4"]["zfdl_db"] = zdb
    for name, want in streamed.items():
        y = gathered(name)
        require(y.shape == want.shape and np.isfinite(y).all(),
                f"mesh {key}, {name}: output {y.shape}")
        db = float(snr_db(want, y))
        require(db >= 100, f"mesh {key}, {name} vs the streaming ops on the "
                           f"CPU {db:.1f} dB")
        out[name] = {"db": db,
                     "wall": max(float(r[f"{key}/{name}/wall"]) for r in ranks),
                     "comm_calls": int(ranks[0][f"{key}/{name}/comm_calls"])}
    out["effects"]["delay_shifts"] = [int(r[f"{key}/effects/delay_shifts"])
                                      for r in ranks]
    return out


def check_four_ranks(dev, count: int) -> dict:
    """Phase 16 (see the module docstring)."""
    import socket
    import tempfile

    from pipe_tpu_torch import kernels, parallel
    from pipe_tpu_torch.signal import snr_db

    world = 4
    transport = "nccl" if count >= world else "gloo+host"
    x = input16()
    ref_chain = parallel.ShardedChain(parallel.make_mesh(1, 1),
                                      main_path_stages(parallel), CHANNELS, CHUNK16)
    run_chain(parallel.ShardedChain(parallel.make_mesh(1, 1),
                                    main_path_stages(parallel), CHANNELS,
                                    CHUNK16), x[:, :CHUNK16], CHUNK16)  # warm-up
    y_ref, ref_wall = run_chain(ref_chain, x, CHUNK16)
    # config 4's reference: one rank at chunks of 8192, the partition size
    # of the 1x4 mesh, so that its delay line is comparable with that mesh's
    x4 = pad_to(input4(), CHUNK4S)
    ref4 = parallel.ShardedChain(parallel.make_mesh(1, 1),
                                 config4_stages(parallel), C4, B4)
    run_chain(parallel.ShardedChain(parallel.make_mesh(1, 1),
                                    config4_stages(parallel), C4, B4),
              x4[:, : 2 * B4], B4)  # warm-up
    y_ref4, ref4_wall = run_chain(ref4, x4, B4)
    zfdl_ref = ref4.global_carries()[0]["zfdl"]
    port = import_port()
    streamed = {name: streamed18(port, name) for name in CHAINS18}
    # phase 20 (d)'s reference: the same insert at the same sample on one rank
    handles = []
    y_ins, _, _ = run_mesh_pipe(port, parallel.make_mesh(1, 1), main_path_ops,
                                x, CHUNK16, before=inserter(handles))
    require(handle_error(handles[0]) is None,
            f"the 1x1 insert failed: {handles[0].error!r}")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port_no = sock.getsockname()[1]
    res = {"transport": transport, "ref_rate": x.size / ref_wall, "meshes": {}}
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), "--rank", str(r),
             str(world), str(port_no), transport, tmp]) for r in range(world)]
        try:
            deadline = time.monotonic() + 420
            for r, p in enumerate(procs):
                rc = p.wait(max(1.0, deadline - time.monotonic()))
                require(rc == 0, f"rank {r} exited with code {rc}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        ranks = [dict(np.load(Path(tmp) / f"rank{r}.npz")) for r in range(world)]
    res["ref4_rate"] = x4.size / ref4_wall
    res["extra"] = {f"{c}x{t}": check_ranks_extra(
        ranks, f"{c}x{t}", (c, t), x4, y_ref4, zfdl_ref, streamed)
        for c, t in MESHES16}
    want = 2 * 2 * CHUNKS16
    for c, t in MESHES16:
        key = f"{c}x{t}"
        launches = [int(r[f"{key}/launches"]) for r in ranks]
        require(launches == [want] * world,
                f"mesh {key}: iir_tiles launches per rank {launches}, expected {want}")
        require(all(int(r[f"{key}/sections"]) == 0 for r in ranks),
                f"mesh {key}: the one-section kernel was launched")
        y = ranks[0][f"{key}/y"]
        require(y.shape == y_ref.shape and np.isfinite(y).all(),
                f"mesh {key}: output {y.shape}")
        require(all(np.array_equal(r[f"{key}/y"], y) for r in ranks[1:]),
                f"mesh {key}: the ranks gathered different outputs")
        db = float(snr_db(y_ref, y))
        require(db >= 100, f"mesh {key} vs the 1x1 chain {db:.1f} dB")
        rows = {}
        for r in ranks:
            rows.setdefault(int(r[f"{key}/position"][0]), []).append(r)
        n_carries = sum(1 for k in ranks[0] if k.startswith(f"{key}/carry"))
        for row in rows.values():
            for other in row[1:]:
                for i in range(n_carries):
                    require(np.array_equal(row[0][f"{key}/carry{i}"],
                                           other[f"{key}/carry{i}"]),
                            f"mesh {key}: carry {i} differs inside a channel row")
        res.setdefault("pipes", {})[key] = {
            "main": check_rank_pipes(ranks, f"{key}/pipe", 2 * 2, x.size,
                                     CHUNKS16,
                                     push_first=2 * (CHUNK16 * 160 // 147)),
            "c4": check_rank_pipes(ranks, f"{key}/c4/pipe", 2, C4 * N4,
                                   x4.shape[1] // CHUNK4S)}
        res.setdefault("rounds", {})[key] = check_rounds(
            ranks, key, y_ins, [r[f"{key}/pipe/push_sha"] for r in ranks])
        wall = max(float(r[f"{key}/wall"]) for r in ranks)
        res["meshes"][key] = {"launches": launches, "db": db, "wall": wall,
                               "rate": x.size / wall, "carries": n_carries,
                               "comm_calls": int(ranks[0][f"{key}/comm_calls"]),
                               "comm_bytes": int(ranks[0][f"{key}/comm_bytes"]),
                               "comm_seconds": [float(r[f"{key}/comm_seconds"])
                                                for r in ranks]}
    return res


def say_four_ranks(s16: dict, card: str) -> None:
    say(16, f"transport: {s16['transport']}; four ranks, {CHANNELS} ch, "
            f"{CHUNKS16} chunks of {CHUNK16}: " + "; ".join(
                f"mesh {k}: iir_tiles launches per rank {v['launches']}, vs the "
                f"1x1 chain {v['db']:.1f} dB, {v['carries']} carries equal "
                f"inside each channel row, {v['wall']:.4f} s wall = "
                f"{v['rate']:.4g} samples/s, rank 0 made {v['comm_calls']} "
                f"collective calls moving {v['comm_bytes']} bytes, host seconds "
                f"inside collectives per rank (waiting for peers included) "
                + "/".join(f"{t:.4f}" for t in v["comm_seconds"])
                for k, v in s16["meshes"].items())
        + f"; the 1x1 chain at the same chunk in one process "
          f"{s16['ref_rate']:.4g} samples/s; on {card}")
    for k, v in s16["extra"].items():
        c4 = v["c4"]
        say(16, f"mesh {k}, config 4 ({C4} ch, chunks of {CHUNK4S}): vs the 1x1 "
                f"chain at chunks of {B4} {c4['db']:.1f} dB"
                + (f", gathered delay line {c4['zfdl_db']:.1f} dB"
                   if "zfdl_db" in c4 else "")
                + f", iir_tiles launches per rank {c4['launches']}, OLS stage "
                  f"all_to_all a chunk and rank [calls, bytes] {c4['a2a']}, "
                  f"{c4['wall']:.4f} s wall = {c4['rate']:.4g} samples/s (1x1 at "
                  f"chunks of {B4}: {s16['ref4_rate']:.4g}), host seconds inside "
                  "collectives per rank "
                + "/".join(f"{t:.4f}" for t in c4["comm_seconds"])
                + "; rank 0's ms a chunk by part of the step, each "
                  "synchronized: " + ", ".join(c4["parts"])
                + "; " + "; ".join(
                    f"{n} vs the streaming ops on the CPU {v[n]['db']:.1f} dB, "
                    f"{v[n]['wall']:.4f} s wall, rank 0 made "
                    f"{v[n]['comm_calls']} collective calls"
                    for n in CHAINS18)
                + f"; the wave-DAG delay's shifts a chunk per rank "
                  f"{v['effects']['delay_shifts']}; on {card}")
    for k, v in s16["pipes"].items():
        m, c4 = v["main"], v["c4"]
        say(16, f"mesh {k}, the same lines through Pipe(mesh=) on every rank: "
                f"main path in blocks of {CHUNK16}: the sink equals the chain's "
                f"gathered output bit for bit on all 4 ranks, iir_tiles launches "
                f"per rank {m['launches']}, collectives of the run [calls, "
                f"bytes] {m['comm']} in {m['sweeps']} sweeps (the chain's "
                f"per chunk, its gather included, for each sweep, and the "
                f"round), {m['wall']:.4f} s wall = {m['rate']:.4g} "
                f"samples/s (the chain {s16['meshes'][k]['rate']:.4g}), host "
                "seconds inside collectives per rank "
                + "/".join(f"{t:.4f}" for t in m["comm_seconds"])
                + f", the set_sos pushed at_block=2 first changes sample "
                  f"{m['push_first']} on every rank; config 4 (sharded.OLS -> "
                  f"sharded.Biquad) in blocks of {CHUNK4S}: equal to the chain "
                  f"bit for bit, iir_tiles launches per rank {c4['launches']}, "
                  f"collectives {c4['comm']}, {c4['wall']:.4f} s wall = "
                  f"{c4['rate']:.4g} samples/s (the chain "
                  f"{s16['extra'][k]['c4']['rate']:.4g}), host seconds inside "
                  "collectives per rank "
                + "/".join(f"{t:.4f}" for t in c4["comm_seconds"])
                + f"; on {card}")
    for k, v in s16["rounds"].items():
        m = s16["pipes"][k]["main"]
        say(20, f"mesh {k}, transport {s16['transport']}, main path in "
                f"{CHUNKS16} blocks of {CHUNK16}: (a) host_sync_every=1: "
                f"{v['rounds']} health rounds a rank as predicted, output equal "
                f"to phase 16's bit for bit, iir_tiles {v['launches']} a rank, "
                f"{v['sweeps']} sweeps, us per round per rank (the wait for "
                f"the slowest rank included) "
                + "/".join(f"{u:.1f}" for u in v["round_us"])
                + f", the exchange alone back to back (median of {EXCHANGES}) "
                + "/".join(f"{u:.1f}" for u in v["exchange_us"])
                + f", {v['wall']:.4f} s wall = {CHUNKS16 * CHUNK16 * CHANNELS / v['wall']:.4g} "
                  f"samples/s (one round at the end: {m['rate']:.4g}); (b) an "
                  f"untargeted set_sos landed on block {SURGERY_AT} on every rank, "
                  f"equal to the targeted push there bit for bit; (c) rank "
                  f"{ABORT_RANK}'s sink failed at block {ABORT_AT}: every rank's "
                  f"wait raised (peers: RunError from PeerAbortError) after "
                  + "/".join(f"{t:.3f}" for t in v["abort_s"])
                + f" s, group timeout 60 s; (d) a sharded.Biquad inserted "
                  f"at_block={SURGERY_AT}: first change at sample "
                  f"{SURGERY_AT * (CHUNK16 * 160 // 147)} on every rank, ranks "
                  f"equal, iir_tiles {v['insert_launches']} a rank, vs the 1x1 "
                  f"Pipe(mesh=) {v['insert_db']:.1f} dB; (e) a Resample inserted "
                  f"at the head refused: {v['refusal'][:90]}..., output equal to "
                  f"the plain run; on {card}")


def main(only_four_ranks: bool = False) -> None:
    """Every phase; with ``only_four_ranks`` (``--four-ranks``, for a machine
    with four cards) phases 1, 2 and 4 and then phases 16 and 20 alone."""
    import torch

    say(1, f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this smoke test runs only on the card")
    dev = torch.device("cuda", 0)
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    port = import_port()
    say(1, f"cuda ok: {name} (count {count}); port from {HERE}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    say(2, f"card: {card}")

    from pipe_tpu_torch import config, kernels
    from pipe_tpu_torch.signal import snr_db

    if only_four_ranks:
        kernels.build()
        say_four_ranks(check_four_ranks(dev, count), card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name, "count": count}}), flush=True)
        return

    require(config.fp32_pinned(), "IEEE FP32 pinned for cuBLAS and cuDNN")
    rng = np.random.default_rng(0)
    a = rng.standard_normal((16, 128, 300)).astype(np.float32)
    w = rng.standard_normal((128, 128, 3)).astype(np.float32)
    conv = torch.nn.functional.conv1d(torch.from_numpy(a).to(dev),
                                      torch.from_numpy(w).to(dev)).cpu().numpy()
    ref = torch.nn.functional.conv1d(torch.from_numpy(a).double(),
                                     torch.from_numpy(w).double()).numpy()
    conv_db = snr_db(ref, conv)
    require(conv_db >= 100, f"float32 conv on the card vs float64: {conv_db:.1f} dB")
    n_fixed = check_knob_on_plain_biquad(dev)
    say(3, f"fp32 pinned (matmul {config.matmul_precision()}); "
           f"card conv1d vs float64 {conv_db:.1f} dB; the biquad's {n_fixed} "
           f"plain paths give the same bits under {PRECISIONS}")

    t0 = time.perf_counter()
    lib = kernels.build()
    say(4, f"built {lib.relative_to(HERE)} in {time.perf_counter() - t0:.2f} s")

    kres, sres = {}, {}
    for i, shape in enumerate(KERNEL_SHAPES):
        kres[shape] = check_kernel(dev, shape, seed=10 + i)
        sres[shape] = check_section(dev, shape, seed=20 + i)
        for what, r in (("iir_tiles", kres[shape]),
                        ("biquad_section", sres[shape])):
            say(5, "{} {}x{} (both EQ sections): vs plain {} dB, vs float64 "
                   "{} dB, max abs err {:.3g}; {:.4f} ms a call back to back, "
                   "{:.4f} ms on the device alone (CUDA graph), plain {:.4f} "
                   "ms, bound {:.5f} ms ({}){}; on {}".format(
                       what, *shape, r["snr_plain_db"], r["snr_f64_db"],
                       r["max_abs_err"], r["ms"], r["device_ms"],
                       r["plain_ms"], r["bound_ms"], r["bound_by"],
                       f", new s vs plain {min(r['snr_state_db'])} dB at least"
                       if "snr_state_db" in r else "", card))
    for i, shape in enumerate(SHARDED_SHAPES):
        kres[shape] = r = check_kernel(dev, shape, seed=40 + i)
        say(5, "iir_tiles {}x{} (a sharded chain's local block, both EQ "
               "sections): vs plain {} dB, vs float64 {} dB, max abs err "
               "{:.3g}; {:.4f} ms a call back to back, {:.4f} ms on the device "
               "alone (CUDA graph), plain {:.4f} ms, bound {:.5f} ms ({}); on "
               "{}".format(*shape, r["snr_plain_db"], r["snr_f64_db"],
                           r["max_abs_err"], r["ms"], r["device_ms"],
                           r["plain_ms"], r["bound_ms"], r["bound_by"], card))

    fres = check_flagship(dev)
    say(6, "flagship 64ch x 4 chunks of 9408: " + ", ".join(
        f"{k} {v:.1f} dB" for k, v in fres.items()))

    x = np.random.default_rng(3).standard_normal(
        (CHANNELS, SR_IN * SECONDS)).astype(np.float32)
    stream_res = check_streamed_recurrence(dev, x)
    say(5, f"recurrence streamed through _iir_apply, {stream_res['blocks']} "
           f"blocks of ({CHANNELS}, 10240) with carried state: iir_tiles "
           f"launches {stream_res['launches']}, vs float64 lfilter "
           f"{stream_res['f64_db']:.1f} dB")

    require(port.default_device() == dev, "the port's default device is the card")
    run_slice(port, x[:, : 2 * BLOCK])  # warm-up (library, cuDNN plans)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_card, blocks = run_slice(port, x)  # no device given: the default
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    n_out = SR_IN * SECONDS * 160 // 147
    require(y_card.shape == (2, n_out), f"slice output {y_card.shape} != (2, {n_out})")
    require(np.isfinite(y_card).all(), "slice output finite")
    require(blocks == 47, f"{blocks} blocks dispatched, expected 47")
    require(launches["biquad_section"] == 2 * blocks,
            f"biquad_section launched {launches['biquad_section']} times for "
            f"{blocks} blocks")
    require(launches["iir_tiles"] == 0,
            "the slice launched the recurrence kernel outside a section")
    y_cpu, _ = run_slice(port, x, torch.device("cpu"))
    cpu_db = snr_db(y_cpu, y_card)
    require(cpu_db >= 100, f"slice card vs CPU port {cpu_db:.1f} dB")
    oracle7 = slice_oracle(x)
    f64_db = snr_db(oracle7, y_card)
    require(f64_db >= 100, f"slice card vs float64 oracle {f64_db:.1f} dB")
    rate = CHANNELS * SR_IN * SECONDS / wall
    sprof = device_profile(lambda: run_slice(port, x[:, : 10 * BLOCK]), 10)
    idle = 1.0 - sprof["device_ms"] / 10 / (1e3 * wall / blocks)
    say(7, f"slice {CHANNELS}ch x {SECONDS}s @ {SR_IN} Hz, block {BLOCK}: "
           f"{blocks} blocks, out {y_card.shape}, biquad_section launches "
           f"{launches['biquad_section']}, vs CPU port {cpu_db:.1f} dB, vs float64 "
           f"{f64_db:.1f} dB, {wall:.3f} s wall = {rate:.4g} samples/s "
           f"({SECONDS / wall:.1f}x real time); profile of 10 blocks: device "
           f"{sprof['device_ms']:.3f} ms, "
           + ", ".join(f"{k} {v:.3f} ms ({100 * sprof['share'][k]:.1f} %)"
                       for k, v in sprof["ms"].items())
           + f", biquad kernels us each {sprof['biquad_us']}"
           + f", {sprof['launches_per_block']:.1f} launches/block, device idle "
             f"{100 * idle:.1f} % of the unprofiled wall a block; on {card}")

    pres = check_pipe_slice(port, dev, x)
    la_rates = ", ".join(f"{k}: " + " / ".join(f"{r:.4g}" for r in v)
                         for k, v in pres["rates"].items())
    say(8, f"slice through Pipe(lookahead=4) with live retune@{RETUNE_AT}, "
           f"insert@{INSERT_AT}, add_line after block {ADD_AFTER}: line A "
           f"(2, {SR_IN * SECONDS * 160 // 147}), biquad_section launches per "
           f"thread {pres['launches']}, vs CPU port {pres['cpu_db']:.1f} dB "
           f"(line B {pres['cpu_b_db']:.1f} dB), lookahead 4 vs 1 "
           f"{pres['la_db']:.1f} dB (max abs diff {pres['la_diff']:.3g}), "
           f"retune lands at output sample {pres['first']}; scenario wall "
           f"{pres['wall']:.3f} s (CPU {pres['cpu_wall']:.1f} s); plain slice "
           f"through Pipe, samples/s: {la_rates}; on {card}")

    dres = check_dispatch(port, dev)
    say(9, "dispatch: " + ", ".join(f"{k} {v:.1f}" for k, v in dres.items())
        + f"; on {card}")

    x4 = input4()
    c4 = check_config4(port, dev, x4)
    prof = c4["profile"]
    idle4 = 1.0 - prof["device_ms"] / 10 / (1e3 * c4["wall"] / c4["blocks"])
    say(10, f"config 4 {C4}ch x {SECONDS}s, 65536-tap OLS + peaking EQ, "
            f"block {B4}: {c4['blocks']} blocks, out {x4.shape}, biquad_section "
            f"launches {c4['launches']}, vs CPU port {c4['cpu_db']:.1f} dB, "
            f"vs float64 {c4['f64_db']:.1f} dB, {c4['wall']:.4f} s wall = "
            f"{c4['rate']:.4g} samples/s (CPU port {c4['cpu_wall']:.2f} s); "
            f"ols_block ({C4}, {B4}) {c4['ols_ms']:.4f} ms, iir_tiles "
            f"{c4['kernel_ms']:.4f} ms (plain {c4['plain_ms']:.4f} ms, "
            f"{c4['kernel_db']:.1f} dB apart), biquad_section "
            f"{c4['section_ms']:.4f} ms (plain {c4['section_plain_ms']:.4f} ms, "
            f"{c4['section_db']:.1f} dB apart at 6824 frames); "
            f"profile of 10 blocks: device {prof['device_ms']:.3f} ms, "
            + ", ".join(f"{k} {v:.3f} ms ({100 * prof['share'][k]:.1f} %)"
                        for k, v in prof["ms"].items())
            + f", biquad kernels us each {prof['biquad_us']}"
            + f", {prof['launches_per_block']:.1f} launches/block, device idle "
              f"{100 * idle4:.1f} % of the unprofiled wall a block, no eager "
              f"biquad function and no float64 kernel ran; on {card}")

    ores = check_optimizer(port, dev, x4)
    say(11, f"optimizer Pipe(lookahead=4): fused {ores['fused']}; optimized "
            f"vs plain identical {ores['identical']} (no retune), "
            f"{ores['identical+eq']} (EQ retune); landings (EQ, gain) "
            f"optimized {ores['optimized landings']}, plain "
            f"{ores['plain landings']}; launches per run {ores['launches']}; "
            "walls " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                 ores["walls"].items()) + f"; on {card}")

    kit = check_kit(port, dev)
    say(12, "kit card vs CPU port: " + "; ".join(
        f"{k}: {v['db']:.1f} dB, {v['ms']:.1f} ms (CPU {v['cpu_ms']:.1f} ms)"
        + (f", vs float64 {v['f64_db']:.1f} dB, default path "
           f"{v['default_ms']:.1f} ms at {v['default_f64_db']:.1f} dB"
           if "f64_db" in v else "")
        for k, v in kit.items()) + f"; on {card}")

    wres = check_wav(port, x4, c4["y"])
    say(13, f"WAV {C4}ch x {SECONDS}s float32 through WavSource -> OLS + "
            f"peaking EQ -> WavSink, block {B4}, native library built: "
            f"{wres['blocks']} blocks, biquad_section launches "
            f"{wres['launches']}, the file read back equals phase 10's output "
            f"bit for bit, {wres['wall']:.4f} s wall = {wres['rate']:.4g} "
            f"samples/s; on {card}")

    pr = check_precision(port, dev, x, oracle7)
    say(14, "precision (dB vs float64, ms): " + "; ".join(
        f"{what} at ({CHANNELS}, {BLOCK}): " + ", ".join(
            f"{n} {v['db']:.1f} dB {v['ms']:.4f} ms" for n, v in by.items())
        for what, by in pr.items() if what not in ("fixed", "slice"))
        + "; slice (whole run, wall): " + ", ".join(
            f"{n} {v['db']:.1f} dB {v['ms']:.1f} ms"
            for n, v in pr["slice"].items())
        + f"; same bits under every name: {pr['fixed']}; on {card}")

    s15 = check_sharded_one_rank(port, dev)
    say(15, f"ShardedChain 1x1 (no process group), {CHANNELS} ch, FIR(255) -> "
            f"resample -> 2 x BiquadStage -> mix, {CHUNKS15} chunks of "
            f"{CHUNK15}: iir_tiles launches {s15['launches']} (2 passes x 2 "
            f"sections x {CHUNKS15} chunks), vs float64 {s15['f64_db']:.1f} dB, "
            f"vs the streaming slice {s15['stream_db']:.1f} dB, "
            f"{s15['wall']:.4f} s wall = {s15['rate']:.4g} samples/s, "
            f"collectives a chunk {s15['comm']}; profile of one chunk: device "
            f"{s15['profile']['device_ms']:.3f} ms, "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in s15["profile"]["ms"].items())
            + f", {s15['profile']['launches_per_block']:.0f} launches, device "
              f"idle {100 * (1 - s15['profile']['device_ms'] / (1e3 * s15['wall'] / CHUNKS15)):.1f} "
              f"% of the unprofiled wall a chunk; on {card}")

    s16 = check_four_ranks(dev, count)
    say_four_ranks(s16, card)

    s17 = check_config4_sharded(port, dev, x4, c4["y"], c4["oracle"])
    p17 = s17["profile"]
    say(17, f"config 4 through ShardedChain 1x1 (OLSStage partitioned K = 8 -> "
            f"BiquadStage), {C4} ch, {s17['chunks']} chunks of {B4}: iir_tiles "
            f"launches {s17['launches']} (2 a chunk), biquad_section 0, no "
            f"collective, vs phase 10's run {s17['db10']:.1f} dB, vs float64 "
            f"{s17['f64_db']:.1f} dB, {s17['wall']:.4f} s wall = "
            f"{s17['rate']:.4g} samples/s (phase 10's run {c4['rate']:.4g}); "
            f"profile of 10 chunks: device {p17['device_ms']:.3f} ms, "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in p17["ms"].items())
            + f", {p17['launches_per_block']:.1f} launches/chunk, device idle "
              f"{100 * (1 - p17['device_ms'] / 10 / (1e3 * s17['wall'] / s17['chunks'])):.1f} "
              f"% of the unprofiled wall a chunk; ms a chunk by part of the "
              f"step, each synchronized: "
            + ", ".join(f"{k} {v:.3f}" for k, v in s17["parts_ms"].items())
            + f"; on {card}")

    s18 = check_kit_sharded(port, dev)
    say(18, "sharded stages 1x1 vs the streaming ops on the CPU: " + "; ".join(
        f"{k} {v['out']}: {v['db']:.1f} dB, {v['wall']:.4f} s wall = "
        f"{v['rate']:.4g} samples/s" for k, v in s18.items()) + f"; on {card}")

    s19 = check_mesh_pipe_one_rank(port, dev, s15)
    p19 = s19["profile"]
    say(19, f"config 5 through Pipe(mesh=1x1), {CHANNELS} ch, sharded.FIR(255) "
            f"-> Resample -> 2 x Biquad -> Mix, host-fed, {CHUNKS15} blocks of "
            f"{CHUNK15}: equal to phase 15's ShardedChain bit for bit (also fed "
            f"random packet sizes), iir_tiles launches {s19['launches']} "
            f"({s19['launches'] // CHUNKS15} a block), biquad_section 0, vs "
            f"float64 {s19['f64_db']:.1f} dB, set_sos pushed at_block=2 first "
            f"changes sample {s19['first']}, optimize=True: "
            f"{s19['opt_stages']} stages, {s19['opt_db']:.1f} dB from the plain "
            f"run, {s19['opt_rate']:.4g} samples/s; {s19['wall']:.4f} s wall = "
            f"{s19['rate']:.4g} samples/s (phase 15's chain, fed from the host "
            f"too: {s15['rate']:.4g}); profile of one block: device "
            f"{p19['device_ms']:.3f} ms, "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in p19["ms"].items())
            + f", {p19['launches_per_block']:.0f} launches, device idle "
              f"{100 * s19['idle']:.1f} % of the unprofiled wall a block; on {card}")
    s19s = check_mesh_pipe_surgery(port, dev, s15["x"], s19["y"])
    say(19, f"live surgery on Pipe(mesh=1x1): a sharded.Biquad inserted before "
            f"the mix at_block={SURGERY_AT} first changes sample "
            f"{s19s['at_block']['first']}, iir_tiles {s19s['at_block']['launches']}, "
            f"vs the Pipe without a mesh doing the same insert {s19s['db']:.1f} dB "
            f"(its biquad_section {s19s['ref_sections']}); inserted with no "
            f"at_block: landed on block {s19s['untargeted']['landed']}, iir_tiles "
            f"{s19s['untargeted']['launches']}; a line of "
            f"{s19s['add_line']['shape']} added at_block={SURGERY_AT} in the sync "
            f"group equals that line run alone, iir_tiles "
            f"{s19s['add_line']['launches']}; on {card}")

    main_shape = KERNEL_SHAPES[-1]
    section_paths = {"run (phase 7)": launches["biquad_section"],
                     "Pipe line A (phase 8)": pres["launches"]["pipe-exec-line0"],
                     "Pipe line B (phase 8)": pres["launches"]["pipe-exec-line1"],
                     "run config 4 (phase 10)": c4["launches"]}
    section_paths.update({f"Pipe {k} (phase 11)": v
                          for k, v in ores["launches"].items()})
    tiles_paths = {"_iir_apply stream (phase 5)": stream_res["launches"],
                   "ShardedChain 1x1 (phase 15)": s15["launches"]}
    tiles_paths.update({f"ShardedChain {k}, each of 4 ranks (phase 16)":
                        v["launches"][0] for k, v in s16["meshes"].items()})
    tiles_paths.update({f"ShardedChain config 4 {k}, each of 4 ranks (phase 16)":
                        v["c4"]["launches"][0] for k, v in s16["extra"].items()})
    tiles_paths["ShardedChain config 4 1x1 (phase 17)"] = s17["launches"]
    tiles_paths["Pipe(mesh=1x1) config 5 (phase 19)"] = s19["launches"]
    for what in ("at_block", "untargeted"):
        tiles_paths[f"Pipe(mesh=1x1) insert_processor, {what} (phase 19)"] = (
            s19s[what]["launches"])
    tiles_paths["Pipe(mesh=1x1) add_line (phase 19)"] = s19s["add_line"]["launches"]
    section_paths["Pipe without a mesh, phase 19's insert reference"] = (
        s19s["ref_sections"])
    for k, v in s16["pipes"].items():
        tiles_paths[f"Pipe(mesh={k}) main path, each of 4 ranks (phase 16)"] = (
            v["main"]["launches"][0])
        tiles_paths[f"Pipe(mesh={k}) config 4, each of 4 ranks (phase 16)"] = (
            v["c4"]["launches"][0])
    for k, v in s16["rounds"].items():
        tiles_paths[f"Pipe(mesh={k}) rounds every dispatch, each of 4 ranks "
                    "(phase 20 a)"] = v["launches"]
        tiles_paths[f"Pipe(mesh={k}) insert_processor, each of 4 ranks "
                    "(phase 20 d)"] = v["insert_launches"]

    def kernel_entry(name, by_path, results):
        r = results[main_shape]
        require(sum(by_path.values()) > 0, f"{name} was launched on no driven path")
        return {
            "name": name,
            "route": "cuda",
            "source": "pipe_tpu_torch/csrc/iir_tiles.cu",
            "replaces": "pipe_tpu/ops/biquad.py:92",
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(v["max_abs_err"] for v in results.values()),
            "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,  # no single PyTorch call computes either
            "shape": list(main_shape),
            "other_shapes": [
                {k: v[k] for k in ("shape", "max_abs_err", "ms", "device_ms",
                                   "plain_ms", "bound_ms", "bound_by")}
                for shape, v in results.items() if shape != main_shape],
        }

    print(json.dumps({"kernels": [
        kernel_entry("iir_tiles", tiles_paths, kres),
        kernel_entry("biquad_section", section_paths, sres),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":  # a rank of phase 16
        rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                  sys.argv[5], sys.argv[6])
    else:
        main(only_four_ranks=sys.argv[1:] == ["--four-ranks"])

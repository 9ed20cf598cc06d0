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
5. the biquad tile kernel against its plain PyTorch version at
   (8, 4096) and (64, 10240), both EQ sections: >= 110 dB against the
   plain version, >= 90 dB against a float64 recurrence; both timed with
   CUDA events;
6. ``make_flagship(64, 147*64)``, fused and unfused, four chained chunks:
   >= 100 dB against the same chunks run by the port on the CPU, and
   >= 100 dB between fused and unfused;
7. the slice: ``run(9408, Line(host feed of 64 channels x 10 s at 44.1 kHz
   -> FIR(255) -> Resampler(48000, 44100) -> Biquad EQ -> 64->2 mix ->
   host receive))`` on the card: exactly (2, 480000) frames out, >= 100 dB
   against the same line run on the CPU and >= 100 dB against a float64
   scipy oracle of the chain, the kernel launched 4 times per block,
   samples/s printed.

Then one JSON line with each kernel's launches on the main path, error and
times, and last ``{"ok": true, "device": {...}}``. Any failure raises, so
the exit code is non-zero and no result line is printed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

SR_IN, SR_OUT = 44100, 48000
CHANNELS = 64
BLOCK = 147 * 64  # 9408 input frames -> 10240 = 40 * 256 resampled frames
SECONDS = 10
KERNEL_SHAPES = ((8, 4096), (CHANNELS, 10240))


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


def eq_sos():
    """The slice's EQ: a peaking section at 1 kHz and a high shelf at 8 kHz."""
    from pipe_tpu_torch import ops

    return np.stack([ops.design_peaking_eq(SR_OUT, 1000, 1.0, 3.0),
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
    """The kernel against its plain version and float64, for both EQ
    sections' poles; times both at section 0."""
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
    res["ms"] = cuda_ms(lambda: kernels.iir_tiles(v, s, a1, a2), iters=50)
    res["plain_ms"] = cuda_ms(
        lambda: _iir_apply(v, s, a1, a2, force="tiles"), iters=5)
    return res


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


def slice_line(port, x, out: list, fed: list):
    """The slice's line over the host array ``x``: a host feed, FIR(255),
    44.1k->48k resampler, the two-section biquad EQ, a 64->2 mix, and a
    host receive collecting into ``out``. ``fed`` counts fed blocks."""
    from pipe_tpu_torch import ops

    C, N = x.shape
    pos = [0]

    def feed(block_size):
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
            ops.Biquad(eq_sos()).processor(),
            ops.ChannelMix(np.ones((2, C)) / C).processor(),
        ],
        sink=sink,
    )


def run_slice(port, x, device):
    out, fed = [], []
    port.run(BLOCK, slice_line(port, x, out, fed), device=device)
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


def main() -> None:
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
    say(3, f"fp32 pinned (matmul {config.matmul_precision()}); "
           f"card conv1d vs float64 {conv_db:.1f} dB")

    t0 = time.perf_counter()
    lib = kernels.build()
    say(4, f"built {lib.relative_to(HERE)} in {time.perf_counter() - t0:.2f} s")

    kres = {}
    for i, shape in enumerate(KERNEL_SHAPES):
        r = check_kernel(dev, shape, seed=10 + i)
        kres[shape] = r
        say(5, "iir_tiles {}x{} (both EQ sections): vs plain {} dB, vs "
               "float64 {} dB, max abs err {:.3g}; kernel {:.4f} ms, plain "
               "{:.4f} ms".format(*shape, r["snr_plain_db"], r["snr_f64_db"],
                                  r["max_abs_err"], r["ms"], r["plain_ms"]))

    fres = check_flagship(dev)
    say(6, "flagship 64ch x 4 chunks of 9408: " + ", ".join(
        f"{k} {v:.1f} dB" for k, v in fres.items()))

    x = np.random.default_rng(3).standard_normal(
        (CHANNELS, SR_IN * SECONDS)).astype(np.float32)
    run_slice(port, x[:, : 2 * BLOCK], dev)  # warm-up (library, cuDNN plans)
    kernels.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y_card, blocks = run_slice(port, x, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    n_out = SR_IN * SECONDS * 160 // 147
    require(y_card.shape == (2, n_out), f"slice output {y_card.shape} != (2, {n_out})")
    require(np.isfinite(y_card).all(), "slice output finite")
    require(blocks == 47, f"{blocks} blocks dispatched, expected 47")
    require(launches["iir_tiles"] == 4 * blocks,
            f"iir_tiles launched {launches['iir_tiles']} times for {blocks} blocks")
    y_cpu, _ = run_slice(port, x, torch.device("cpu"))
    cpu_db = snr_db(y_cpu, y_card)
    require(cpu_db >= 100, f"slice card vs CPU port {cpu_db:.1f} dB")
    f64_db = snr_db(slice_oracle(x), y_card)
    require(f64_db >= 100, f"slice card vs float64 oracle {f64_db:.1f} dB")
    rate = CHANNELS * SR_IN * SECONDS / wall
    say(7, f"slice {CHANNELS}ch x {SECONDS}s @ {SR_IN} Hz, block {BLOCK}: "
           f"{blocks} blocks, out {y_card.shape}, iir_tiles launches "
           f"{launches['iir_tiles']}, vs CPU port {cpu_db:.1f} dB, vs float64 "
           f"{f64_db:.1f} dB, {wall:.3f} s wall = {rate:.4g} samples/s "
           f"({SECONDS / wall:.1f}x real time) on {card}")

    main_shape = kres[KERNEL_SHAPES[-1]]
    print(json.dumps({"kernels": [{
        "name": "iir_tiles",
        "route": "cuda",
        "source": "pipe_tpu_torch/csrc/iir_tiles.cu",
        "replaces": "pipe_tpu/ops/biquad.py:92",
        "launches": launches["iir_tiles"],
        "max_abs_err": main_shape["max_abs_err"],
        "ms": main_shape["ms"],
        "plain_ms": main_shape["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)


if __name__ == "__main__":
    main()

"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference, and the result line.

A run on the card:

1. draws the input (a cycled buffer of a whole number of blocks) and any
   long filter from the seed on the card, designs the coefficients from the
   seed on the host, and hands the same float32 numbers to the program and
   to the reference;
2. with ``--trace 1``, runs one CPU-only profiler session
   (:func:`portbench.trace.warm`), so that the profiler's first start, which
   takes seconds, is set-up; warms up a pipe of the same line, block and knobs
   (pushes included) and throws it away, so that nothing is built or planned
   inside the window;
3. builds the timed pipe, and from ``Pipe.start()`` drives it for
   ``--seconds`` with the cell's traffic (:mod:`portbench.load`); with
   ``--trace 1`` a thread profiles a bounded stretch of that window
   (:mod:`portbench.trace`);
4. reads the device's memory peak, frees the pipe, and compares the kept
   stretches of the output with the float64 reference (:func:`check`);
5. prints the compared numbers beside their limits as the last lines of
   standard error, and one JSON line as the last line of standard output.

Without a card it fails, unless the CPU rehearsal (``--cpu-rehearsal``, for
the tests) is asked for; that reports the platform ``cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

import portbench
from portbench import load, spec, trace as tracing
from portbench.load import clock

FORBIDDEN = ("jax", "jaxlib", "flax", "pipe_tpu")


@dataclasses.dataclass
class Run:
    """What one run measured, for the metric readers."""

    channels: int
    block_frames: int
    eq_shape: tuple = ()
    setup_s: float = 0.0
    window_s: float = 0.0
    blocks_received: int = 0
    t_fed: list = dataclasses.field(default_factory=list)
    t_recv: list = dataclasses.field(default_factory=list)
    t_end: float = 0.0
    trace: dict | None = None
    trace_blocks: int = 0
    trace_span: tuple = ()  # host times the profiler was on, start to stopped

    def fifths(self) -> list:
        """Blocks received in each fifth of the window: a rate that drifts
        within a run shows here."""
        if not self.t_recv or self.window_s <= 0:
            return []
        t0 = self.t_end - self.window_s
        bins = np.floor((np.array(self.t_recv) - t0) / self.window_s * 5).clip(0, 4)
        return np.bincount(bins.astype(int), minlength=5).tolist()

    def service_s(self):
        lo, hi = self.trace_span or (np.inf, -np.inf)
        n = min(len(self.t_fed), len(self.t_recv))
        return np.array([self.t_recv[k] - self.t_fed[k] for k in range(n)
                         if not lo <= self.t_fed[k] <= hi])


# -- one run ----------------------------------------------------------------------


def _cache_dirs() -> None:
    """Kernel caches of the program live at fixed paths in the checkout."""
    base = spec.ROOT / "build" / "portbench-cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))


def draw_input(cfg: dict, block: int, seed: int, device):
    """The cycled input buffer (C, n) and a ``draw(n)`` of further float64
    noise, both from one generator on ``device`` seeded with the run's seed."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    sig = cfg["signal"]
    n = -(-int(sig["buffer_seconds"] * cfg["sample_rate_hz"]) // block) * block
    x = torch.randn((cfg["channels"], n), generator=gen, device=device) * sig["rms"]

    def draw(m):
        return torch.randn(m, generator=gen, device=device, dtype=torch.float64).cpu().numpy()

    return x.cpu().numpy(), draw


class _Tracer(threading.Thread):
    """Profiles a stretch of ``plan["blocks"]`` blocks of the window from a
    thread of its own: the profiler starts once ``skip_blocks`` were fed,
    the stretch begins at the first block fed after it is on, and it stops
    two blocks past the stretch."""

    def __init__(self, rec: load.Recorder, plan: dict, out_dir):
        super().__init__(name="portbench-tracer", daemon=True)
        self.rec, self.plan, self.cap = rec, plan, tracing.Capture(out_dir)
        self.done = threading.Event()
        self.blocks = None  # (a, b) once captured
        self.span = ()
        self.start_s = None  # how long the profiler's start took in the window
        self.error = None

    def _wait_fed(self, n: int) -> bool:
        while self.rec.n_fed < n:
            if self.done.is_set():
                return False
            time.sleep(0.0005)
        return True

    def run(self):
        try:
            if not self._wait_fed(self.plan["skip_blocks"]):
                return
            on = clock()
            self.cap.start()
            self.start_s = clock() - on
            a = self.rec.n_fed + 1
            b = a + self.plan["blocks"]
            self._wait_fed(a)
            full = self._wait_fed(b)
            self._wait_fed(b + 2)
            self.cap.stop()
            self.span = (on, clock())
            b = b if full else self.rec.n_fed - 1
            if b > a:
                self.blocks = (a, b)
        except Exception as e:  # noqa: BLE001 - reported with the run
            self.error = e


def run_one(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str,
            control: str | None = None) -> dict:
    """One run of ``cell`` on one device in this process."""
    import torch

    import pipe_tpu_torch as port
    from pipe_tpu_torch import config as pconfig
    from pipe_tpu_torch import kernels

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    port.set_default_device(dev)
    if control == "program_precision_default":
        pconfig.set_matmul_precision("default")
    else:
        pconfig.set_matmul_precision(cell.config["precision"])
    cfg, tr, mod = cell.config, cell.traffic, cell.module
    B, C, fs = tr["block_frames"], cfg["channels"], float(cfg["sample_rate_hz"])

    phases = {"imported": time.time() - portbench.STARTED_WALL}
    x, draw = draw_input(cfg, B, seed, dev)
    d = mod.design(cfg, seed, draw)
    stream = load.Stream(x, B)
    phases["inputs"] = time.time() - portbench.STARTED_WALL
    if trace:
        # the profiler's first start in a process, paid here and not in the window
        tracing.warm(dev)
        phases["profiler"] = time.time() - portbench.STARTED_WALL

    def make(feeder, feed):
        source = lambda mctx, b: port.Source(  # noqa: E731
            output=port.SignalProperties(sample_rate=fs, channels=C), feed=feed)
        sink = lambda mctx, b, props: port.Sink(receive=feeder.rec.receive)  # noqa: E731
        line, handles = mod.line(port, cfg, d, source, sink)
        feeder.retune = lambda j: mod.retune(handles, mod.retuned_sos(cfg, d, j))
        return port.Pipe(B, line, lookahead=tr["lookahead"],
                         batch_blocks=tr["batch_blocks"], device=dev)

    timeout = seconds + 300.0
    warm = load.Feeder(tr, stream, fs, load.Recorder(tr["check"], seed))
    warm.n_total = tr["warmup_blocks"]
    wpipe = make(warm, warm.feed_warmup)
    warm.pipe = wpipe
    wpipe.start()
    wpipe.wait(timeout)
    if warm.rec.n_recv != tr["warmup_blocks"]:
        raise RuntimeError(f"warm-up delivered {warm.rec.n_recv} of "
                           f"{tr['warmup_blocks']} blocks")
    del wpipe, warm
    gc.collect()
    phases["warmed"] = time.time() - portbench.STARTED_WALL

    rec = load.Recorder(tr["check"], seed)
    drv = load.Feeder(tr, stream, fs, rec)
    pipe = make(drv, drv.feed_open if tr["loop"] == "open" else drv.feed_closed)
    kernels.reset_counts()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
    tracer = (_Tracer(rec, tr["trace"], spec.ROOT / "build" / "portbench-trace")
              if trace else None)
    setup_s = time.time() - portbench.STARTED_WALL
    if tracer is not None:
        tracer.start()
    t0, t1 = drv.run(pipe, seconds, timeout)
    if tracer is not None:
        tracer.done.set()
        tracer.join()
        if tracer.error is not None:
            raise tracer.error
    memory_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    launches = kernels.launch_counts()
    del pipe
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    run = Run(channels=C, block_frames=B, eq_shape=mod.eq_shape(cfg, B), setup_s=setup_s,
              window_s=t1 - t0, blocks_received=rec.n_recv,
              t_fed=rec.t_fed, t_recv=rec.t_recv, t_end=t1)
    breakdown = None
    if tracer is not None and tracer.blocks is not None:
        a, b = tracer.blocks
        lo, hi = rec.t_fed[a], rec.t_fed[b]
        run.trace = tracing.reduce(tracer.cap, lo, hi, rec.spans(lo, hi))
        run.trace_blocks = b - a
        run.trace_span = tracer.span
        breakdown = tracing.breakdown(run.trace)
    attempted = len(rec.t_due) if rec.t_due else rec.n_fed
    checks, detail = check(cell, d, stream, rec, seed, attempted, control)
    return {
        "run": run,
        "attempted": attempted,
        "failed": max(0, attempted - rec.n_recv),
        "checks": checks,
        "detail": detail,
        "breakdown": breakdown,
        "launch_counts": launches,
        "memory_peak_bytes": int(memory_peak),
        "pushes": rec.pushes,
        "late_ms_max": max(drv.late_s) * 1e3 if drv.late_s else None,
        "setup_phases_s": phases,
        "profiler": (tracer.start_s, tracer.blocks) if tracer is not None else None,
    }


# -- the check ---------------------------------------------------------------------


def check(cell: spec.Cell, d: dict, stream: load.Stream, rec: load.Recorder, seed: int,
          attempted: int, control: str | None = None):
    """Compare the kept stretches of the output with the reference.

    Compared: every block delivered, in order and whole (``lost``: blocks fed
    or due that did not reach the sink with the full output width, limit
    0), and ``err``: the largest over the compared stretches of the relative
    L2 error ||y - ref|| / ||ref|| of a contiguous run of blocks (every
    channel), the reference run from zero state far enough before the stretch
    (the configuration's ``lead_frames``) that the stream's earlier history
    has died away. The stretches are the stream's first, its last, and up to
    ``check.stretches`` of the periodic ones kept, drawn from the seed. With
    ``control == "reference_tf32"`` the reference computed with TF32
    operands stands in the program's place."""
    cfg, tr, mod = cell.config, cell.traffic, cell.module
    B = tr["block_frames"]
    W = mod.out_width(cfg, B)
    S = tr["check"]["stretch_blocks"]
    pushes = tr.get("pushes")
    every = pushes["every_blocks"] if pushes else None
    bad_widths = sum(1 for out in rec.kept.values() if out.shape[1] != W)
    lost = max(0, attempted - rec.n_recv) + bad_widths + int(rec.frames_recv != rec.n_recv * W)

    first, periodic, last = rec.stretches()
    rng = np.random.default_rng([seed, 4])
    m = min(tr["check"]["stretches"], len(periodic))
    picked = [periodic[i] for i in sorted(rng.choice(len(periodic), m, replace=False))]
    chosen = [s for s in (first, *picked, last) if s is not None]
    lead = -(-cfg["lead_frames"] // B)
    errs = {}
    for k, outs in chosen:
        lb = min(k, lead)
        xin = stream.frames((k - lb) * B, (k + S) * B).astype(np.float64)
        sos = np.stack([mod.retuned_sos(cfg, d, j // every if every else 0)
                        for j in range(k - lb, k + S)])
        ref = mod.reference_output(cfg, d, xin, sos, B)[:, lb * W:]
        if control == "reference_tf32":
            y = mod.reference_output(cfg, d, xin, sos, B, tf32=True)[:, lb * W:]
        else:
            y = np.concatenate(outs, axis=1).astype(np.float64)
        if y.shape != ref.shape:
            errs[k] = float("inf")
            continue
        errs[k] = float(np.linalg.norm(y - ref) / np.linalg.norm(ref))
    err = max(errs.values()) if errs else float("inf")
    checks = {
        "lost": {"value": lost, "limit": cell.limits["lost"]["limit"]},
        "err": {"value": err, "limit": cell.limits["err"]["limit"]},
    }
    return checks, {"stretches": {str(k): v for k, v in errs.items()}, "stretch_blocks": S}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


# -- the command --------------------------------------------------------------------


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def result_line(cell: spec.Cell, trace: bool, part: dict, device: dict) -> dict:
    run = part["run"]
    metrics = {}
    for m in cell.metrics:
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    line = {
        "correct": passed(part["checks"]),
        "attempted": part["attempted"],
        "failed": part["failed"],
        "metrics": metrics,
        "device": device,
    }
    if trace and part.get("breakdown"):
        line["breakdown"] = part["breakdown"]
    line["checks"] = part["checks"]
    return line


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run on the CPU (tests only: no device number is measured)")
    return ap.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool, cpu: bool = False,
             control: str | None = None, cell: spec.Cell | None = None) -> tuple:
    """Run one cell once; returns ``(exit code, result line or None,
    stderr lines)``. ``cell`` may be given already resolved (the tests shrink
    one)."""
    _cache_dirs()
    cell = spec.cell(name, trace) if cell is None else cell
    import torch

    if cpu:
        device = {"platform": "cpu", "kind": "cpu", "count": 1}
        where = "cpu"
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            return 2, None, [f"portbench: the cell needs {cell.chips} CUDA card(s); "
                             f"this machine has {n}"]
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips}
        where = "cuda:0"
    if cell.chips != 1:
        return 2, None, [f"portbench: {name} asks for {cell.chips} cards; the harness "
                         "runs one-card cells only"]
    part = run_one(cell, seed, seconds, trace, where, control)
    device["memory_peak_bytes"] = part["memory_peak_bytes"]
    if trace:
        t = part["run"].trace
        device["busy_s"] = t["busy_s"] if t else 0.0
        device["window_s"] = t["window_s"] if t else 0.0
    if not cpu:
        device["power"] = _power_limit()
    bad = forbidden_modules()
    if bad:
        return 3, None, [f"portbench: the run loaded {', '.join(bad)} (forbidden)"]
    line = result_line(cell, trace, part, device)
    notes = [f"portbench: {name} seed {seed}: {part['run'].blocks_received} blocks received, "
             f"{part['attempted']} attempted, pushes {part['pushes']}, "
             f"launch counts {part['launch_counts']}, set-up phases {part['setup_phases_s']}, "
             f"stretch errors {part['detail']['stretches']}"]
    fifths = part["run"].fifths()
    if fifths:
        notes.append(f"portbench: blocks received in each fifth of the window {fifths}")
    if part.get("late_ms_max") is not None:
        notes.append(f"portbench: the open-loop generator ran at most {part['late_ms_max']:.3f} ms late")
    if trace:
        start_s, blocks = part["profiler"]
        started = "not started" if start_s is None else f"started in {start_s!r} s"
        traced = "none" if blocks is None else f"{blocks[0]}..{blocks[1]}"
        notes.append(f"portbench: profiler {started} inside the window; traced blocks {traced}")
    for k, c in part["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        notes.append(f"check {k}: {c['value']!r} <= limit {c['limit']!r} {ok}")
    return 0, line, notes


def emit(line, notes, out=None, err=None) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    out, err = out or sys.stdout, err or sys.stderr
    for n in notes:
        print(n, file=err)
    err.flush()
    if line is not None:
        print(json.dumps(line), file=out)
    out.flush()


def main(argv=None) -> int:
    args = parse(argv)
    try:
        rc, line, notes = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                   cpu=args.cpu_rehearsal)
    except Exception:  # noqa: BLE001 - a failed run prints no result
        import traceback

        traceback.print_exc()
        rc, line, notes = 1, None, []
    emit(line, notes)
    return rc

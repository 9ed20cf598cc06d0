"""The traced run's device timeline: one ``torch.profiler`` capture over a
bounded, steady stretch of the window, reduced to what the per-layer readers
need.

The profiler is started and stopped on a thread of the harness while the
pipe runs, after :func:`warm` has paid its first start in set-up. CUPTI
records the device's kernels, copies and fills and every CUDA API call of
the process, whatever thread made it. The profiler's CPU side records only
the thread that started it, so the harness's own spans (feed, receive,
push, timed on the host clock by :mod:`portbench.load`) are carried into the
trace's clock by one marker that the starting thread records with the host
clock around it.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
from pathlib import Path

from portbench.load import clock

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
API_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_CALLS = re.compile(r"^(cudaLaunchKernel\w*|cuLaunchKernel\w*|cudaMemcpyAsync)$")


def warm(device) -> None:
    """Start and stop one CPU-only profiler session around one small op on
    ``device``, exporting nothing.

    A process's first ``torch.profiler`` start imports ``torch._inductor``
    (some 840 modules: ``prepare_trace`` asks ``hasattr(torch, "_inductor")``)
    and brings up kineto: about 2 s on a CPU, 8 to over 20 s on an H100's
    host, longer than the window leaves before its traced stretch. Called in
    a traced run's set-up, it leaves the start inside the window a warm one.
    CUPTI is left to :meth:`Capture.start`, which brings it up in a few
    milliseconds: with a CUDA session here, torn down before the pipe is
    built, about a third of ``strip64-render``'s captures on an H100 held no
    kernel record."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    device = torch.device(device)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with record_function("portbench.warm"):
        torch.ones(8, device=device).sum()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()


class Capture:
    """One profiler session, its clock marker and its exported events."""

    def __init__(self, out_dir: Path):
        self.out_dir = out_dir
        self.events: list = []
        self.offset_us = 0.0  # trace microseconds minus host-clock microseconds
        self._prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()
        t0 = clock()
        with record_function("portbench.clock"):
            pass
        self._mark = (t0 + clock()) / 2

    def stop(self) -> None:
        self._prof.stop()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        fd, path = tempfile.mkstemp(suffix=".json", dir=self.out_dir)
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        self.events = [e for e in events if e.get("ph") == "X"]
        mark = next(e for e in self.events if e.get("name") == "portbench.clock")
        self.offset_us = mark["ts"] + mark.get("dur", 0.0) / 2 - self._mark * 1e6

    def to_trace_us(self, t: float) -> float:
        return t * 1e6 + self.offset_us


def _clip(e, lo, hi):
    s, t = e["ts"], e["ts"] + e.get("dur", 0.0)
    return max(s, lo), min(t, hi)


def union(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, end = 0.0, None
    for s, t in sorted(intervals):
        if end is None or s > end:
            total += t - s
            end = t
        elif t > end:
            total += t - end
            end = t
    return total


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:120]


def reduce(cap: Capture, t_lo: float, t_hi: float, spans: list) -> dict:
    """The stretch ``[t_lo, t_hi]`` (host clock) of a capture: device busy
    time (union of its operations), the sum of their times by name, the
    launch calls made, and the idle gaps labelled by what the host was doing
    (the harness's span covering most of the gap, else the CUDA call, else
    the program's own Python between calls)."""
    lo, hi = cap.to_trace_us(t_lo), cap.to_trace_us(t_hi)
    dev, by_name, launches = [], {}, 0
    api = []
    for e in cap.events:
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            s, t = _clip(e, lo, hi)
            if t > s:
                dev.append((s, t))
                key = short_name(e["name"])
                by_name[key] = by_name.get(key, 0.0) + (t - s)
        elif cat in API_CATS:
            if lo <= e["ts"] < hi:
                launches += bool(LAUNCH_CALLS.match(e["name"]))
                api.append((e["ts"], e["ts"] + e.get("dur", 0.0), e["name"]))
    host = _Spans((cap.to_trace_us(a), cap.to_trace_us(b), "harness:" + name)
                  for name, a, b in spans)
    calls = _Spans((a, b, "cuda:" + name) for a, b, name in api)
    gaps: dict = {}
    end = lo
    for s, t in sorted(dev) + [(hi, hi)]:
        if s > end:
            label = (host.covering(end, s) or calls.covering(end, s)
                     or "program: host code between CUDA calls")
            gaps[label] = gaps.get(label, 0.0) + (s - end)
        end = max(end, t)
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": union(dev) / 1e6,
        "device_s": sum(t - s for s, t in dev) / 1e6,
        "by_name_s": {k: v / 1e6 for k, v in by_name.items()},
        "launches": launches,
        "gaps_s": {k: v / 1e6 for k, v in gaps.items()},
    }


class _Spans:
    """Labelled intervals, searchable by the interval they overlap."""

    def __init__(self, items):
        self.items = sorted(items)
        self.starts = [a for a, _, _ in self.items]

    def covering(self, s: float, t: float):
        """The label of the intervals that cover most of ``[s, t]``, if
        they cover half of it or more."""
        cover = {}
        i = bisect.bisect_left(self.starts, t) - 1
        for a, b, name in reversed(self.items[max(0, i - 64):i + 1]):
            c = min(b, t) - max(a, s)
            if c > 0:
                cover[name] = cover.get(name, 0.0) + c
        if cover:
            name, c = max(cover.items(), key=lambda kv: kv[1])
            if c >= 0.5 * (t - s):
                return name
        return None


def breakdown(r: dict) -> dict:
    """The ``breakdown`` of a result line: the ten device operations that
    took most time and the ten largest shares of idle time by label."""
    top = sorted(r["by_name_s"].items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(r["gaps_s"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}

"""The port's spans and counters (``pipe_tpu_torch.profiling``): the span
tree of a pipe, self time, the ring's bound, the untouched hot path
without a recorder, and the benchmark's traced CPU rehearsal of every cell,
with and without a recorder on its timed pipe, capturing its stretch."""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import pipe_tpu_torch
from pipe_tpu_torch import mock, ops, profiling
from pipe_tpu_torch.runtime import executor as executor_mod
from pipe_tpu_torch.runtime import pipe as pipe_mod
from pipe_tpu_torch.signal import SignalProperties

pipe_tpu_torch.set_default_device("cpu")  # these tests ask for the CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C, BLOCK, N_BLOCKS = 2, 256, 12
EXEC_CHILDREN = {"feed", "stage_in", "upload", "op.FIR", "op.Gain",
                 "stage_out", "copy_out", "receive"}


def _gated_pipe(stats, **knobs):
    """A pipe over a feed that waits for ``gate``; returns it with the gate,
    the Gain op and the outputs."""
    x = np.random.default_rng(4).standard_normal((C, N_BLOCKS * BLOCK)).astype(np.float32)
    gate, pos, out = threading.Event(), [0], []

    def feed(n):
        assert gate.wait(30)
        if pos[0] >= x.shape[1]:
            return None
        pos[0] += n
        return x[:, pos[0] - n:pos[0]]

    gain = ops.Gain(1.0)
    line = pipe_tpu_torch.Line(
        source=lambda m, b: pipe_tpu_torch.Source(
            output=SignalProperties(44100.0, C), feed=feed),
        processors=[ops.FIR(ops.design_lowpass(31, 4000, 44100)).processor(),
                    gain.processor()],
        sink=lambda m, b, p: pipe_tpu_torch.Sink(receive=out.append))
    p = pipe_tpu_torch.Pipe(BLOCK, line, stats=stats, **knobs)
    return p, gate, gain, out


def _run_with_pushes(stats, late=False):
    """Two targeted pushes before the stream starts (blocks 3 and 7); with
    ``late`` a third one targets block 1 once block 5 was dispatched."""
    p, gate, gain, out = _gated_pipe(stats, lookahead=2)
    p.start()
    p.push(gain.set_gain(0.5), at_block=3)
    p.push(gain.set_gain(0.25), at_block=7)
    dest = p._exec_of_route[0].dest
    deadline = time.time() + 30
    while sorted(dest.pending_targets()) != [3, 7]:
        assert time.time() < deadline, "targets never delivered"
        time.sleep(0.002)
    if late:
        # hold the feed at block 6 so the late push lands while streaming
        gate.set()
        while p.block_index() < 6:
            assert time.time() < deadline
            time.sleep(0.001)
        p.push(gain.set_gain(2.0), at_block=1)
    gate.set()
    p.wait(60)
    return out


def test_span_tree_blocks_and_push_ids():
    stats = pipe_tpu_torch.StatsRecorder()
    y = np.concatenate(_run_with_pushes(stats), 1)
    # the recorder changes no output: the gains land at exactly their blocks
    np.testing.assert_array_equal(y, np.concatenate(_run_with_pushes(None), 1))
    spans = stats.spans()
    by_id = {s.id: s for s in spans}
    execs = [s for s in spans if s.name == "execute"]
    # one dispatch a block, and the call that finds the feed's EOF
    assert [s.block for s in execs] == list(range(N_BLOCKS + 1))
    assert stats.lines["line0"].blocks == N_BLOCKS + 1
    for s in spans:
        assert s.start <= s.end
        if s.parent is None:
            continue
        parent = by_id[s.parent]
        assert parent.name == "execute" and s.line == parent.line == "line0"
        assert parent.start <= s.start and s.end <= parent.end
        assert s.name in EXEC_CHILDREN
    # every block is fed, staged, swept through both ops and received once
    for name in ("stage_in", "upload", "op.FIR", "op.Gain", "stage_out",
                 "copy_out", "receive"):
        assert sorted(s.block for s in spans if s.name == name) == list(range(N_BLOCKS)), name
    for s in spans:
        if s.name in ("upload", "op.FIR", "op.Gain", "stage_out"):
            assert s.block == by_id[s.parent].block  # one block a dispatch
    # a push's three spans share its id; mutate names the block it landed before
    reqs = {}
    for s in spans:
        if s.name in ("push", "deliver", "mutate"):
            reqs.setdefault(s.request, {})[s.name] = s
    assert None not in reqs and len(reqs) == 2
    landed = sorted(r["mutate"].block for r in reqs.values())
    assert landed == [3, 7]
    for r in reqs.values():
        assert set(r) == {"push", "deliver", "mutate"}
        assert r["push"].line is None and r["mutate"].line == "line0"
        assert r["push"].start <= r["deliver"].start <= r["mutate"].start
    assert stats.pushes == 2 and stats.late_targets == 0
    report = stats.report()
    assert f"line0: {N_BLOCKS + 1} blocks x {BLOCK} frames x {C}ch" in report
    for part in ("self ", "feed ", "staging ", "ops ", "wait ", "receive "):
        assert part in report
    assert "push path: 2 pushes, 0 late" in report


def test_a_push_past_its_target_counts_late():
    stats = pipe_tpu_torch.StatsRecorder()
    _run_with_pushes(stats, late=True)
    assert stats.pushes == 3 and stats.late_targets == 1
    mutates = {s.request: s for s in stats.spans() if s.name == "mutate"}
    pushes = sorted((s for s in stats.spans() if s.name == "push"), key=lambda s: s.start)
    assert mutates[pushes[-1].request].block > 1  # applied at the next block


def test_self_time_is_duration_less_the_children():
    stats = pipe_tpu_torch.StatsRecorder()
    pipe_tpu_torch.run(64, pipe_tpu_torch.Line(
        source=mock.Source(channels=2, limit=20 * 64).source(),
        processors=[ops.Gain(0.5).processor()],
        sink=mock.Sink().sink()), stats=stats, lookahead=3)
    spans = stats.spans()
    kids = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(s)
    execs = [s for s in spans if s.name == "execute"]
    assert len(execs) == 21  # 20 blocks and the EOF call
    for e in execs:
        cover = sum(c.end - c.start for c in kids.get(e.id, ()))
        assert e.self_s == pytest.approx(e.end - e.start - cover, abs=1e-9)
        assert 0 <= e.self_s <= e.end - e.start
    # a device source's step and the ops are children; the timeline's self
    # time by name sums the same pieces, and clips to an interval
    names = {s.name for s in spans}
    assert {"source", "op.Gain", "stage_out"} <= names
    tl = stats.timeline()
    total = tl.self_time()
    assert total["execute"] == pytest.approx(sum(e.self_s for e in execs), rel=1e-6)
    assert total["op.Gain"] == pytest.approx(
        sum(s.end - s.start for s in spans if s.name == "op.Gain"), rel=1e-6)
    e = execs[5]
    inside = tl.self_time(e.start, e.end)
    assert sum(inside.values()) == pytest.approx(e.end - e.start, rel=1e-6)
    assert inside["execute"] == pytest.approx(e.self_s, rel=1e-6)
    ls = stats.lines["line0"]
    assert ls.seconds["execute"] == pytest.approx(total["execute"], rel=1e-6)


def test_the_ring_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_RING", 40)
    stats = pipe_tpu_torch.StatsRecorder()
    pipe_tpu_torch.run(64, pipe_tpu_torch.Line(
        source=mock.Source(channels=2, limit=50 * 64).source(),
        processors=[ops.Gain(0.5).processor()],
        sink=mock.Sink().sink()), stats=stats)
    spans = stats.spans()
    assert len(spans) == 40
    assert stats.total_blocks == 51  # the counters cover the whole run
    assert max(s.block for s in spans if s.name == "execute") == 50
    # an execute whose first children the ring dropped leaves the timeline
    # (its self time is not known); the others stay whole
    kids = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append(s)
    tl = profiling.Timeline(spans)
    partial = 0
    for e in (s for s in spans if s.name == "execute"):
        kept = sum(c.end - c.start for c in kids.get(e.id, ()))
        mine = tl.self_time(e.start, e.end).get("execute", 0.0)
        if kept < e.cover - 1e-12:
            partial += 1
            assert mine == 0.0
        else:
            assert mine == pytest.approx(e.self_s, rel=1e-6)
    assert partial == 1  # 6 spans a block: the oldest execute lost 4 children


def test_without_a_recorder_no_span_site_runs(monkeypatch):
    """stats=None: no clock read, no span and no recorder method, on the
    executor's path and the push path."""
    def refuse(*a, **k):
        raise AssertionError("a span site ran without a recorder")

    for mod in (executor_mod, pipe_mod):
        monkeypatch.setattr(mod, "clock", refuse)
    for cls, names in ((profiling.LineStats, ("open", "close", "span", "op_name")),
                       (profiling.StatsRecorder, ("new_push", "tagged", "push_span",
                                                  "mutating"))):
        for name in names:
            monkeypatch.setattr(cls, name, refuse)
    out = _run_with_pushes(None, late=True)
    assert np.concatenate(out, 1).shape == (C, N_BLOCKS * BLOCK)


# -- the benchmark's traced CPU rehearsal -------------------------------------

CELL_OPS = {
    "console64-render": {"op.FIR", "op.Resampler", "op.Biquad", "op.ChannelMix"},
    "console64-live": {"op.FIR", "op.Resampler", "op.Biquad", "op.ChannelMix"},
    "reverb16-render": {"op.OLSConvolve", "op.Biquad"},
}


@pytest.fixture(scope="module")
def rehearsals():
    """Every cell's traced CPU rehearsal, without and with a recorder, run
    once in a fresh process (``tests/torch_traced_rehearsal.py``)."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "torch_traced_rehearsal.py"), "4"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    runs = {}
    for text in proc.stdout.splitlines():
        d = json.loads(text)
        runs[d["name"], d["recorder"]] = d
    return runs, proc


@pytest.mark.parametrize("recorder", [False, True])
@pytest.mark.parametrize("name", sorted(CELL_OPS))
def test_traced_rehearsal_captures_its_stretch(name, recorder, rehearsals):
    """The harness's traced run, as the benchmark makes it, captures a
    stretch (``device.window_s`` above 0, ``busy_s`` at most it), and stays
    correct with a recorder on its timed pipe, whose spans name the cell's
    ops, the staging copies and, in the live cell alone, a retune's push,
    delivery and landing."""
    runs, proc = rehearsals
    assert (name, recorder) in runs, proc.stderr[-3000:]
    r = runs[name, recorder]
    line = r["line"]
    assert r["rc"] == 0 and line["correct"] is True and line["failed"] == 0, r["notes"]
    dev = line["device"]
    assert dev["window_s"] > 0, r["notes"]
    assert 0 <= dev["busy_s"] <= dev["window_s"]
    assert line["breakdown"]["idle_gaps"]
    if not recorder:
        return
    names = set(r["span_names"])
    assert CELL_OPS[name] | {"execute", "feed", "stage_in", "upload", "stage_out",
                             "copy_out", "receive"} <= names
    assert ({"push", "deliver", "mutate"} <= names) == (name == "console64-live")
    assert r["late_targets"] == 0
    assert all(r["self_s"][op] > 0 for op in CELL_OPS[name])

"""The traced run pays the profiler's first start in set-up: in a fresh
process the stretch is captured whole, and an untraced run never touches
the profiler."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, small_cell

# A fresh process, as the benchmark runs a cell: nothing has started a
# profiler or imported ``torch._inductor`` before the run's own set-up.
FRESH = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[1] + "/portbench/tests"]
import pipe_tpu_torch
from conftest import small_cell
from portbench import harness, load

fresh = "torch._inductor" not in sys.modules
seen = {}
window = load.Feeder.run

def run(self, *args, **kwargs):
    seen["inductor"] = "torch._inductor" in sys.modules
    return window(self, *args, **kwargs)

load.Feeder.run = run
pipe_tpu_torch.set_default_device("cpu")
rc, line, notes = harness.run_cell("console64-render", 2 ** 31 + 17, 0.6, True, cpu=True,
                                   cell=small_cell("console64-render", True))
print(json.dumps({"fresh": fresh, "inductor_before_window": seen.get("inductor"),
                  "rc": rc, "line": line, "notes": notes}))
"""


def test_a_fresh_traced_run_captures_its_stretch():
    proc = subprocess.run([sys.executable, "-c", FRESH, str(ROOT)], capture_output=True,
                          text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["fresh"] is True and r["rc"] == 0, r["notes"]
    assert r["inductor_before_window"] is True
    assert r["line"]["device"]["window_s"] > 0, r["notes"]
    note = next(n for n in r["notes"] if "traced blocks" in n)
    a, b = map(int, note.rsplit(" ", 1)[1].split(".."))
    assert b - a == small_cell("console64-render", True).traffic["trace"]["blocks"], note


@pytest.mark.parametrize("trace", [False, True])
def test_only_a_traced_run_touches_the_profiler(trace, monkeypatch, cpu_port):
    """Untraced: no profiler is made. Traced: ``warm`` once, before the
    window's ``Feeder.run``."""
    import torch.profiler

    from portbench import harness, load
    from portbench import trace as tracing

    events = []
    profile, warm, window = torch.profiler.profile, tracing.warm, load.Feeder.run

    def counted_profile(*args, **kwargs):
        events.append("profile")
        return profile(*args, **kwargs)

    def counted_warm(device):
        events.append("warm")
        return warm(device)

    def counted_run(self, *args, **kwargs):
        events.append("run")
        return window(self, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "profile", counted_profile)
    monkeypatch.setattr(tracing, "warm", counted_warm)
    monkeypatch.setattr(load.Feeder, "run", counted_run)
    rc, line, _ = harness.run_cell("console64-render", 2 ** 31 + 19, 0.6, trace, cpu=True,
                                   cell=small_cell("console64-render", trace))
    assert rc == 0 and line["correct"] is True
    if trace:
        assert events.count("warm") == 1
        assert events.index("warm") < events.index("run")
        assert events[:events.index("run")] == ["warm", "profile"]
    else:
        assert events == ["run"]

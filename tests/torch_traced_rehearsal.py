"""Traced CPU rehearsals of the benchmark's cells in a fresh process, as the
benchmark makes its ``--trace 1`` runs (nothing else imported first):

    python tests/torch_traced_rehearsal.py <seconds>

runs every cell cut to the CPU's size (``portbench/tests/conftest.py``)
twice, without and with a ``StatsRecorder`` on its timed pipe, and prints a
JSON line a run: the harness's exit code, result line and notes, and the
recorder's span names, late targets and self time by span name."""

import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("console64-live", "console64-render", "reverb16-render")


def main(seconds: float) -> None:
    sys.path.insert(0, ROOT)
    import pipe_tpu_torch
    from pipe_tpu_torch import profiling
    from portbench import harness

    spec = importlib.util.spec_from_file_location(
        "portbench_small_cells", os.path.join(ROOT, "portbench", "tests", "conftest.py"))
    small = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(small)

    make, built, recorders, want = pipe_tpu_torch.Pipe, [], [], [False]

    def pipe(*a, **k):
        if want[0] and built:  # the first pipe is the warm-up's
            k["stats"] = profiling.StatsRecorder()
            recorders.append(k["stats"])
        built.append(1)
        return make(*a, **k)

    pipe_tpu_torch.Pipe = pipe
    for name in CELLS:
        for recorder in (False, True):
            built.clear()
            recorders.clear()
            want[0] = recorder
            rc, line, notes = harness.run_cell(name, 2 ** 31 + 21, seconds, True, cpu=True,
                                               cell=small.small_cell(name, True))
            out = {"name": name, "recorder": recorder, "rc": rc, "line": line, "notes": notes}
            if recorders:
                stats = recorders[0]
                out["span_names"] = sorted({s.name for s in stats.spans()})
                out["late_targets"] = stats.late_targets
                out["self_s"] = stats.timeline().self_time()
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(float(sys.argv[1]))

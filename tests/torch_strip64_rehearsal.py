"""CPU rehearsals of the cells ``strip64-render`` and ``reverb16-live`` in a
fresh process, as the benchmark runs a cell (nothing else imported first):

    python tests/torch_strip64_rehearsal.py <seconds>

runs each cell cut to the CPU's size (:func:`small_cell`) as the program,
traced (over 6 s at least), as the TF32 reference control, and ``strip64-render`` once more with
a fault planted under its timed path (the envelope state not carried from
block to block), and prints a JSON line a run: the case, the harness's exit
code, its result line and its notes."""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (cell, control, fault, trace)
CASES = [
    ("strip64-render", None, None, False),
    ("strip64-render", None, None, True),
    ("strip64-render", "reference_tf32", None, False),
    ("strip64-render", None, "envelope_not_carried", False),
    ("reverb16-live", None, None, False),
    ("reverb16-live", None, None, True),
    ("reverb16-live", "reference_tf32", None, False),
]


def small_cell(name: str, trace: bool):
    """The cell cut to a size the CPU holds in seconds, as the benchmark's
    own tests cut theirs: 8 channels, a short buffer, check and trace;
    strip64 at 1,024-frame blocks with its echo shortened to 2,205 frames
    (still a block or more, so the ring path) and its lead to 32,768 frames
    (14 echoes); reverb16's impulse response at 4,096 taps."""
    from portbench import spec

    cell = spec.cell(name, trace)
    cfg, tr = cell.config, cell.traffic
    cfg["channels"] = 8
    cfg["signal"] = dict(cfg["signal"], buffer_seconds=0.5)
    if name == "strip64-render":
        cfg["echo"] = dict(cfg["echo"], delay_frames=2205)
        cfg["lead_frames"] = 32768
        tr.update(block_frames=1024, warmup_blocks=4)
    else:
        cfg["ir"] = {"taps": 4096, "decay_samples": 800}
        cfg["lead_frames"] = 8192
        tr.update(warmup_blocks=16)
    closed = tr["loop"] == "closed"
    tr["check"] = {"stretch_blocks": 2 if closed else 8,
                   "period_blocks": 8 if closed else 24, "stretches": 2}
    # the profiler slows each of the strip's ~1,700 CPU ops a block: a short
    # stretch
    tr["trace"] = ({"skip_blocks": 1, "blocks": 2} if name == "strip64-render"
                   else {"skip_blocks": 2, "blocks": 4})
    return cell


def envelope_not_carried():
    """The gate, compressor and limiter start every block from a zero
    envelope; returns the undo."""
    import torch

    from pipe_tpu_torch.ops import dynamics

    carried = dynamics.envelope_block

    def forgets(*args, **kwargs):
        new0, new_lo, env = carried(*args, **kwargs)
        return torch.zeros_like(new0), torch.zeros_like(new_lo), env

    dynamics.envelope_block = forgets
    return lambda: setattr(dynamics, "envelope_block", carried)


def main(seconds: float) -> None:
    sys.path.insert(0, ROOT)
    import pipe_tpu_torch
    from portbench import harness

    for k, (name, control, fault, trace) in enumerate(CASES):
        undo = envelope_not_carried() if fault else (lambda: None)
        try:
            # a traced window outlasts the profiler's first start
            rc, line, notes = harness.run_cell(name, 2 ** 31 + 41 + k,
                                               max(seconds, 6.0) if trace else seconds, trace,
                                               cpu=True, control=control,
                                               cell=small_cell(name, trace))
        finally:
            undo()
            pipe_tpu_torch.config.set_matmul_precision("highest")
        print(json.dumps({"case": [name, control, fault, trace], "rc": rc, "line": line,
                          "notes": notes}), flush=True)


if __name__ == "__main__":
    main(float(sys.argv[1]))

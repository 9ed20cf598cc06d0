"""Read the check's numbers over several seeds in one process: the program
as it is run (the lower readings of the limits), or its control (the upper
readings).

    python3 -m portbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]
        [--control program | program_precision_default | reference_tf32]

``program_precision_default`` runs the program with its own TF32 path on
(``config.set_matmul_precision('default')``: TF32 in cuBLAS and cuDNN);
``reference_tf32`` puts the reference computed from TF32 operands in the
program's place. Without ``--control`` the cell's configuration names it.
The benchmark's own runs never run a control.
"""

import argparse
import json
import sys

from portbench import harness, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", default=None)
    ap.add_argument("--cpu-rehearsal", action="store_true")
    a = ap.parse_args(argv)
    cell = spec.cell(a.workload, False)
    which = a.control or cell.config["control"]
    rows = []
    for seed in a.seeds:
        rc, line, notes = harness.run_cell(
            a.workload, seed, a.seconds, False, cpu=a.cpu_rehearsal,
            control=None if which == "program" else which, cell=spec.cell(a.workload, False))
        if line is None:
            print(f"seed {seed}: no result (rc {rc}): {notes}", flush=True)
            rows.append({"seed": seed, "rc": rc})
            continue
        row = {"seed": seed, "control": which, "correct": line["correct"],
               "checks": {k: c["value"] for k, c in line["checks"].items()},
               "metrics": {k: m["value"] for k, m in line["metrics"].items()}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    errs = [r["checks"]["err"] for r in rows if "checks" in r]
    if errs:
        print(json.dumps({"workload": a.workload, "control": which, "seeds": len(errs),
                          "err_min": min(errs), "err_max": max(errs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names its configuration and its traffic.
The configuration's sizes are the JSON file that ``configs`` gives it, and
its code is ``portbench/configs/<config>.py``; the traffic is
``portbench/traffic/<traffic>.json``; the limits of its check are
``portbench/limits/<cell>.json``; a metric is read by
``portbench/metrics/<name up to its first dot>.py``. A later cell, mix or
metric is new files and new entries, never an edit of these.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    module: object  # portbench.configs.<config>
    metrics: list  # the metric entries this cell reports, end to end or per layer


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metric_applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader(metric_name: str):
    """The ``read`` function of a metric."""
    return importlib.import_module(
        f"portbench.metrics.{metric_name.split('.')[0]}").read


def cell(name: str, trace: bool, bench: dict | None = None) -> Cell:
    bench = load_benchmark() if bench is None else bench
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in bench["configs"] if c["name"] == w["config"])
    kind = "per_layer" if trace else "end_to_end"
    return Cell(
        name=name,
        chips=w["chips"],
        config=_json(ROOT / c["file"]),
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(HERE / "limits" / f"{name}.json"),
        module=importlib.import_module(f"portbench.configs.{w['config']}"),
        metrics=[m for m in bench[kind] if metric_applies(m, name)],
    )

"""BENCHMARK.json against the rules the benchmark keeps (keys, names, units,
bounds, sizes), and every name in it resolving to its files."""

import json
import re

import pytest

from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16 and 1 <= len(bench["command"]) <= 32
    for p in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and (ROOT / p).is_dir()
        assert not p.endswith("_torch")
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/") and ".." not in word
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits into 12 hours
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_just_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES


def test_names_units_and_lines(bench):
    groups = [bench["configs"], bench["workloads"], bench["end_to_end"] + bench["per_layer"]]
    for group in groups:
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for e in bench["configs"] + bench["workloads"]:
        for key in ("why", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    assert len(bench["workloads"]) <= 24 and len(bench["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)


def test_every_cell_resolves(bench):
    from portbench import spec

    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for w in bench["workloads"]:
        for trace in (False, True):
            cell = spec.cell(w["name"], trace, bench)
            assert cell.traffic["block_frames"] > 0 and cell.config["channels"] > 0
            assert {"lost", "err"} <= set(cell.limits)
            for m in cell.metrics:
                assert callable(spec.reader(m["name"]))


def test_every_cell_reports_what_it_must(bench):
    from portbench import spec

    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for w in bench["workloads"]:
        mine = [m for m in bench["end_to_end"] if spec.metric_applies(m, w["name"])]
        assert len(mine) >= 2
        layer = [m for m in bench["per_layer"] if spec.metric_applies(m, w["name"])]
        assert layer
        for m in layer:
            assert m["moves"] in e2e and spec.metric_applies(e2e[m["moves"]], w["name"])


def test_layers_are_named_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    assert all(1 <= len(l) <= 200 and "\n" not in l for l in layers)
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert layer in perf


def test_roofline_metrics_are_percent(bench):
    for m in bench["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"

"""BENCHMARK.json's format: names and units of the allowed
characters, every configuration, mix, driver, metric reader and limits
file found by name, and the data each cell needs."""

from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}


def _text(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "h100_bench/run.py"]
    assert all(_text(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert all(not p.endswith("_torch") and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_text():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["source"]) and _text(c["why"])
        assert len(c["reduced"]) <= 16
        assert c["file"].startswith("h100_bench/") and (ROOT / c["file"]).is_file()
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _text(w["why"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_metrics_keys_bounds_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and len(e2e) <= 4
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _text(m["layer"])
        for cell in m.get("workloads", cells):
            moved = e2e[m["moves"]]
            assert cell in moved.get("workloads", cells), (m["name"], cell)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_by_name(cell):
    from h100_bench import run

    found = run.cell_of(BENCH, cell)
    assert found["driver"].is_file()
    assert (ROOT / "h100_bench" / "limits" / f"{cell}.json").is_file()
    e2e = [m["name"] for m in run.metrics_of(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = run.metrics_of(BENCH, cell, True)
    assert per_layer
    for m in per_layer + run.metrics_of(BENCH, cell, False):
        reader = run.load_module(ROOT / "h100_bench" / "metrics" / f"{m['name']}.py")
        assert reader.read({}) is None or m["name"] == "setup_s"


def test_run_seconds_fit_the_full_check():
    """24 cells, 14 runs each and 2 more, each run_seconds + 60 s, 2 x 90 s
    of compiles a cell and 1,200 s spare, within 43,200 s."""
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200

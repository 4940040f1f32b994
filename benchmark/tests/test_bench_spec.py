"""BENCHMARK.json against the shape it must have, and every piece of every
cell found by its name."""

import json
import re

import pytest

from benchmark.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DATA = json.loads((spec.ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert DATA["command"][:1] == ["python3"]
    assert all((spec.ROOT / p).is_dir() for p in DATA["paths"])
    assert (spec.ROOT / DATA["command"][1]).is_file()
    assert 1 <= DATA["run_seconds"] <= 51


def test_entries_have_the_required_keys():
    for c in DATA["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in DATA["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert (0.01 if m["name"] != "setup_s" else 0.0) <= m["bound"] <= 0.25
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in DATA[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    metrics = DATA["end_to_end"] + DATA["per_layer"]
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in metrics)
    assert "setup_s" in {m["name"] for m in DATA["end_to_end"]}


def test_every_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in DATA["end_to_end"]}
    cells = {w["name"] for w in DATA["workloads"]}
    for m in DATA["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in target.get("workloads", cells)


@pytest.mark.parametrize("name", [w["name"] for w in DATA["workloads"]])
def test_every_piece_of_a_cell_is_found_by_name(name):
    sp = spec.Spec()
    cell = sp.cell(name)
    entry = {c["name"]: c for c in DATA["configs"]}[
        {w["name"]: w for w in DATA["workloads"]}[name]["config"]]
    assert cell.config["name"] == entry["name"]
    assert cell.config["source"] == entry["source"] and not entry["reduced"]
    job = sp.module("jobs", cell.traffic["kind"])
    for fn in ("setup", "window", "traced", "release", "check",
               "sound_reading", "control_reading"):
        assert callable(getattr(job, fn))
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    for m in cell.per_layer:
        assert callable(sp.module("metrics", m["name"]).read)


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.Spec().cell("no_such_cell")

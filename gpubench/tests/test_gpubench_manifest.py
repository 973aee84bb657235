"""BENCHMARK.json against the format the benchmark keeps to: its keys, names and
units, and every file a cell, configuration or metric is found by."""

import json
import re

import pytest

import harness

MANIFEST = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert MANIFEST["paths"] == ["gpubench"]
    assert MANIFEST["command"] == ["python3", "gpubench/run.py"]


@pytest.mark.parametrize("kind, keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source",
                    "workloads"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves",
                   "workloads"}),
])
def test_entries(kind, keys):
    names = [e["name"] for e in MANIFEST[kind]]
    assert len(names) == len(set(names))
    for e in MANIFEST[kind]:
        assert set(e) <= keys, e
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert TEXT.match(e[k]), e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_cells_find_their_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for w in MANIFEST["workloads"]:
        assert w["chips"] == 1
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        cfg = configs[w["config"]]
        assert (harness.ROOT / cfg["file"]).is_file()
        assert (harness.HERE / "traffic" / (w["traffic"] + ".json")).is_file()
        cell = harness.Cell(w["name"], MANIFEST)
        assert callable(cell.build)
        assert cell.config["name"] == w["config"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_metrics_have_readers_and_bounds():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert (harness.HERE / "metrics" / (m["name"] + ".py")).is_file()
    for m in MANIFEST["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_every_kernel_file_names_a_counter():
    import importlib

    for label, (fragment, (mod, fn)) in harness.kernels().items():
        assert fragment and hasattr(importlib.import_module(mod), fn), label


def test_per_layer_metrics_go_where_what_they_move_is_reported():
    for w in MANIFEST["workloads"]:
        cell = harness.Cell(w["name"], MANIFEST)
        reported = {m["name"] for m in cell.end_to_end}
        assert all(m["moves"] in reported for m in cell.per_layer)
        moved = {m["moves"] for m in cell.per_layer}
        assert reported - {"setup_s"} <= moved, w["name"]
    for m in MANIFEST["per_layer"]:
        for name in m.get("workloads", []):
            reported = {e["name"] for e in
                        harness.Cell(name, MANIFEST).end_to_end}
            assert m["moves"] in reported, (m["name"], name)

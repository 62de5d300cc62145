"""BENCHMARK.json against the benchmark's contract: keys, names, units and
lengths, every cell and metric resolved by name from its own files, the
metrics each cell must report, and the run-time budget."""

from __future__ import annotations

import json
import re

import pytest

from flowbench import harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_size():
    assert set(MAN) == TOP
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MAN["command"] == ["python3", "flowbench/run.py"]
    assert MAN["paths"] == ["flowbench"]
    assert 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"}),
])
def test_entries_keys_and_names(section, keys):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e and section in ("configs", "workloads", "per_layer"):
                assert _line(e[k]), (e["name"], k)
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")


def test_names_across_sections_are_unique():
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_bounds_and_sources():
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}


@pytest.mark.parametrize("w", [w["name"] for w in MAN["workloads"]])
def test_every_cell_resolves_by_name(w):
    cell = harness.resolve(w)
    assert cell.chips == 1
    assert (harness.BENCH / "drivers"
            / f"{cell.traffic['driver']}.py").is_file()
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (w, m["name"])
        mod = harness.load_module(harness.BENCH / "metrics"
                                  / f"{m['name']}.py")
        assert callable(mod.read)


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert c["file"].startswith("flowbench/")
    cfg = json.loads((harness.ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert any(w["config"] == c["name"] for w in MAN["workloads"])
    assert c["source"].startswith("https://")


def test_layers_are_named_alike():
    layers = {m["layer"] for m in MAN["per_layer"]}
    assert layers <= {"Entry", "Data", "Step", "Model", "Kernels", "Device",
                      "Whole step"}


def test_check_fits_in_its_time():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_pairs_of_config_and_traffic_are_unique():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))

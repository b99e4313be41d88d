"""BENCHMARK.json keeps the benchmark's contract, and every name in it
has its file."""

import json
import math
import re
from pathlib import Path

import pytest

from gt4bench import manifest

B = manifest.benchmark()
ROOT = manifest.BENCHMARK.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E = {m["name"]: m for m in B["end_to_end"]}
CELLS = {w["name"]: w for w in B["workloads"]}


def line(text):
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_shape_and_size():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert manifest.BENCHMARK.stat().st_size <= 64 * 1024
    assert 1 <= len(B["command"]) <= 32 and all(map(line, B["command"]))
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in B["command"]:
        assert not word.startswith("/") and ".." not in word


def test_run_seconds_fits_a_full_check():
    rs = B["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    seen = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16 and all(map(NAME.match, c["reduced"]))
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in B[group]:
            assert NAME.match(e["name"])
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for cell in m.get("workloads", []):
            assert cell in CELLS


def test_setup_bound():
    assert E2E["setup_s"]["bound"] <= 0.25
    assert "workloads" not in E2E["setup_s"]


def test_cells_configs_and_four_chip_share():
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in B["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in B["workloads"]}
    assert used == {c["name"] for c in B["configs"]}
    for c in B["configs"]:
        assert any(c["file"].startswith(p + "/") for p in B["paths"])
        assert (ROOT / c["file"]).is_file()
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, math.floor(0.25 * len(B["workloads"])))


def reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_reports_enough(cell):
    e2e = [m["name"] for m in B["end_to_end"] if reports(m, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(reports(m, cell) for m in B["per_layer"])


@pytest.mark.parametrize("metric", B["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_read(metric):
    moved = E2E[metric["moves"]]
    for cell in metric.get("workloads", CELLS):
        assert reports(moved, cell), (metric["name"], cell)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_name_has_its_file(cell):
    c = manifest.cell(cell)
    assert c.chips == CELLS[cell]["chips"]
    assert c.config["driver"]
    manifest.driver(c.config["driver"])
    for m in B["end_to_end"] + B["per_layer"]:
        if reports(m, cell):
            assert callable(manifest.metric_reader(m["name"]))


def test_config_files_name_their_cuts():
    for c in B["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert key in cfg and key in cfg["assumed"]


def test_no_stray_files():
    """Every file of a kind is named by the manifest: no orphan cell,
    configuration, mix or metric."""
    here = Path(manifest.HERE)
    names = {m["name"] for m in B["end_to_end"] + B["per_layer"]}
    assert {p.stem for p in (here / "metrics").glob("*.py")} == names
    assert {p.stem for p in (here / "workloads").glob("*.json")} == set(CELLS)
    assert ({p.stem for p in (here / "configs").glob("*.json")}
            == {c["name"] for c in B["configs"]})
    assert ({p.stem for p in (here / "traffic").glob("*.json")}
            == {w["traffic"] for w in B["workloads"]})

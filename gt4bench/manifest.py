"""Finds a cell's files by name: ``workloads/<cell>.json`` names its
configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<mix>.json``); a configuration names its driver
(``drivers/<driver>.py``); each metric of ``BENCHMARK.json`` is read by
``metrics/<metric>.py``. A new cell, mix, configuration or metric is new
files and new entries, never an edit."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(BENCHMARK)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict


def cell(name: str) -> Cell:
    """The cell ``name`` from its files, held to its entry in
    ``BENCHMARK.json``."""
    wl = _json(HERE / "workloads" / f"{name}.json")
    entry = next((w for w in benchmark()["workloads"]
                  if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"{name}: no such workload in BENCHMARK.json")
    for key in ("config", "traffic", "chips"):
        if entry[key] != wl[key]:
            raise ValueError(f"{name}: {key} is {wl[key]!r} in its file and "
                             f"{entry[key]!r} in BENCHMARK.json")
    return Cell(name, int(wl["chips"]), wl["config"], wl["traffic"],
                _json(HERE / "configs" / f"{wl['config']}.json"),
                _json(HERE / "traffic" / f"{wl['traffic']}.json"))


def metrics(cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones, each where its
    ``workloads`` name the cell or it has none."""
    group = benchmark()["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or cell_name in m["workloads"]]


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gt4bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"gt4bench.drivers.{name}")

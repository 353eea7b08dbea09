"""A cell's files, found by the names in `BENCHMARK.json`.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration is `configs/<config>.json` (the file `BENCHMARK.json`
gives), the traffic mix `traffic/<traffic>.json`, the limits of the
comparison that decides `correct` `limits/<cell>.json`, and each metric a
reader `metrics/<metric>.py`. Adding a cell, a configuration, a mix or a
metric is adding files and entries: nothing here names one.
"""

import importlib.util
import json
import os
from typing import NamedTuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: dict  # {number compared: its limit}
    end_to_end: list  # the cell's entries of `end_to_end`
    per_layer: list  # the cell's entries of `per_layer`
    chips: int


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics, cell: str):
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, manifest_path: str = os.path.join(ROOT, "BENCHMARK.json")) -> Cell:
    manifest = _json(manifest_path)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in {manifest_path}: {sorted(cells)}")
    w = cells[name]
    config = next(c for c in manifest["configs"] if c["name"] == w["config"])
    return Cell(
        name=name,
        config=_json(os.path.join(ROOT, config["file"])),
        traffic=_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")),
        limits=_json(os.path.join(BENCH_DIR, "limits", f"{name}.json")),
        end_to_end=_for_cell(manifest["end_to_end"], name),
        per_layer=_for_cell(manifest["per_layer"], name),
        chips=int(w["chips"]),
    )


def reader(metric: str):
    """The `read(run)` function of `metrics/<metric>.py`."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

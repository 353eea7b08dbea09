"""BENCHMARK.json against the contract's form, every cell's files found by
name, and the entry's refusal without a card."""

import json
import os
import re
import subprocess
import sys

import pytest

from harness import manifest

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_form(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"][1] == "benchmark/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [c["name"] for c in bench["workloads"]]
    assert len(names) == len(set(names))
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200


def test_every_cell_reports_what_its_metrics_move(bench):
    """Each cell reports setup_s, another end-to-end metric and a per-layer
    metric; each per-layer metric's cells report the metric it moves."""
    cells = [w["name"] for w in bench["workloads"]]

    def cells_of(m):
        return m.get("workloads", cells)

    for cell in cells:
        e2e = {m["name"] for m in bench["end_to_end"] if cell in cells_of(m)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(cell in cells_of(m) for m in bench["per_layer"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(cells_of(m)) <= set(cells_of(e2e[m["moves"]])), m["name"]


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        cell = manifest.load_cell(w["name"])
        assert set(cell.limits) == {"totals", "update_misses"}
        assert cell.limits["update_misses"] == 0
        for m in cell.end_to_end + cell.per_layer:
            assert callable(manifest.reader(m["name"]))


def test_entry_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "solo_pick.k256",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "solo_pick.k256",
                          "--seed", str(2**31 + 99), "--seconds", "1", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert {"mppi.host_ms", "mppi.launches", "k2.device_ms", "k2.roofline_pct",
            "device.idle_pct"} <= set(line["metrics"])

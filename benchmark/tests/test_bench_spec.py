"""BENCHMARK.json against the benchmark's contract, and the pieces of a
cell found by name: a configuration, a traffic mix, a cell's limits or a
per-layer metric added as a new file is found with no file edited."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= 1
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("benchmark/")


def test_bounds_and_run_length(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    # a full check of 24 cells fits the driver's 43,200 seconds
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("workload", ["llff_room.step1", "llff_room.eval", "lego.step2"])
def test_each_cell_is_complete(bench, workload):
    cell = spec.load_cell(workload)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"])) and m["moves"] in reported
    assert cell.limits and cell.traffic["leg"] in ("train", "eval")


def test_a_new_cell_is_found_from_new_files_alone(bench, tmp_path):
    """A later change adds a configuration, a traffic mix, limits and a
    metric as files, and entries in BENCHMARK.json; no file is edited."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    new = dict(bench)
    (root / "benchmark/configs/llff_room_v2.json").write_text(
        (root / "benchmark/configs/llff_room.json").read_text())
    (root / "benchmark/traffic/step1_vit0.json").write_text(json.dumps(
        {"leg": "train", "flags": ["--vit_weight", "0"], "warmup_steps": 10, "checked_steps": 3,
         "control_precision": "fp8"}))
    (root / "benchmark/limits/llff_room_v2.step1_vit0.json").write_text(json.dumps({"loss_gap": 1e-5}))
    (root / "benchmark/metrics/launches.train.py").write_text("def read(ctx):\n    return 7.0\n")
    new["configs"] = bench["configs"] + [{**bench["configs"][0], "name": "llff_room_v2",
                                          "file": "benchmark/configs/llff_room_v2.json"}]
    new["workloads"] = bench["workloads"] + [{"name": "llff_room_v2.step1_vit0", "config": "llff_room_v2",
                                              "traffic": "step1_vit0", "chips": 1, "why": "no ViT"}]
    new["per_layer"] = bench["per_layer"] + [{"name": "launches.train", "unit": "count", "better": "lower",
                                              "source": "program_counter", "layer": "step",
                                              "moves": "train_step_ms",
                                              "workloads": ["llff_room_v2.step1_vit0"]}]
    cell = spec.load_cell("llff_room_v2.step1_vit0", root=str(root), bench=new, bench_dir=str(root / "benchmark"))
    assert cell.traffic["flags"] == ["--vit_weight", "0"] and cell.limits == {"loss_gap": 1e-5}
    assert [m["name"] for m in cell.per_layer] == ["launches.train"]
    assert spec.reader("launches.train", bench_dir=str(root / "benchmark"))(None) == 7.0
    assert all(p.read_bytes() == data for p, data in before.items())

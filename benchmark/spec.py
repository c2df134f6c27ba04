"""What a cell is, found by name: ``BENCHMARK.json`` at the root of the
checkout names the cells, their configurations and metrics; each piece
lives in a file of its own, so that a later change adds files and edits
none:

* a configuration: the ``file`` its entry names (``benchmark/configs/``);
* a traffic mix: ``benchmark/traffic/<traffic>.json``;
* a cell's correctness limits: ``benchmark/limits/<workload>.json``;
* a per-layer metric's reader: ``benchmark/metrics/<metric>.py``, a module
  with ``read(ctx) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict[str, Any]     # the configuration file's contents
    traffic: Dict[str, Any]    # the traffic file's contents
    limits: Dict[str, float]   # number compared -> its limit
    end_to_end: List[Dict[str, Any]]  # the cell's end-to-end metric entries
    per_layer: List[Dict[str, Any]]   # the cell's per-layer metric entries


def _read_json(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict[str, Any], workload: str, reported: Optional[set] = None) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load_cell(workload: str, root: str = ROOT, bench: Optional[Dict[str, Any]] = None,
              bench_dir: str = HERE) -> Cell:
    """The cell ``workload`` of ``root``'s ``BENCHMARK.json`` (or of
    ``bench``) with its files read: the configuration's ``file`` under
    ``root``, the traffic and limits under ``bench_dir``."""
    bench = bench if bench is not None else _read_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=_read_json(os.path.join(root, cfg_entry["file"])),
        traffic=_read_json(os.path.join(bench_dir, "traffic", f"{entry['traffic']}.json")),
        limits=_read_json(os.path.join(bench_dir, "limits", f"{workload}.json")),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def reader(metric: str, bench_dir: str = HERE) -> Callable[[Any], Optional[float]]:
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read

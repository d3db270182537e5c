"""Discovery by name: the cells, configurations, traffic mixes, limits and
per-layer metric readers that ``BENCHMARK.json`` names.

Each lives in a file of its own under the benchmark's folder, so a cell or
a metric is added by adding files and entries:

  configs/<config>.json     the configuration as it is run (its ``file``)
  traffic/<traffic>.json    a traffic mix: the scenes and the draws
  limits/<workload>.json    the limits of the numbers ``correct`` compares
  metrics/<metric>.py       a per-layer metric's reader, ``read(ctx)``
  gdbench/<driver>.py       the driver a configuration's ``driver`` names
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list  # metric entries this cell reports with --trace 0
    per_layer: list  # metric entries this cell reports with --trace 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # without the key: every cell that reports the metric it moves
    return metric.get("moves", metric["name"]) in e2e_names


def find_cell(name: str, bench_path: Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (at the repository root),
    with its configuration, traffic, limits and metrics.  Raises KeyError
    for an unknown cell and FileNotFoundError for a missing file."""
    bench_path = bench_path or ROOT / "BENCHMARK.json"
    bench = load_json(bench_path)
    base = bench_path.parent
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name, e2e_names)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config_name=w["config"], config=load_json(base / cfg_entry["file"]),
        traffic_name=w["traffic"],
        traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH_DIR / "limits" / f"{name}.json")["limits"],
        end_to_end=e2e, per_layer=per_layer,
    )


def load_driver(name: str):
    """The driver module ``gdbench/<name>.py`` that a configuration's
    ``driver`` names: ``run(cell, seed, seconds, traced, clock, device=None)``
    sets up its own devices (and ranks) and returns a ``RunResult``;
    ``control(cell, device, seed)`` and ``faults()`` give the control and
    the faults of its cells."""
    return importlib.import_module(f"gdbench.{name}")


def load_reader(metric: str, metrics_dir: Path | None = None):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = (metrics_dir or BENCH_DIR / "metrics") / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "gdbench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(entries, ctx, metrics_dir: Path | None = None) -> dict:
    """{name: {"value", "unit"}} of each per-layer entry whose reader finds
    something to read; a reader that returns None leaves its metric out."""
    out = {}
    for m in entries:
        value = load_reader(m["name"], metrics_dir)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out

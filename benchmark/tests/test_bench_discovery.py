"""Discovery by name, and BENCHMARK.json against the benchmark's
contract: each configuration, traffic mix, limits file and per-layer
reader sits in a file of its own that the harness finds by name."""

import json
import re

import pytest

from gdbench import registry
from conftest import BENCH_DIR

BENCH = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_is_found_with_its_files(name):
    cell = registry.find_cell(name)
    driver = registry.load_driver(cell.config["driver"])
    assert callable(driver.run) and callable(driver.control)
    assert driver.faults()
    assert cell.limits, "a cell has limits for every number it compares"
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    moved = {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert m["moves"] in moved
        assert callable(registry.load_reader(m["name"]))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        registry.find_cell("no_such_cell")


def test_readers_left_silent_without_a_trace():
    ctx = {"driver": "sim", "setup": {"scene_compile_s": 1.5},
           "trace": None}
    entries = [m for m in BENCH["per_layer"]]
    out = registry.read_metrics(entries, ctx)
    assert out == {"scene_compile_s": {"value": 1.5, "unit": "s"}}


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert NAME.match(c["name"]) and len(c["why"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert w["config"] in names and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(CELLS) // 4)
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_files_are_found_by_name():
    for w in BENCH["workloads"]:
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").exists()
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").exists()
    for m in BENCH["per_layer"]:
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").exists()


def test_scene_kinds_are_found_by_name():
    from gdbench import common

    spec = {"kind": "dir", "dir": "data/pool_v3", "count": 3}
    paths = common.scene_paths(spec)
    assert len(paths) == 3 and paths == sorted(paths)
    with pytest.raises(ModuleNotFoundError):
        common.scene_paths({"kind": "no_such_kind"})

"""The per-layer metrics that read the port's spans: a traced run of a sim
cell and of the train cell reports each metric its cell lists."""

import json

import pytest

from conftest import BENCH_DIR, execute_cpu, tiny_cell

BENCH = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
SPAN_METRICS = [m for m in BENCH["per_layer"]
                if m["source"] == "program_span"]


@pytest.mark.parametrize("name", ["sim_pool512", "train_pool512"])
def test_a_traced_run_reads_the_span_metrics(name):
    from gpudrive_lab_torch.utils import profiling

    profiling.clear()  # records of an earlier traced run in this process
    out = execute_cpu(tiny_cell(name), traced=True)
    profiling.clear()
    assert out["correct"], out["checks"]
    want = {m["name"] for m in SPAN_METRICS if name in m["workloads"]}
    got = {k: v["value"] for k, v in out["metrics"].items()
           if k in {m["name"] for m in SPAN_METRICS}}
    assert want and set(got) == want, got
    assert all(v > 0 for v in got.values()), got

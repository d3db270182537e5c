"""The correctness check decides right at a CPU test's size: a sound run
of the program is correct; the control (the reference in the precision
below the configuration's, in the program's place) and each fault a cell
can have, planted under the timed path, are not.  The harness's look for a
chip is skipped (run.execute on the CPU)."""

import pytest
import torch

from conftest import execute_cpu, tiny_cell
from gdbench import faults, registry

SIM_CELLS = ["sim_pool512", "sim_largemap256"]


def failed(out: dict) -> list:
    return [k for k, c in out["checks"].items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("name", SIM_CELLS + ["train_pool512"])
def test_a_sound_run_is_correct(name):
    out = execute_cpu(tiny_cell(name))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def test_a_traced_run_reads_the_per_layer_metrics():
    out = execute_cpu(tiny_cell("sim_pool512"), traced=True)
    assert out["correct"]
    assert "scene_compile_s" in out["metrics"]
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", SIM_CELLS + ["train_pool512"])
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    driver = registry.load_driver(cell.config["driver"])
    with driver.control(cell, torch.device("cpu"), 11):
        out = execute_cpu(cell, seed=11)
    assert not out["correct"], out["checks"]


# ---- faults planted under the timed path --------------------------------

@pytest.mark.parametrize("fault", sorted(faults.SIM))
@pytest.mark.parametrize("name", SIM_CELLS)
def test_sim_faults_are_not_correct(name, fault):
    with faults.SIM[fault]():
        out = execute_cpu(tiny_cell(name))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_train_faults_are_not_correct(fault):
    with faults.TRAIN[fault]():
        out = execute_cpu(tiny_cell("train_pool512"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 8200000009])
def test_checked_runs_cross_the_reset(seed):
    from gdbench import sim

    starts = sim.sample_chains(seed, 2000, 3, 96)
    steps = [s + i for s in starts for i in range(sim.CHAIN)]
    assert len(starts) == 3 and len(set(steps)) == len(steps)
    assert max(steps) < 2000
    # one run has in its middle the step after which the episodes begun
    # at reset end: window step e with 96 + e + 1 steps taken (85, 176, ..)
    assert any((96 + (s + 1) + 1) % sim.EPISODE == 0 for s in starts)

"""Shared helpers of the benchmark's CPU tests: the harness's folder on the
import path and tiny copies of the cells, small enough for the CPU."""

import copy
import sys
import time
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]

from gdbench import registry  # noqa: E402


def tiny_cell(name: str):
    """Cell ``name`` of BENCHMARK.json cut to a CPU test's size: 4 pool
    worlds or 2 large-map worlds; a warm-up that ends 3 steps before the
    episodes do, so the window's first checked run crosses their reset;
    for training 2 epochs of 2 minibatches and 64 rows (the warm-up's
    third rollout of 32 steps still crosses the reset)."""
    cell = registry.find_cell(name)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config = copy.deepcopy(cell.config)
    scenes = cell.traffic["scenes"]
    if scenes["kind"] == "dir":
        scenes["count"] = 4
    else:
        scenes["W"] = 2
    cell.traffic.update(warmup_steps=88, trace_seconds=0.5,
                        trace_iterations=1, reference_workers=0)
    if cell.config["driver"] == "train":
        cell.config["ppo"].update(num_minibatches=2, update_epochs=2,
                                  compact=64)
    return cell


def execute_cpu(cell, seed: int = 2**31 + 7, seconds: float = 0.5,
                traced: bool = False) -> dict:
    """One run of ``cell`` on the CPU through run.py's ``execute``."""
    import torch

    import run

    t0 = time.perf_counter()
    return run.execute(cell, seed, seconds, traced,
                       lambda: time.perf_counter() - t0, torch.device("cpu"))


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, never while
    the test module is imported)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)

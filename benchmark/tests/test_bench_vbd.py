"""The VBD cell on the CPU at a small size: its files found by name, the
operation count of ``gdbench/vbd_flops.py`` against torch's own counter on
the port's model, the new readers silent where they have nothing to read,
a sound run correct with every span metric read, and the control and each
fault not correct."""

import copy
import dataclasses
from types import SimpleNamespace

import pytest
import torch

from conftest import execute_cpu
from gdbench import registry, vbd, vbd_flops

CELL = "vbd_official128"
NEW_METRICS = {"vbd_encode_ms.vbd", "vbd_denoise_ms.vbd",
               "vbd_prepare_ms.vbd", "idle_share.vbd", "vbd_mfu"}
SPAN_METRICS = {"vbd_encode_ms.vbd", "vbd_denoise_ms.vbd",
                "vbd_prepare_ms.vbd"}


def tiny_vbd_cell():
    """The cell at a CPU test's size: 2 pool worlds, 8 agents, 3 diffusion
    steps, one encoder layer (every width as published), one traced
    episode, reference blocks of one world."""
    cell = registry.find_cell(CELL)
    cell.traffic = copy.deepcopy(cell.traffic)
    cell.config = copy.deepcopy(cell.config)
    cell.traffic["scenes"]["count"] = 2
    cell.traffic.update(trace_episodes=1, reference_block=1)
    cell.config["model"].update(agents_len=8, diffusion_steps=3,
                                encoder_layers=1)
    return cell


def failed(out: dict) -> list:
    return [k for k, c in out["checks"].items() if c["value"] > c["limit"]]


def test_the_cell_and_its_files_are_found():
    cell = registry.find_cell(CELL)
    assert cell.config["driver"] == "vbd" and cell.chips == 1
    assert cell.config["reduced"] == []
    assert cell.traffic["scenes"] == {"kind": "dir", "dir": "data/pool_v3",
                                      "count": 128}
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "agent_steps_per_s", "peak_mem_gib"}
    assert {m["name"] for m in cell.per_layer} == NEW_METRICS
    for m in cell.per_layer:
        assert m["moves"] == "agent_steps_per_s"
        assert callable(registry.load_reader(m["name"]))
    from gpudrive_lab_torch.vbd import model_official as mo

    ocfg = vbd.model_config(cell.config)
    assert ocfg == mo.OfficialVBDConfig()  # the published configuration


def test_flops_match_torchs_counter():
    """The count of one sample against FlopCounterMode on the port's model
    (published widths; 2 worlds, 8 agents, 16 polylines, 2 encoder layers,
    2 diffusion steps), within 1 %."""
    from torch.utils.flop_counter import FlopCounterMode

    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.rollout import SLICE_CONFIG, pool_scene_paths
    from gpudrive_lab_torch.vbd import model_official as mo
    from gpudrive_lab_torch.vbd.data_utils import (
        VBDSampleConfig,
        official_inputs,
        process_scenario_data,
    )
    from gpudrive_lab_torch.vbd.model import DDPMScheduler

    root = str(registry.ROOT)
    env = GPUDriveTorchEnv(EnvConfig(**dict(SLICE_CONFIG,
                                            agent_bucket="auto")),
                           pool_scene_paths(root)[20:22], device="cpu")
    cfg = mo.OfficialVBDConfig(agents_len=8, diffusion_steps=2,
                               encoder_layers=2)
    model = mo.OfficialVBD(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    batch = process_scenario_data(env.scene, env.state, 0, VBDSampleConfig(
        max_agents=8, max_polylines=16))
    inputs = official_inputs(batch)
    with FlopCounterMode(display=False) as counter:
        mo.sample_official(model.eval(), DDPMScheduler(2), inputs, cfg,
                           torch.Generator().manual_seed(0))
    want = counter.get_total_flops()
    got = vbd_flops.sample_flops(
        dict(dataclasses.asdict(cfg), ffn_dim=mo.FFN), worlds=2,
        polylines=16, points=30, lights=16, history=11)
    assert abs(got - want) <= 0.01 * want, (got, want)


@pytest.mark.parametrize("metric", sorted(NEW_METRICS))
@pytest.mark.parametrize("kind", ["sim", "train"])
def test_a_new_reader_is_silent_in_the_other_cells(metric, kind):
    trace = SimpleNamespace(window_s=2.0, busy_s=1.0)
    ctx = {"driver": kind, "trace": trace, "steps_traced": 3,
           "iterations_traced": 2, "device": torch.device("cpu"),
           "episode_s": 1.0}
    assert registry.load_reader(metric)(ctx) is None


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS | {"vbd_mfu"}))
def test_a_new_reader_is_silent_without_its_spans_or_counts(metric):
    from gpudrive_lab_torch.utils import profiling

    profiling.clear()
    trace = SimpleNamespace(window_s=2.0, busy_s=1.0)
    ctx = {"driver": "vbd", "trace": trace, "samples_traced": 1,
           "episodes": 1, "diffusion_steps": 3, "episode_s": 1.0,
           "device": torch.device("cuda"), "model": {}, "vbd_shapes": {}}
    read = registry.load_reader(metric)
    # a port without the sampler's counts
    assert read(dict(ctx, counts_traced=None, counts_window=None)) is None
    if metric in SPAN_METRICS:  # counts, but no span records
        assert read(dict(ctx, counts_traced=(1, 3))) is None
    else:  # counts of another number of steps than a sample has
        assert read(dict(ctx, counts_window=(1, 2))) is None


def test_a_sound_run_is_correct_and_reads_the_span_metrics():
    from gpudrive_lab_torch.utils import profiling

    profiling.clear()
    out = execute_cpu(tiny_vbd_cell(), traced=True)
    profiling.clear()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    got = {k: v["value"] for k, v in out["metrics"].items()}
    # vbd_mfu reads a card's window only
    assert set(got) == NEW_METRICS - {"vbd_mfu"}, got
    assert all(v > 0 for v in got.values()), got
    untraced = execute_cpu(tiny_vbd_cell())
    assert untraced["correct"], untraced["checks"]
    assert set(untraced["metrics"]) == {"setup_s", "agent_steps_per_s",
                                        "peak_mem_gib"}


def test_the_control_is_not_correct():
    cell = tiny_vbd_cell()
    with vbd.control(cell, torch.device("cpu"), 11):
        out = execute_cpu(cell, seed=11)
    assert failed(out), out["checks"]
    assert set(failed(out)) <= {"encodings_gap", "relation_encodings_gap",
                                "denoise_gap"}


@pytest.mark.parametrize("fault", sorted(vbd.faults()))
def test_each_fault_is_not_correct(fault):
    with vbd.faults()[fault]():
        out = execute_cpu(tiny_vbd_cell())
    assert failed(out), out["checks"]

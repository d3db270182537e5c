"""Every example of the PyTorch port (examples/torch/) runs headless on the
CPU (``--device cpu``, matplotlib's Agg) at the arguments of
tests/test_examples.py, on the repository's scenes.  Where an example
prints numbers no random draw decides (01's obs shape and controlled
counts, 02's goal figures, 07's counts), they equal what the JAX example
prints on the same scenes; the others are held to their printed keys.
The keyboard controller, the fly camera and the VBD trajectory source are
also driven in process."""

import ast
import json
import os
import runpy
import sys

import matplotlib

matplotlib.use("Agg", force=True)

import numpy as np
import pytest
import torch

from torch_parity import ROOT

TORCH_DIR = os.path.join(ROOT, "examples", "torch")
JAX_DIR = os.path.join(ROOT, "examples")
DATA_DIR = os.path.join(ROOT, "tests", "data")
SCENE = os.path.join(DATA_DIR, "tfrecord_synthetic_0.json")
NAMES = ["01_simulate.py", "02_expert_replay.py", "03_policy_rollout.py",
         "04_imitation_learning.py", "05_interactive_viewer.py",
         "06_vbd_sim_agents.py", "07_behavior_diversity.py",
         "08_il_analysis.py", "09_pretrained_policy.py"]


def _run(directory, name, argv, capsys):
    """Execute an example as __main__ with ``argv``; its standard
    output."""
    import matplotlib.pyplot as plt

    capsys.readouterr()
    old_argv = sys.argv
    sys.argv = ["x"] + argv
    try:
        runpy.run_path(os.path.join(directory, name), run_name="__main__")
    finally:
        sys.argv = old_argv
        plt.close("all")
    return capsys.readouterr().out


def _port(name, argv, capsys, device=True):
    return _run(TORCH_DIR, name, argv + (["--device", "cpu"] if device
                                         else []), capsys)


def _lines(out, *prefixes):
    return [ln for ln in out.splitlines() if ln.startswith(prefixes)]


def _load(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "example_" + name[:2], os.path.join(TORCH_DIR, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_every_jax_example_has_a_port():
    """One port example per JAX example, each parsing, each naming the
    same arguments as its original (plus --device)."""
    jax_names = sorted(f for f in os.listdir(JAX_DIR) if f.endswith(".py"))
    assert sorted(f for f in os.listdir(TORCH_DIR)
                  if f.endswith(".py")) == jax_names == NAMES

    def flags(path):
        tree = ast.parse(open(path).read(), filename=path)
        return {a.value for node in ast.walk(tree)
                if isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "add_argument"
                for a in node.args if isinstance(a, ast.Constant)}

    for name in NAMES:
        port = flags(os.path.join(TORCH_DIR, name))
        assert flags(os.path.join(JAX_DIR, name)) <= port, name
        assert port - flags(os.path.join(JAX_DIR, name)) <= {"--device"}


def test_example_01_simulate_matches_jax(capsys):
    port = _port("01_simulate.py", ["--scenes-dir", DATA_DIR], capsys)
    jax = _run(JAX_DIR, "01_simulate.py", ["--scenes-dir", DATA_DIR], capsys)
    keys = ("scenes:", "obs shape:", "controlled per world:")
    assert _lines(port, *keys) == _lines(jax, *keys)
    assert "obs shape: (2, 128, 3368)" in port
    for key in ("rewards:", "collisions so far:", "max speed on the road:"):
        (line,) = _lines(port, key)
        assert np.isfinite(float(line.split(":")[1]))


@pytest.mark.parametrize("controlled", [0, 2])
def test_example_02_expert_replay_matches_jax(capsys, controlled):
    argv = ["--scene", SCENE, "--controlled", str(controlled)]
    port = _port("02_expert_replay.py", argv, capsys)
    jax = _run(JAX_DIR, "02_expert_replay.py", argv, capsys)
    keys = ("agents:", "reached goal:", "collisions:")
    assert _lines(port, *keys) == _lines(jax, *keys)
    assert len(_lines(port, *keys)) == 3


def test_example_03_policy_rollout_runs(capsys):
    out = _port("03_policy_rollout.py", ["--scenes-dir", DATA_DIR], capsys)
    for name in ("policy_a", "policy_b"):
        (line,) = _lines(out, name)
        rates = ast.literal_eval(line[len(name):].strip())
        assert set(rates) == {"goal_achieved", "collided", "off_road"}
        assert all(0.0 <= v <= 1.0 for v in rates.values())


def test_example_04_imitation_learning_runs(capsys):
    out = _port("04_imitation_learning.py",
                ["--scene", SCENE, "--epochs", "1"], capsys)
    assert _lines(out, "dataset:") and _lines(out, "epoch 0: gmm nll")
    rates = json.loads(out.strip().splitlines()[-1])
    assert set(rates) == {"goal_rate", "collision_rate", "off_road_rate"}
    assert all(0.0 <= v <= 1.0 for v in rates.values())


def test_example_05_interactive_viewer_runs(capsys):
    # Agg: the figure builds, the handlers register, plt.show returns
    _port("05_interactive_viewer.py", ["--scene", SCENE], capsys)
    _port("05_interactive_viewer.py", ["--scene", SCENE, "--fly"], capsys)


def test_keyboard_controller_and_fly_camera():
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv

    mod = _load("05_interactive_viewer.py")
    env = GPUDriveTorchEnv(EnvConfig(num_worlds=1), [SCENE], device="cpu")
    env.reset()
    ctl = mod.KeyboardController(env)
    first = ctl.agent_idx
    acts = ctl.actions_for_key("w")
    assert tuple(acts.shape) == (1, env.max_agent_count, 10)
    assert float(acts[0, first, 0]) == 2.0 and int((acts != 0).sum()) == 1
    before = env.state.pos[0, first].clone()
    after = ctl.step("w")
    assert not np.allclose(after, before.numpy())
    ctl.replay_step()
    assert int(env.world_time_steps[0]) == 2
    nxt = ctl.next_agent()
    assert nxt in list(ctl.candidates)
    if len(ctl.candidates) == 1:
        assert nxt == first
    fly = mod.FlyCamera(env, height=16, width=16)
    assert fly.handle_key("w") and fly.handle_key("i")
    assert not fly.handle_key("x")
    frame = fly.view()
    assert frame.shape == (16, 16, 4) and frame.dtype == np.uint8


def test_example_06_vbd_sim_agents_runs(capsys):
    out = _port("06_vbd_sim_agents.py",
                ["--scenes-dir", DATA_DIR, "--steps", "2"], capsys)
    steps = _lines(out, "step ")
    assert len(steps) == 2
    assert all(np.isfinite(float(s.split()[-1])) for s in steps)
    assert "obs dim with VBD block: 3823" in out  # 3368 + 91 * 5


def test_vbd_sim_agent_source_builds_trajectories():
    from gpudrive_lab_torch import constants as C
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv

    mod = _load("06_vbd_sim_agents.py")
    env = GPUDriveTorchEnv(
        EnvConfig(num_worlds=1, reward_type="distance_to_vdb_trajs",
                  use_vbd=True, vbd_in_obs=True), [SCENE], device="cpu")
    env.reset()
    env.set_vbd_trajectories(mod.build_source(None, device="cpu"))
    assert env.vbd_trajectories.shape[2] == C.TRAJECTORY_LEN
    expert = env.get_expert_actions()[0]
    env.step_dynamics(expert[:, :, 0])
    assert torch.isfinite(env.get_rewards()).all()
    assert env.get_obs().shape[-1] == 3368 + C.TRAJECTORY_LEN * 5


def _behavior_dir(tmp_path):
    """Synthetic scenes with U-turns and reversing, as JSON."""
    from gpudrive_lab_torch.data_utils.synthetic_womd import (
        synthetic_scenarios,
    )
    from gpudrive_lab_torch.data_utils.waymo_converter import (
        scenario_to_dict,
    )

    for i, sc in enumerate(synthetic_scenarios(4, seed=8, num_tracks=16)):
        d = scenario_to_dict(sc, f"tfrecord-b_{i}.json")
        (tmp_path / d["name"]).write_text(json.dumps(d))
    return str(tmp_path)


@pytest.mark.parametrize("where", ["tests_data", "synthetic"])
def test_example_07_behavior_diversity_matches_jax(capsys, tmp_path, where):
    scenes = DATA_DIR if where == "tests_data" else _behavior_dir(tmp_path)
    port = _port("07_behavior_diversity.py", ["--scenes-dir", scenes],
                 capsys, device=False)
    jax = _run(JAX_DIR, "07_behavior_diversity.py", ["--scenes-dir", scenes],
               capsys)
    keys = ("vehicles:", "u-turns:", "reversing:")
    assert _lines(port, *keys) == _lines(jax, *keys)
    assert len(_lines(port, *keys)) == 3
    # flagged scenes come in the workers' order of completion
    assert sorted(_lines(port, "   ")) == sorted(_lines(jax, "   "))
    if where == "synthetic":
        assert _lines(port, "   ")


def test_example_08_il_analysis_runs(capsys, tmp_path):
    out = _port("08_il_analysis.py",
                ["--scenes-dir", DATA_DIR, "--epochs", "1",
                 "--rollout-steps", "5", "--out", str(tmp_path / "il")],
                capsys)
    blobs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    keys = [sorted(b) for b in blobs]
    assert keys == [["bc_loss", "epoch"], ["probes"], ["closed_loop"],
                    ["intervention_changed_frac"]]
    assert np.isfinite(blobs[0]["bc_loss"])
    assert set(blobs[1]["probes"]) == {"ego", "partner"}
    assert 0.0 <= blobs[3]["intervention_changed_frac"] <= 1.0
    figures = sorted(os.listdir(tmp_path / "il"))
    assert "linear_probing.png" in figures
    assert "log_replay_comparison.png" in figures
    assert any(f.startswith("importance_head") for f in figures)


def test_example_09_pretrained_policy_runs(capsys, tmp_path):
    out = _port("09_pretrained_policy.py",
                ["--scenes-dir", DATA_DIR, "--steps", "5",
                 "--out", str(tmp_path / "frame.png")], capsys)
    assert "action_dim=91, hidden=128" in out
    (line,) = [ln for ln in out.splitlines() if ln.startswith("{")]
    rates = ast.literal_eval(line)
    assert set(rates) == {"goal_achieved", "collided", "off_road"}
    assert (tmp_path / "frame.png").exists()


def test_example_09_weights_equal_jax_example():
    """The offline checkpoint holds the JAX example's seeded weights."""
    from safetensors.numpy import load_file

    port = load_file(os.path.join(_load("09_pretrained_policy.py")
                                  .synth_checkpoint(), "model.safetensors"))
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_example_09", os.path.join(JAX_DIR, "09_pretrained_policy.py"))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    jax = load_file(os.path.join(jmod.synth_checkpoint(),
                                 "model.safetensors"))
    assert port.keys() == jax.keys()
    for k in port:
        np.testing.assert_array_equal(port[k], jax[k])

"""The port's env config, the rendering around the env (the SB3 wrapper's
videos, multi_policy_rollout's frames) and the PPO CLI's video hook and
dashboard, against the JAX package on the CPU.

  * ``EnvConfig`` and ``RenderConfig``: every field of the JAX dataclass
    is a field of the port's with an equal default; ``EnvConfig(
    num_worlds=...)`` builds, and, as in the JAX env, the world count comes
    from the scenes;
  * the SB3 wrapper with ``render`` and ``video_dir`` over one 91-step
    episode: every ninth frame equals the JAX visualizer's figure of the
    port's state at that step, and the GIFs have the JAX wrapper's names and frame
    counts;
  * ``multi_policy_rollout(render_sim_state=True)``: metrics equal to the
    JAX function's, frames equal to the JAX visualizer's figures of the
    port's states, and an env without a visualizer refused;
  * the CLI with ``--video-interval 1 --video-worlds 1`` for 2 iterations
    on 2 worlds: a GIF per iteration, the trainer's carry handed on
    unchanged across the hook, and parameters bit for bit those of the same
    run without videos; ``--dashboard`` silences the JSON lines.
"""

import dataclasses
import enum
import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from gpudrive_lab_tpu.agents import RandomActor as JaxRandomActor
from gpudrive_lab_tpu.env import config as jconfig
from gpudrive_lab_tpu.env.dataset import SceneDataLoader as JaxLoader
from gpudrive_lab_tpu.env.env_jax import GPUDriveTPUEnv
from gpudrive_lab_tpu.env.wrappers.sb3_wrapper import (
    SB3MultiAgentEnv as JaxSB3Env,
)
from gpudrive_lab_tpu.visualize.core import MatplotlibVisualizer as JaxVis
from gpudrive_lab_tpu.utils.multi_policy_rollout import (
    multi_policy_rollout as jax_multi_policy_rollout,
)
from gpudrive_lab_torch.agents import RandomActor
from gpudrive_lab_torch.env import config as tconfig
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.env.wrappers.sb3_wrapper import SB3MultiAgentEnv
from gpudrive_lab_torch.ppo import ppo as tppo
from gpudrive_lab_torch.ppo import train
from gpudrive_lab_torch.rollout import SLICE_CONFIG
from gpudrive_lab_torch.utils.multi_policy_rollout import multi_policy_rollout
from gpudrive_lab_torch.visualize import video as tvideo
from torch_parity import (
    POOL_SCENES,
    jax_figures,
    python_scene_compiler,
    record_states,
    scene_to_jax,
    state_to_jax,
)

PATHS = [POOL_SCENES[i] for i in (20, 21)]  # 5 and 6 controlled agents


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    if isinstance(a, enum.Enum):  # the two packages' own enum classes
        return (a.name, a.value) == (b.name, b.value)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("name", ["EnvConfig", "RenderConfig",
                                  "SceneConfig"])
def test_config_fields_match_jax(name):
    """Every field of the JAX dataclass is a field of the port's, with an
    equal default (the port's SceneConfig needs its two required fields)."""
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    args = (4, 10) if name == "SceneConfig" else ()
    jd, td = jcls(*args), tcls(*args)
    tfields = {f.name for f in dataclasses.fields(tcls)}
    for f in dataclasses.fields(jcls):
        assert f.name in tfields, f.name
        assert _equal(getattr(td, f.name), getattr(jd, f.name)), f.name


def test_env_config_builds_with_the_jax_fields():
    """The six size and count fields build; as in the JAX env, none is read
    (the world count is the scenes')."""
    kw = dict(num_worlds=5, max_num_agents_in_scene=64, max_num_rg_points=
              500, roadgraph_top_k=100, episode_len=50, agent_size_scale=1.0)
    env = GPUDriveTorchEnv(tconfig.EnvConfig(**kw), PATHS, device="cpu",
                           render_config=tconfig.RenderConfig())
    with python_scene_compiler():
        jenv = GPUDriveTPUEnv(jconfig.EnvConfig(**kw), scene_paths=PATHS)
    assert env.num_worlds == jenv.num_worlds == 2
    assert env.episode_len == jenv.episode_len
    assert env.observation_dim == jenv.observation_dim
    img = env.render(0)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    for i, k in enumerate((20, 21)):
        shutil.copy(POOL_SCENES[k], d / f"tfrecord-{i:02d}.json")
    return str(d)


def test_sb3_wrapper_renders_and_writes_videos(data_dir, tmp_path,
                                               monkeypatch):
    """render with render_k_scenarios 1 and video_dir, one 91-step episode
    of random actions (numpy draws from one seed for both packages)."""
    tdir, jdir = tmp_path / "torch", tmp_path / "jax"
    env = SB3MultiAgentEnv(tconfig.EnvConfig(**SLICE_CONFIG),
                           SceneDataLoader(data_dir, 2, 100), render=True,
                           render_k_scenarios=1, video_dir=str(tdir),
                           device="cpu")
    with python_scene_compiler():
        jenv = JaxSB3Env(jconfig.EnvConfig(**SLICE_CONFIG),
                         JaxLoader(data_dir, 2, 100), render=True,
                         render_k_scenarios=1, video_dir=str(jdir))
    assert (env.render, env.render_k_scenarios) == (
        jenv.render, jenv.render_k_scenarios)
    assert env.video_dir == str(tdir)
    states = []
    real = env.env.render

    def spy(w, zoom_radius=None):
        states.append(env.env.state)
        return real(w, zoom_radius=zoom_radius)

    monkeypatch.setattr(env.env, "render", spy)
    frames = []
    real_save = tvideo.save_video

    def save(fr, path, fps=15):
        frames.extend(fr)
        return real_save(fr, path, fps)

    monkeypatch.setattr(tvideo, "save_video", save)
    env.reset()
    jenv.reset()
    rng = np.random.default_rng(0)
    for _ in range(91):
        acts = rng.integers(0, 91, env.num_envs)
        env.step(torch.from_numpy(acts))
        jenv.step(acts)
    assert env.num_episodes == jenv.num_episodes > 0
    names = sorted(os.listdir(tdir))
    assert names == sorted(os.listdir(jdir)) == ["world_0_ep0.gif"]
    assert (Image.open(tdir / names[0]).n_frames
            == Image.open(jdir / names[0]).n_frames == len(frames) == 91)
    jvis = JaxVis(scene_to_jax(env.env.scene))
    for k in range(0, 91, 9):
        assert np.array_equal(frames[k], jvis.plot_simulator_state(
            state_to_jax(states[k]), [0])[0])


def test_multi_policy_rollout_renders(data_dir, monkeypatch):
    """Two RandomActors on disjoint halves of the controlled agents, 8
    steps, both worlds rendered."""
    loader = SceneDataLoader(data_dir, 2, 100)
    env = GPUDriveTorchEnv(tconfig.EnvConfig(**SLICE_CONFIG), device="cpu",
                           data_loader=loader)
    with python_scene_compiler():
        jenv = GPUDriveTPUEnv(jconfig.EnvConfig(**SLICE_CONFIG),
                              data_loader=JaxLoader(data_dir, 2, 100))
    ctrl = env.cont_agent_mask
    flat = torch.nonzero(ctrl.reshape(-1))[:, 0]
    half = torch.zeros(ctrl.numel(), dtype=torch.bool)
    half[flat[::2]] = True
    masks = {"a": half.reshape(ctrl.shape) & ctrl,
             "b": ~half.reshape(ctrl.shape) & ctrl}
    actors = {k: RandomActor(None, 91, seed=s) for k, s in (("a", 1),
                                                           ("b", 2))}
    jactors = {k: JaxRandomActor(None, 91, seed=s) for k, s in (("a", 1),
                                                               ("b", 2))}
    states = record_states(monkeypatch, env)
    got, frames = multi_policy_rollout(env, actors, masks, max_steps=8,
                                       render_sim_state=True,
                                       render_worlds=(0, 1))
    want, jframes = jax_multi_policy_rollout(
        jenv, jactors, {k: v.numpy() for k, v in masks.items()},
        max_steps=8, render_sim_state=True, render_worlds=(0, 1))
    assert got == want
    assert len(frames) == len(jframes) == 8
    for step, state in zip(frames, states[1:]):
        want_step = jax_figures(env.scene, state, [0, 1], zoom_radius=50.0)
        assert len(step) == 2
        assert all(np.array_equal(a, b) for a, b in zip(step, want_step))

    class NoVis:
        pass

    with pytest.raises(ValueError, match="vis"):
        multi_policy_rollout(NoVis(), actors, masks, render_sim_state=True)


def _cli_args(data_dir, ckpt, *extra):
    return ["--device", "cpu", "--num-worlds", "2", "--rollout-len", "8",
            "--num-minibatches", "2", "--update-epochs", "1",
            "--agent-bucket", "auto", "--compact", "16", "--compact-mode",
            "flat", "--fused-embed", "--total-timesteps", "100",
            "--log-interval", "1", "--checkpoint-path", str(ckpt),
            "--data-dir", data_dir, *extra]


def test_cli_video_hook_keeps_the_carry(data_dir, tmp_path, monkeypatch,
                                        capsys):
    """--video-interval 1 --video-worlds 1 --dashboard for 2 iterations:
    a 91-step video after each, the trainer's carry handed to the second
    iteration unchanged by the hook (the hook rolls the env's own state),
    and the same parameters, bit for bit, as the run without videos."""
    calls = []
    real = tppo.PPO.train_step

    def snap(carry):
        return [carry.state.pos.clone(), carry.world_time_steps.clone(),
                carry.rng.get_state()]

    def spy(self, scene, carry, *a, **k):
        before = snap(carry)
        out = real(self, scene, carry, *a, **k)
        calls.append((carry, before, out[0], snap(out[0])))
        return out

    monkeypatch.setattr(tppo.PPO, "train_step", spy)
    train.main(_cli_args(data_dir, tmp_path / "plain"))
    plain = capsys.readouterr().out
    assert len(calls) == 2
    calls.clear()
    train.main(_cli_args(data_dir, tmp_path / "video", "--video-interval",
                         "1", "--video-worlds", "1", "--dashboard"))
    out = capsys.readouterr().out
    (_, _, carry1, after1), (carry2, before2, _, _) = calls
    assert carry2 is carry1
    for a, b in zip(after1, before2):
        assert torch.equal(a, b)
    got = torch.load(tmp_path / "video" / train.CHECKPOINT)
    want = torch.load(tmp_path / "plain" / train.CHECKPOINT)
    assert got["global_step"] == want["global_step"] == 160
    for k, v in want["policy"].items():
        assert torch.equal(got["policy"][k], v), k
    videos = sorted(os.listdir(tmp_path / "video" / "videos"))
    assert videos == ["world0_step160.gif", "world0_step80.gif"]
    for v in videos:
        assert Image.open(tmp_path / "video" / "videos" / v).n_frames == 92
    # the dashboard silences the JSON lines (stdout is no tty here, so
    # it draws nothing); the metrics file still has them
    lines = [json.loads(s) for s in out.splitlines() if s.startswith("{")]
    assert lines == [{"final_global_step": 160}]
    assert sum(s.startswith("{") for s in plain.splitlines()) == 3
    logged = [json.loads(s) for s in Path(
        tmp_path / "video" / "ppo.metrics.jsonl").read_text().splitlines()]
    assert [r["videos"] for r in logged if "videos" in r] == [
        [str(tmp_path / "video" / "videos" / "world0_step80.gif")],
        [str(tmp_path / "video" / "videos" / "world0_step160.gif")]]

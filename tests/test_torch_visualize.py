"""The port's visualizer and rollout videos (gpudrive_lab_torch/visualize/)
against the JAX package's, on the CPU.

Both visualizers get the same values: the port's scene and state, crossed
to the JAX package through numpy.  The same floats go through the same
matplotlib calls, so every figure must equal the JAX figure pixel for pixel
(``np.array_equal``), in one process (fonts and dpi may differ between
matplotlib versions, so nothing is compared against stored images).

Two pool_v3 worlds cover a crosswalk (scene 3) and a stop sign (scene 0);
two road rows of world 0 are made a speed bump and an untyped box, so that
every road branch is drawn.  A rollout's frames are held against the JAX
visualizer's figures of the port's own states, exactly; against the JAX
env's own rollout they may differ where the two packages' float32 states
differ by an ulp and move an anti-aliased edge, so that comparison is
exact at the reset frame and bounded by a pixel fraction afterwards.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.env.config import EnvConfig as JaxEnvConfig
from gpudrive_lab_tpu.env.config import RenderConfig as JaxRenderConfig
from gpudrive_lab_tpu.env.env_jax import GPUDriveTPUEnv
from gpudrive_lab_tpu.visualize import utils as jutils
from gpudrive_lab_tpu.visualize import video as jvideo
from gpudrive_lab_tpu.visualize.core import MatplotlibVisualizer as JaxVis
from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.env.config import EnvConfig, RenderConfig
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionPolicy,
    PolicyConfig,
)
from gpudrive_lab_torch.rollout import SLICE_CONFIG
from gpudrive_lab_torch.visualize import utils as tutils
from gpudrive_lab_torch.visualize import video as tvideo
from gpudrive_lab_torch.visualize.core import MatplotlibVisualizer
from torch_parity import (
    POOL_SCENES,
    jax_figures,
    python_scene_compiler,
    record_states,
    scene_to_jax,
    state_to_jax,
)

PATHS = [POOL_SCENES[3], POOL_SCENES[0]]  # a crosswalk; a stop sign
# A rollout's frames against the JAX env's own rollout: the share of pixels
# that may differ per frame (measured at most 3.6e-4 over 91 steps on
# pool_v3 scenes 20 and 21, where the states differ by float32 ulps).
CROSS_ENV_PIXELS = 1e-3


def _stepped_env(steps=6, seed=0):
    env = GPUDriveTorchEnv(EnvConfig(**SLICE_CONFIG), PATHS, device="cpu",
                           render_config=RenderConfig())
    roads = env.scene.roads
    etype = roads.etype.clone()
    live = torch.nonzero(roads.valid[0])[:, 0]
    etype[0, live[0]] = C.ET_SPEED_BUMP
    etype[0, live[1]] = C.ET_NONE  # drawn as a translucent box
    env.scene = env.scene.replace(roads=roads.replace(etype=etype))
    env.reset()
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        env.step_dynamics(torch.randint(
            0, env.action_space_n, (env.num_worlds, env.max_agent_count),
            generator=g))
    return env


@pytest.fixture(scope="module")
def stepped():
    env = _stepped_env()
    # one agent of world 1 collided and one reached its goal, so that
    # every state colour is drawn
    flag = torch.zeros_like(env.state.collided)
    idx = torch.nonzero(env.scene.agents.valid[1])[:, 0]
    flag[1, idx[0]] = 1
    goal = torch.zeros_like(flag)
    goal[1, idx[1]] = 1
    env.state = env.state.replace(collided=flag, reached_goal=goal)
    return env


CASES = {
    "2d": dict(),
    "2d zoomed, expert trajectories, policy masks, centred": dict(
        zoom_radius=40.0, draw_expert_trajectories=True, policy="masks",
        center_agent_indices=[0, 1]),
    "2d zoomed on the live agents' mean": dict(zoom_radius=30.0),
    "3d": dict(render_3d=True),
    "3d zoomed, expert trajectories": dict(
        render_3d=True, zoom_radius=60.0, draw_expert_trajectories=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plot_simulator_state_matches_jax(stepped, case):
    kw = dict(CASES[case])
    render_3d = kw.pop("render_3d", False)
    env = stepped
    if kw.pop("policy", None):
        ctrl = env.scene.agents.controlled
        first = torch.zeros_like(ctrl)
        first[:, :2] = True
        kw["policy_masks"] = [first & ctrl, ~first & ctrl]
    cfg, jcfg = RenderConfig(render_3d=render_3d), JaxRenderConfig(
        render_3d=render_3d)
    got = MatplotlibVisualizer(env.scene, cfg).plot_simulator_state(
        env.state, [0, 1], **kw)
    jkw = dict(kw)
    if "policy_masks" in jkw:
        jkw["policy_masks"] = [m.numpy() for m in jkw["policy_masks"]]
    want = jax_figures(env.scene, env.state, [0, 1], jcfg, **jkw)
    assert len(got) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.ndim == 3 and g.shape[2] == 3
        assert g.std() > 0
        assert np.array_equal(g, w)


def test_single_figures_match_jax(stepped):
    """return_single_figure: the figures, turned into arrays by each
    package's img_from_fig."""
    env = stepped
    figs = MatplotlibVisualizer(env.scene).plot_simulator_state(
        env.state, [1], zoom_radius=50.0, return_single_figure=True)
    jfigs = JaxVis(scene_to_jax(env.scene)).plot_simulator_state(
        state_to_jax(env.state), [1], zoom_radius=50.0,
        return_single_figure=True)
    assert np.array_equal(tutils.img_from_fig(figs[0]),
                          jutils.img_from_fig(jfigs[0]))


def test_plot_agent_observation_matches_jax(stepped):
    env = stepped
    ctrl = torch.nonzero(env.scene.agents.controlled[1])[:, 0]
    for agent in ctrl[:2].tolist():
        fig = env.vis.plot_agent_observation(env.state, 1, agent,
                                             observation_radius=40.0)
        jfig = JaxVis(scene_to_jax(env.scene)).plot_agent_observation(
            state_to_jax(env.state), 1, agent, observation_radius=40.0)
        assert np.array_equal(tutils.img_from_fig(fig),
                              jutils.img_from_fig(jfig))


def _overlay(name, vis, state, positions, importance, ego):
    if name == "importance":
        return vis.plot_importance_weight(state, 0, importance, ego,
                                          zoom_radius=50.0)
    if name == "importance, unzoomed":
        return vis.plot_importance_weight(state, 0, importance, ego)
    if name == "linear probing":
        return [vis.plot_linear_probing(
            state, 0, ego, ego_pred=[3, 4, 5], ego_pred_prime=[3, 3, 3],
            partner_pred=[10, 11, 12], partner_log_cells=[10, 10, 11])]
    return [vis.plot_log_replay_comparison(positions, 0)]


@pytest.mark.parametrize("name", ["importance", "importance, unzoomed",
                                  "linear probing", "log replay"])
def test_il_overlays_match_jax(name):
    """The three IL overlays (reference: visualize/core.py:1641-1873) on a
    short rollout's state and positions; importance [H, A-1] drawn with
    numpy from a seed (the port also takes it as a tensor)."""
    env = _stepped_env(steps=0)
    pos = [env.state.pos]
    g = torch.Generator().manual_seed(3)
    for _ in range(5):
        env.step_dynamics(torch.randint(
            0, env.action_space_n, (2, env.max_agent_count), generator=g))
        pos.append(env.state.pos)
    positions = torch.stack(pos)  # [T, W, A, 2]
    importance = np.random.default_rng(0).random(
        (4, env.max_agent_count - 1)).astype(np.float32)
    ego = int(torch.nonzero(env.scene.agents.controlled[0])[0, 0])
    got = _overlay(name, env.vis, env.state, positions,
                   torch.from_numpy(importance), ego)
    want = _overlay(name, JaxVis(scene_to_jax(env.scene)),
                    state_to_jax(env.state), positions.numpy(), importance,
                    ego)
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


def test_env_render_follows_the_scene():
    """``vis`` is built once per scene and rebuilt when the scene is
    replaced; ``render`` is world ``env_idx`` at the current state."""
    env = _stepped_env(steps=2)
    vis = env.vis
    assert env.vis is vis
    img = env.render(1, zoom_radius=80.0)
    assert np.array_equal(
        img, jax_figures(env.scene, env.state, [1], zoom_radius=80.0)[0])
    env.scene = env.scene.replace()
    assert env.vis is not vis and env.vis.scene is env.scene


@pytest.fixture(scope="module")
def rollout_envs():
    paths = [POOL_SCENES[i] for i in (20, 21)]
    env = GPUDriveTorchEnv(EnvConfig(**SLICE_CONFIG), paths, device="cpu")
    with python_scene_compiler():
        jenv = GPUDriveTPUEnv(JaxEnvConfig(**SLICE_CONFIG), scene_paths=paths)
    return env, jenv


def test_render_rollout_matches_jax(rollout_envs, monkeypatch):
    """render_rollout with the JAX function's own random draws
    (``np.random.default_rng(0)``) handed in as ``policy_fn``: each frame
    equals the JAX visualizer's figure of the port's state at that step,
    the reset frame equals the JAX rollout's, and the later frames differ
    from the JAX rollout's in at most CROSS_ENV_PIXELS of their pixels."""
    env, jenv = rollout_envs
    steps = 20
    want = jvideo.render_rollout(jenv, env_idx=1, max_steps=steps)
    rng = np.random.default_rng(0)

    def draws(obs):
        return torch.from_numpy(rng.integers(
            0, jenv.action_space_n, (jenv.num_worlds, jenv.max_agent_count)))

    states = record_states(monkeypatch, env)
    got = tvideo.render_rollout(env, draws, env_idx=1, max_steps=steps)
    assert len(got) == len(want) == len(states) == steps + 1
    for frame, state in zip(got, states):
        assert np.array_equal(frame, jax_figures(
            env.scene, state, [1], zoom_radius=80.0)[0])
    assert np.array_equal(got[0], want[0])
    for a, b in zip(got, want):
        assert (a != b).any(-1).mean() <= CROSS_ENV_PIXELS


def test_render_rollout_draws_from_the_generator(rollout_envs):
    """Without policy_fn the actions are uniform draws from the given
    generator: two runs with generators of one seed give the same
    frames."""
    env, _ = rollout_envs
    a = tvideo.render_rollout(env, env_idx=0, max_steps=3,
                              generator=torch.Generator().manual_seed(5))
    b = tvideo.render_rollout(env, env_idx=0, max_steps=3,
                              generator=torch.Generator().manual_seed(5))
    assert len(a) == 4 and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_render_training_videos(rollout_envs, tmp_path):
    """The training hook writes world0_step123.gif (as the JAX hook does,
    tests/test_periphery.py:181-207) with argmax actions of the port's
    policy and leaves the env freshly reset."""
    env, _ = rollout_envs
    policy = LateFusionPolicy(PolicyConfig(action_dim=env.action_space_n),
                              device="cpu",
                              generator=torch.Generator().manual_seed(0))
    paths = tvideo.render_training_videos(env, policy, tmp_path,
                                          global_step=123, max_steps=3)
    assert len(paths) == 1 and paths[0].endswith("world0_step123.gif")
    assert os.path.getsize(paths[0]) > 0
    assert int(env.world_time_steps.abs().sum()) == 0
    fresh = env.state
    env.reset()
    assert torch.equal(env.state.pos, fresh.pos)


def test_save_video_formats(tmp_path):
    """.gif through Pillow; .mp4 through ffmpeg where it is installed and
    as a .gif beside the target otherwise, as the JAX function does.  The
    GIF holds every frame."""
    from PIL import Image

    frames = [np.full((40, 60, 3), 40 * i, np.uint8) for i in range(4)]
    gif = tvideo.save_video(frames, tmp_path / "a.gif")
    assert gif == str(tmp_path / "a.gif")
    assert Image.open(gif).n_frames == 4
    want = jvideo.save_video(frames, str(tmp_path / "j.gif"))
    assert open(gif, "rb").read() == open(want, "rb").read()
    mp4 = tvideo.save_video(frames, tmp_path / "b.mp4")
    ext = ".mp4" if shutil.which("ffmpeg") else ".gif"
    assert mp4 == str(tmp_path / ("b" + ext)) and os.path.getsize(mp4) > 0


def test_drawing_primitives_match_jax():
    """box_corners and stripe_polygons: the same numpy on both sides."""
    args = (3.0, -2.0, 0.7, 2.5, 1.0)
    np.testing.assert_array_equal(tutils.box_corners(*args),
                                  jutils.box_corners(*args))
    np.testing.assert_array_equal(tutils.stripe_polygons(*args, 5),
                                  jutils.stripe_polygons(*args, 5))


"""The env's VBD parts against the JAX env, on the CPU: the 455-float VBD
observation block (with frame stacking) and the ``distance_to_vdb_trajs``
reward, over 12 steps on 3 pool scenes, with each trajectory source: the
default log replay, an array, a seeded ``VBDTrajectorySource`` and a seeded
``OfficialVBDSource``; the trajectories kept across a swap, and padded where
a swap grows the agent rows (where the JAX env fails).

Bars: observations within 1e-5 (road rows as sets; the VBD block in
order, within 1e-5 of its largest magnitude: torch_parity.assert_obs_match
says why), rewards within 1e-6, dones and masks exact.  A sampled source's
trajectories are held to the JAX source's (the same weights and draws)
within 1e-3 absolute, the samplers' bar; the JAX env then gets the port's
trajectories, so that the env itself is held to the bars above.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.env.config import EnvConfig as JaxEnvConfig
from gpudrive_lab_tpu.env.dataset import SceneDataLoader as JaxLoader
from gpudrive_lab_tpu.env.env_jax import GPUDriveTPUEnv
from gpudrive_lab_tpu.vbd import convert as jconvert
from gpudrive_lab_tpu.vbd import integration as jintegration
from gpudrive_lab_tpu.vbd import model as jmodel
from gpudrive_lab_tpu.vbd import model_official as jofficial
from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.rollout import SLICE_CONFIG
from gpudrive_lab_torch.vbd import integration, model, model_official
from gpudrive_lab_torch.vbd.convert import vbd_params_from_flax
from torch_parity import (
    POOL_SCENES,
    assert_obs_match,
    python_scene_compiler,
    recorded_draws,
    state_to_jax,
)

PATHS = POOL_SCENES[20:23]
VBD = dict(SLICE_CONFIG, use_vbd=True, vbd_in_obs=True,
           reward_type="distance_to_vdb_trajs", vbd_trajectory_weight=0.5,
           num_stack=2)
VBD_CFG = dict(future_len=80, agents_len=8, action_len=5, diffusion_steps=3,
               encoder_layers=1, hidden_dim=64, num_heads=4)
OFFICIAL_CFG = dict(future_len=80, agents_len=8, action_len=5,
                    diffusion_steps=3, encoder_layers=1)


def _envs(paths=PATHS, loader=None, jloader=None, **overrides):
    kw = dict(VBD, **overrides)
    env = GPUDriveTorchEnv(EnvConfig(**kw), paths, device="cpu",
                           data_loader=loader)
    with python_scene_compiler():
        jenv = GPUDriveTPUEnv(JaxEnvConfig(**kw), scene_paths=paths,
                              data_loader=jloader)
    return env, jenv


def assert_env_match(env, jenv, obs=None, jobs=None):
    obs = env.get_obs() if obs is None else obs
    jobs = jenv.get_obs() if jobs is None else jobs
    assert obs.shape[-1] == env.observation_dim == jenv.observation_dim
    assert_obs_match(env, jenv, obs, jobs, tail=integration.VBD_OBS_DIM
                     if env.config.vbd_in_obs else 0)
    np.testing.assert_allclose(env.get_rewards().numpy(),
                               np.asarray(jenv.get_rewards()), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(env.get_dones().numpy(),
                                  np.asarray(jenv.get_dones()))


def _run(env, jenv, steps=12, seed=0):
    rng = np.random.default_rng(seed)
    assert_env_match(env, jenv)
    for _ in range(steps):
        idx = rng.integers(0, env.action_space_n,
                           (env.num_worlds, env.max_agent_count))
        env.step_dynamics(torch.from_numpy(idx))
        jenv.step_dynamics(jnp.asarray(idx))
        assert_env_match(env, jenv)


def test_log_replay_by_default():
    """Until a source is installed the block is of the logged
    trajectories; the obs grows by 455 floats a frame."""
    env, jenv = _envs()
    assert env.observation_dim == (3368 + 455) * 2
    assert env.observation_space.shape == (env.observation_dim,)
    _run(env, jenv)
    np.testing.assert_array_equal(
        env.vbd_trajectories.numpy(),
        integration.log_replay_trajectories(env.scene, env.state).numpy())


def test_array_source():
    env, jenv = _envs()
    traj = np.random.default_rng(1).normal(
        size=(3, env.max_agent_count, C.TRAJECTORY_LEN, 5)).astype(
            np.float32) * 5
    env.set_vbd_trajectories(traj)
    jenv.set_vbd_trajectories(traj)
    _run(env, jenv, seed=1)


def test_reward_needs_trajectories_and_obs_can_be_off():
    env, jenv = _envs(vbd_in_obs=False, num_stack=1)
    assert env.observation_dim == jenv.observation_dim == 3368
    with pytest.raises(ValueError, match="set_vbd_trajectories"):
        env.get_rewards()
    env.set_vbd_trajectories(integration.LogReplaySource())
    jenv.set_vbd_trajectories(jintegration.LogReplaySource())
    _run(env, jenv, steps=3, seed=2)


def _sampled(env, jenv, tsource, jsource):
    """Install both sources; the trajectories within 1e-3; then the JAX env
    gets the port's trajectories."""
    with recorded_draws() as draws:
        jenv.set_vbd_trajectories(jsource)
    tsource.noise = draws
    env.set_vbd_trajectories(tsource)
    got = env.vbd_trajectories.numpy()
    want = np.asarray(jenv.vbd_trajectories)
    assert got.shape == (3, env.max_agent_count, C.TRAJECTORY_LEN, 5)
    assert np.abs(got).sum() > 0 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)
    jenv.set_vbd_trajectories(got)


def test_vbd_trajectory_source():
    env, jenv = _envs()
    jcfg = jmodel.VBDConfig(**VBD_CFG)
    jm = jmodel.VBDModel(jcfg)
    A = jcfg.agents_len
    batch = {"agents_history": jnp.zeros((1, A, 11, 8)),
             "agents_id": jnp.zeros((1, A), jnp.int32),
             "polylines": jnp.zeros((1, 4, 30, 5)),
             "anchors": jnp.zeros((1, A, 2, 2))}
    variables = jm.init(jax.random.PRNGKey(0), batch,
                        jnp.zeros((1, A, jcfg.action_blocks, 2)),
                        jnp.zeros((1, A), jnp.int32))
    tm = model.VBDModel(model.VBDConfig(**VBD_CFG), device="cpu")
    tm.load_state_dict(vbd_params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)), strict=True)
    _sampled(env, jenv,
             integration.VBDTrajectorySource(
                 tm, model.DDPMScheduler(3), model.VBDConfig(**VBD_CFG)),
             jintegration.VBDTrajectorySource(
                 jm, variables, jmodel.DDPMScheduler(3), jcfg, seed=3))
    _run(env, jenv, seed=3)


def test_official_vbd_source():
    env, jenv = _envs()
    tm = model_official.OfficialVBD(
        model_official.OfficialVBDConfig(**OFFICIAL_CFG), device="cpu",
        generator=torch.Generator().manual_seed(4)).eval()
    jcfg = jofficial.OfficialVBDConfig(**OFFICIAL_CFG)
    variables = jconvert.convert_state_dict(
        {k: v.numpy() for k, v in tm.state_dict().items()}, jcfg)
    _sampled(env, jenv, integration.OfficialVBDSource(tm),
             jintegration.OfficialVBDSource(
                 jofficial.OfficialVBD(jcfg), variables, jcfg, seed=4))
    _run(env, jenv, seed=4)


def test_scatter_is_the_double_loop():
    """One index scatter gives the JAX sources' double Python loop
    (integration.py:87-96): each agent's rows, the last frame held after
    the future, zero rows for agents left out."""
    rng = np.random.default_rng(5)
    W, N, F, A = 3, 6, 20, 16
    trajs = rng.normal(size=(W, N, F, 5)).astype(np.float32)
    ids = np.stack([rng.permutation(A)[:N] for _ in range(W)]).astype(
        np.int32)
    ids[0, 4:] = -1
    ids[2, 0] = -1
    want = np.zeros((W, A, C.TRAJECTORY_LEN, 5), np.float32)
    for w in range(W):
        for k, a in enumerate(ids[w]):
            if a >= 0:
                want[w, a, :F] = trajs[w, k, :F]
                want[w, a, F:] = trajs[w, k, F - 1]
    got = integration.scatter_trajectories(torch.from_numpy(trajs),
                                           torch.from_numpy(ids), A)
    np.testing.assert_array_equal(got.numpy(), want)


def test_obs_block_and_reward_functions_match_jax():
    env, _ = _envs(num_stack=1)
    for _ in range(3):
        env.step_dynamics(None)
    traj = torch.from_numpy(np.random.default_rng(6).normal(
        size=(3, env.max_agent_count, C.TRAJECTORY_LEN, 5)).astype(
            np.float32) * 20)
    jstate = state_to_jax(env.state)
    got = integration.egocentric_vbd_obs(env.state, traj).numpy()
    want = np.asarray(jintegration.egocentric_vbd_obs(
        jstate, jnp.asarray(traj.numpy())))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    clock = torch.tensor([0, 5, 200], dtype=torch.int32)
    np.testing.assert_allclose(
        integration.vbd_distance_reward(env.state, traj, clock, 0.3).numpy(),
        np.asarray(jintegration.vbd_distance_reward(
            jstate, jnp.asarray(traj.numpy()), jnp.asarray(clock.numpy()),
            0.3)), rtol=0, atol=1e-6)


# pool_v3 scenes by created agents: 5, 6 | 3, 10 | 25, 7 -> the third
# batch needs 32 agent rows where the first two fit 16
SWAP_SCENES = [POOL_SCENES[i] for i in (20, 21, 22, 23, 378, 16)]


def test_swaps_keep_the_trajectories(tmp_path):
    """Both envs keep the installed trajectories across a swap of the same
    agent rows (env_jax.py:750).  Where a swap grows the rows under
    agent_bucket="auto", the JAX env fails to broadcast them against the
    new state; the port pads them with zero rows, and a JAX env built on
    the new batch with the padded trajectories is the reference."""
    for i, p in enumerate(SWAP_SCENES):
        shutil.copy(p, tmp_path / f"tfrecord-{i:02d}.json")
    root = str(tmp_path)
    env, jenv = _envs(paths=None, loader=SceneDataLoader(root, 2, 100),
                      jloader=JaxLoader(root, 2, 100), agent_bucket="auto")
    assert env.max_agent_count == 16
    traj = np.random.default_rng(7).normal(
        size=(2, 16, C.TRAJECTORY_LEN, 5)).astype(np.float32) * 5
    env.set_vbd_trajectories(traj)
    jenv.set_vbd_trajectories(traj)
    with python_scene_compiler():
        env.swap_data_batch()
        jenv.swap_data_batch()
    assert env.max_agent_count == 16
    np.testing.assert_array_equal(env.vbd_trajectories.numpy(), traj)
    _run(env, jenv, steps=3, seed=7)
    with python_scene_compiler():
        env.swap_data_batch()
        with pytest.raises((TypeError, ValueError)):
            jenv.swap_data_batch()  # its reset's get_obs fails
        jfresh = GPUDriveTPUEnv(JaxEnvConfig(**dict(VBD, agent_bucket="auto")),
                                scene_paths=env.scene_paths)
    assert env.max_agent_count == jfresh.max_agent_count == 32
    padded = env.vbd_trajectories.numpy()
    np.testing.assert_array_equal(padded[:, :16], traj)
    assert not padded[:, 16:].any()
    jfresh.set_vbd_trajectories(padded)
    assert_env_match(env, jfresh, env.reset(), jfresh.reset())
    _run(env, jfresh, steps=3, seed=8)
    assert os.path.basename(env.scene_paths[0]) == "tfrecord-04.json"

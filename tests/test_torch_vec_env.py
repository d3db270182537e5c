"""The flat vector env (gpudrive_lab_torch/env/env_vec.py) against the
JAX package's VecGPUDriveEnv: 100 steps of the same seeded actions over a
loader's batches, past the 91-step episode, with one resample.  Flat obs
within the env bar (1e-5, road rows as sets), rewards, terminals and
truncations exact, the episode statistics equal, and the data coverage
that of the JAX env with the first batch, which the JAX env drops."""

import shutil

import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.env.config import EnvConfig as JaxEnvConfig
from gpudrive_lab_tpu.env.dataset import SceneDataLoader as JaxLoader
from gpudrive_lab_tpu.env.env_vec import VecGPUDriveEnv as JaxVecEnv
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.env.env_vec import VecGPUDriveEnv
from gpudrive_lab_torch.rollout import SLICE_CONFIG
from torch_parity import (
    POOL_SCENES,
    assert_flat_obs_match,
    python_scene_compiler,
)

STEPS = 100
RESAMPLE_AT = 95  # the step after which the batch is swapped


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    for i, k in enumerate((20, 22, 25, 19, 17, 29)):  # 3 to 6 agents
        shutil.copy(POOL_SCENES[k], d / f"tfrecord-{i:02d}.json")
    return str(d)


def _vec_envs(data_dir, seed):
    kw = dict(SLICE_CONFIG, collision_behavior="remove")
    venv = VecGPUDriveEnv(
        EnvConfig(**kw), SceneDataLoader(data_dir, 3, 100, seed=seed,
                                         sample_with_replacement=True),
        device="cpu")
    with python_scene_compiler():
        jvenv = JaxVecEnv(JaxEnvConfig(**kw), JaxLoader(
            data_dir, 3, 100, seed=seed, sample_with_replacement=True))
    interval = venv.num_agents * RESAMPLE_AT
    venv.resample_interval = jvenv.resample_interval = interval
    return venv, jvenv


@pytest.mark.parametrize("seed", [2, 4])
def test_vec_env_matches_jax(data_dir, seed):
    venv, jvenv = _vec_envs(data_dir, seed)
    first = set(venv.env.scene_paths)
    assert venv.num_agents == jvenv.num_agents
    assert venv.single_observation_dim == jvenv.single_observation_dim
    assert venv.single_action_space_n == jvenv.single_action_space_n
    np.testing.assert_array_equal(venv.flat_ids.numpy(), jvenv.flat_ids)
    assert_flat_obs_match(venv.reset(), jvenv.reset())
    rng = np.random.default_rng(seed)
    n_stats = 0
    with python_scene_compiler():
        for t in range(STEPS):
            acts = rng.integers(0, venv.single_action_space_n,
                                venv.num_agents)
            obs, rew, term, trunc, info = venv.step(torch.from_numpy(acts))
            jobs, jrew, jterm, jtrunc, jinfo = jvenv.step(acts)
            np.testing.assert_array_equal(rew.numpy(), jrew)
            np.testing.assert_array_equal(term.numpy(), jterm)
            np.testing.assert_array_equal(trunc.numpy(), jtrunc)
            assert info == jinfo, t
            n_stats += len(info["episode_stats"])
            assert venv.num_agents == jvenv.num_agents
            assert_flat_obs_match(obs, jobs)
            np.testing.assert_array_equal(
                venv.episode_returns.numpy(), jvenv.episode_returns)
    assert n_stats >= 3  # every world finished an episode
    # The JAX constructor adds the first batch to data_coverage and then
    # sets it to an empty set (env_vec.py:37 then :43), so the JAX env
    # counts only the resampled scenes; the port counts the first batch.
    assert venv.data_coverage == jvenv.data_coverage | first
    assert not first <= jvenv.data_coverage
    assert venv.data_coverage > first  # the resample brought new scenes
    assert venv.pop_stats() == jvenv.pop_stats()
    assert venv.global_step == jvenv.global_step


def test_vec_env_resample_refreshes_the_agent_rows(data_dir):
    venv, _ = _vec_envs(data_dir, 1)
    venv.reset()
    before = venv.env.scene_paths
    venv.resample_scenario_batch()
    assert venv.env.scene_paths != before
    assert venv.num_agents == int(venv.env.cont_agent_mask.sum())
    obs = venv.reset()
    assert obs.shape == (venv.num_agents, venv.single_observation_dim)

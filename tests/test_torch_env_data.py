"""The env's completions (gpudrive_lab_torch/env/env_torch.py) against the
JAX env, on copies of pool_v3 scenes in a temporary directory:

  * a data_loader in place of scene paths, two swap_data_batch calls and a
    bucket-growing swap: rewards, dones, infos, clocks and masks exact, obs
    within the env bar (1e-5, assert_obs_match), over random steps;
  * remove_agents_by_id: the same deleted agents, controlled or not;
  * reward conditioning in the random, preset (all four profiles) and
    fixed modes: the same weights, also after a per-world reset that
    re-conditions only its worlds, with the host generator's draws
    interleaved with remove_agents_by_id's as in the JAX env;
  * get_expert_actions for the four dynamics models and
    advance_sim_with_log_playback;
  * the gymnasium spaces, the controlled mask, the file names and
    scenario ids.

The JAX env's swap keeps its fixed reward weights at the old agent rows
when a swap grows the agent bucket, and its next weighted reward then
fails to broadcast; the port re-derives them.  After that swap the port is
held against a JAX env built on the new batch.
"""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.env.config import EnvConfig as JaxEnvConfig
from gpudrive_lab_tpu.env.dataset import SceneDataLoader as JaxLoader
from gpudrive_lab_tpu.env.env_jax import GPUDriveTPUEnv
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.rollout import SLICE_CONFIG
from torch_parity import (
    POOL_SCENES,
    assert_obs_match,
    assert_states_match,
    jax_figures,
    no_matplotlib,
    python_scene_compiler,
    state_to_torch,
)

# pool_v3 scenes by created agents: 5, 6 | 3, 10 | 25, 7 -> the third
# batch needs 32 agent rows where the first two fit 16
SWAP_SCENES = [POOL_SCENES[i] for i in (20, 21, 22, 23, 378, 16)]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    for i, p in enumerate(SWAP_SCENES):
        shutil.copy(p, d / f"tfrecord-{i:02d}.json")
    return str(d)


def _envs(data_dir=None, paths=None, batch_size=2, **overrides):
    kw = dict(SLICE_CONFIG, **overrides)
    loader = jloader = None
    if data_dir is not None:
        loader = SceneDataLoader(data_dir, batch_size, 100)
        jloader = JaxLoader(data_dir, batch_size, 100)
    env = GPUDriveTorchEnv(EnvConfig(**kw), paths, device="cpu",
                           data_loader=loader)
    with python_scene_compiler():
        jenv = GPUDriveTPUEnv(JaxEnvConfig(**kw), data_loader=jloader,
                              scene_paths=paths)
    return env, jenv


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_env_match(env, jenv, rewards=True):
    assert env.scene_paths == list(jenv.scene_paths)
    assert env.max_agent_count == jenv.max_agent_count
    assert_obs_match(env, jenv, env.get_obs(), jenv.get_obs())
    np.testing.assert_array_equal(_np(env.cont_agent_mask),
                                  _np(jenv.cont_agent_mask))
    np.testing.assert_array_equal(env.get_controlled_agents_mask(),
                                  jenv.get_controlled_agents_mask())
    if rewards:
        np.testing.assert_array_equal(_np(env.get_rewards()),
                                      _np(jenv.get_rewards()))
    np.testing.assert_array_equal(_np(env.get_dones()), _np(jenv.get_dones()))
    np.testing.assert_array_equal(_np(env.world_time_steps),
                                  _np(jenv.world_time_steps))
    for k, v in env.get_infos().items():
        np.testing.assert_array_equal(_np(v), _np(jenv.get_infos()[k]))


def _steps(env, jenv, rng, n=3):
    for _ in range(n):
        idx = rng.integers(0, env.action_space_n,
                           (env.num_worlds, env.max_agent_count))
        env.step_dynamics(torch.from_numpy(idx))
        jenv.step_dynamics(jnp.asarray(idx))
        assert_env_match(env, jenv)


def test_swaps_match_jax(data_dir):
    """Two loader swaps, then a bucket-growing one (agent_bucket auto),
    with random steps between them and an explicit data_batch."""
    env, jenv = _envs(data_dir, agent_bucket="auto")
    rng = np.random.default_rng(0)
    assert_env_match(env, jenv)
    assert env.max_agent_count == 16
    _steps(env, jenv, rng)
    with python_scene_compiler():
        env.swap_data_batch()
        jenv.swap_data_batch()
        assert env.scene_paths[0].endswith("tfrecord-02.json")
        assert_env_match(env, jenv)
        _steps(env, jenv, rng)
        batch = [os.path.join(data_dir, "tfrecord-01.json"),
                 os.path.join(data_dir, "tfrecord-03.json")]
        env.swap_data_batch(batch)
        jenv.swap_data_batch(batch)
        assert_env_match(env, jenv)
        _steps(env, jenv, rng)
        env.swap_data_batch()  # the loader's third batch: 25 agents
        jenv.swap_data_batch()
        assert env.max_agent_count == jenv.max_agent_count == 32
        assert env.reward_weights.shape == (2, 32, 3)
        # the JAX env keeps [2, 16, 3] weights here; a fresh one on the
        # same batch is the reference
        jfresh = GPUDriveTPUEnv(JaxEnvConfig(**dict(
            SLICE_CONFIG, agent_bucket="auto")),
            scene_paths=jenv.scene_paths)
    assert_env_match(env, jfresh)
    _steps(env, jfresh, rng)
    # a spent loader starts over
    with python_scene_compiler():
        env.swap_data_batch()
    assert env.scene_paths[0].endswith("tfrecord-00.json")


def test_swap_needs_a_batch_of_num_worlds(data_dir):
    env, _ = _envs(data_dir)
    with pytest.raises(ValueError, match="2 scenes"):
        env.swap_data_batch(SWAP_SCENES[:1])
    env = GPUDriveTorchEnv(EnvConfig(**SLICE_CONFIG), SWAP_SCENES[:2],
                           device="cpu")
    with pytest.raises(ValueError, match="data_loader"):
        env.swap_data_batch()


@pytest.mark.parametrize("controlled", [True, False])
def test_remove_agents_by_id_matches_jax(controlled):
    """``ceil(0.5 n)`` agents of each world deleted, the same ones, drawn
    from the env's host generator; the worlds recompiled and reset."""
    paths = [POOL_SCENES[i] for i in (18, 26)]  # 15 and 12 agents
    kw = {} if controlled else dict(max_controlled_agents=4)
    env, jenv = _envs(paths=paths, seed=5, **kw)
    before = env.scene.agents.valid.sum(dim=1)
    with python_scene_compiler():
        env.remove_agents_by_id(0.5, remove_controlled_agents=controlled)
        jenv.remove_agents_by_id(0.5, remove_controlled_agents=controlled)
    for f in ("valid", "controlled", "aid"):
        np.testing.assert_array_equal(_np(getattr(env.scene.agents, f)),
                                      _np(getattr(jenv.scene.agents, f)))
    removed = before - env.scene.agents.valid.sum(dim=1)
    n = (torch.tensor([15, 12]) if controlled
         else torch.tensor([11, 8]))  # uncontrolled valid agents
    assert removed.tolist() == torch.ceil(0.5 * n).long().tolist()
    assert_env_match(env, jenv)
    _steps(env, jenv, np.random.default_rng(1), n=2)


CONDITIONS = [("random", None), ("preset", None), ("preset", "balanced"),
              ("preset", "cautious"), ("preset", "aggressive"),
              ("preset", "risk_taker"), ("fixed", (-0.3, 1.7, -0.6))]


@pytest.mark.parametrize("mode,agent_type", CONDITIONS,
                         ids=[f"{m}-{a}" for m, a in CONDITIONS])
def test_reward_conditioning_matches_jax(mode, agent_type):
    """reward_conditioned: the constructor's weights (two draws in
    "random" mode), a per-world reset that re-conditions world 1 only with
    the given mode and profile, the 3371-float obs and the weighted
    rewards."""
    cfg_mode = "random" if mode == "fixed" else mode
    env, jenv = _envs(paths=SWAP_SCENES[:2],
                      reward_type="reward_conditioned",
                      condition_mode=cfg_mode, seed=3)
    assert env.observation_dim == 3371
    np.testing.assert_array_equal(_np(env.reward_weights),
                                  _np(jenv.reward_weights))
    before = env.reward_weights.clone()
    env.step_dynamics(None)
    jenv.step_dynamics(None)
    env.reset([1], condition_mode=mode, agent_type=agent_type)
    jenv.reset([1], condition_mode=mode, agent_type=agent_type)
    np.testing.assert_array_equal(_np(env.reward_weights),
                                  _np(jenv.reward_weights))
    assert torch.equal(env.reward_weights[0], before[0])
    if mode == "fixed":
        want = torch.tensor(agent_type, dtype=torch.float32)
        assert torch.equal(env.reward_weights[1],
                           want.expand_as(env.reward_weights[1]))
    elif mode == "preset" and agent_type in (None, "balanced"):
        assert torch.allclose(env.reward_weights[1],
                              torch.tensor([-0.5, 1.5, -0.5]))
    assert_env_match(env, jenv)
    _steps(env, jenv, np.random.default_rng(2), n=2)


def test_fixed_conditioning_needs_weights():
    env, _ = _envs(paths=SWAP_SCENES[:1], reward_type="reward_conditioned")
    with pytest.raises(ValueError, match="agent_type"):
        env.reset(condition_mode="fixed")


def test_host_draws_interleave_as_jax():
    """The constructor draws the weights twice (its default weights, then
    its reset), remove_agents_by_id draws the deleted agents and then new
    weights, a per-world reset draws for every world: the same sequence
    of the host generator in both envs."""
    paths = [POOL_SCENES[i] for i in (18, 26)]
    env, jenv = _envs(paths=paths, reward_type="reward_conditioned", seed=9)
    rng = np.random.default_rng(9)
    shape = (2, 128, 3)
    lo, hi = np.array([-1.0, 1.0, -1.0]), np.array([0.0, 2.0, 0.0])
    rng.uniform(lo, hi, shape)
    np.testing.assert_array_equal(
        env.reward_weights.numpy(),
        rng.uniform(lo, hi, shape).astype(np.float32))
    with python_scene_compiler():
        env.remove_agents_by_id(0.3)
        jenv.remove_agents_by_id(0.3)
    np.testing.assert_array_equal(_np(env.scene.agents.valid),
                                  _np(jenv.scene.agents.valid))
    np.testing.assert_array_equal(_np(env.reward_weights),
                                  _np(jenv.reward_weights))
    env.reset([0])
    jenv.reset([0])
    np.testing.assert_array_equal(_np(env.reward_weights),
                                  _np(jenv.reward_weights))
    assert_env_match(env, jenv)


@pytest.mark.parametrize("model", ["classic", "bicycle", "delta_local",
                                   "state"])
def test_expert_actions_match_jax(model):
    env, jenv = _envs(paths=SWAP_SCENES[:2], dynamics_model=model)
    got, want = env.get_expert_actions(), jenv.get_expert_actions()
    assert len(got) == len(want) == 5
    assert got[0].shape == (2, 128, 91, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("model", ["classic", "delta_local"])
def test_log_playback_matches_jax(model):
    """5 steps of logged actions from trajectory time 0, after 2 random
    steps: the same state and clocks, and the same obs."""
    env, jenv = _envs(paths=SWAP_SCENES[:2], dynamics_model=model)
    rng = np.random.default_rng(4)
    _steps(env, jenv, rng, n=2)
    env.advance_sim_with_log_playback(5)
    jenv.advance_sim_with_log_playback(5)
    assert_states_match(jenv.state, env.state, where="after playback")
    assert_env_match(env, jenv)
    # the JAX state carried into the port steps on as the port's own
    env.state = state_to_torch(jenv.state)
    _steps(env, jenv, rng, n=1)


@pytest.mark.parametrize("overrides", [
    {}, {"dynamics_model": "state"}, {"reward_type": "reward_conditioned"},
    {"num_stack": 2}], ids=["classic", "state", "conditioned", "stack-2"])
def test_spaces_match_jax(overrides):
    env, jenv = _envs(paths=SWAP_SCENES[:1], **overrides)
    assert env.observation_space == jenv.observation_space
    assert env.action_space == jenv.action_space
    assert env.observation_space.shape == (env.observation_dim,)


def test_spaces_are_none_without_gymnasium(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_gym(name, *a, **k):
        if name == "gymnasium":
            raise ImportError(name)
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_gym)
    env = GPUDriveTorchEnv(EnvConfig(**SLICE_CONFIG), SWAP_SCENES[:1],
                           device="cpu")
    assert env.observation_space is None and env.action_space is None


def test_names_match_jax():
    env, jenv = _envs(paths=SWAP_SCENES)
    assert env.get_env_filenames() == jenv.get_env_filenames()
    assert env.get_scenario_ids() == jenv.get_scenario_ids()
    assert len(set(env.get_scenario_ids().values())) == len(SWAP_SCENES)


def test_rendering_refuses(monkeypatch):
    """render draws the JAX visualizer's figure of the same state (the
    figures are held in tests/test_torch_visualize.py); on a machine
    without matplotlib it refuses at once."""
    env, _ = _envs(paths=SWAP_SCENES[:1])
    np.testing.assert_array_equal(
        env.render(0), jax_figures(env.scene, env.state, [0])[0])
    no_matplotlib(monkeypatch)
    fresh = GPUDriveTorchEnv(EnvConfig(**SLICE_CONFIG), SWAP_SCENES[:1],
                             device="cpu")
    with pytest.raises(ModuleNotFoundError, match="matplotlib"):
        fresh.render(0)

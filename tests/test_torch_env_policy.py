"""Env and policy parity, and the slice as a whole.

  * flat_observation [W, A, 3368] within 1e-5 of the JAX env (KNN road rows
    compared as sets, since the order inside K is unspecified), masks exact;
  * shaped rewards and dones equal;
  * LateFusionPolicy logits and value within 1e-5 of the flax model, with
    weights carried across by params_from_flax, fused_embed on and off;
  * 10 rollout steps with argmax actions in both packages: the same
    actions, and obs, rewards and dones within the bars above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.env.config import EnvConfig as JaxEnvConfig
from gpudrive_lab_tpu.env.env_jax import GPUDriveTPUEnv
from gpudrive_lab_tpu.networks.late_fusion import (
    LateFusionPolicy as FlaxPolicy,
    PolicyConfig as FlaxPolicyConfig,
)
from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.networks.convert import params_from_flax
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionPolicy,
    PolicyConfig,
)
from gpudrive_lab_torch.rollout import SLICE_CONFIG, rollout
from torch_parity import POOL_SCENES, python_scene_compiler, sorted_rows

PATHS = POOL_SCENES[20:22]
E = C.EGO_FEAT_DIM
P = (C.MAX_AGENTS - 1) * C.PARTNER_FEAT_DIM


def _envs(**overrides):
    kw = dict(SLICE_CONFIG, **overrides)
    env = GPUDriveTorchEnv(EnvConfig(**kw), PATHS, device="cpu")
    with python_scene_compiler():
        jenv = GPUDriveTPUEnv(JaxEnvConfig(num_worlds=len(PATHS), **kw),
                              scene_paths=PATHS)
    return env, jenv


def _road_rows(obs, road_mask):
    """[W, A, K, 14]: the 13 road features with the road mask beside."""
    road = obs[..., E + P:].reshape(obs.shape[:-1] + (C.MAX_AGENT_MAP_OBS, 13))
    return np.concatenate([road, road_mask[..., None].astype(np.float32)], -1)


def assert_obs_match(env, jenv, obs, jobs, ordered_roads=False):
    obs, jobs = obs.numpy(), np.asarray(jobs)
    assert obs.shape == jobs.shape
    np.testing.assert_allclose(obs[..., :E + P], jobs[..., :E + P],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(env.partner_mask.numpy(),
                                  np.asarray(jenv.partner_mask))
    got = _road_rows(obs, env.road_mask.numpy())
    want = _road_rows(jobs, np.asarray(jenv.road_mask))
    if not ordered_roads:
        got, want = sorted_rows(got), sorted_rows(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("overrides", [
    {},
    {"road_obs_algorithm": "linear"},
    {"agent_bucket": "auto"},
    {"reward_type": "distance_to_logs"},
], ids=["knn", "linear", "agent-bucket", "distance-to-logs"])
def test_obs_rewards_dones_match(overrides):
    env, jenv = _envs(**overrides)
    linear = overrides.get("road_obs_algorithm") == "linear"
    assert_obs_match(env, jenv, env.get_obs(), jenv.get_obs(),
                     ordered_roads=linear)
    assert env.get_obs().shape[-1] == 3368
    rng = np.random.default_rng(1)
    W, A = env.num_worlds, env.max_agent_count
    for _ in range(4):
        idx = rng.integers(0, env.action_space_n, (W, A))
        env.step_dynamics(torch.from_numpy(idx))
        jenv.step_dynamics(jnp.asarray(idx))
        assert_obs_match(env, jenv, env.get_obs(), jenv.get_obs(),
                         ordered_roads=linear)
        # exp() of the log distance may differ in the last place
        tol = 1e-6 if overrides.get("reward_type") == "distance_to_logs" else 0
        np.testing.assert_allclose(env.get_rewards().numpy(),
                                   np.asarray(jenv.get_rewards()),
                                   rtol=0, atol=tol)
        np.testing.assert_array_equal(env.get_dones().numpy(),
                                      np.asarray(jenv.get_dones()))
        np.testing.assert_array_equal(env.world_time_steps.numpy(),
                                      np.asarray(jenv.world_time_steps))
        for k, v in env.get_infos().items():
            np.testing.assert_array_equal(v.numpy(),
                                          np.asarray(jenv.get_infos()[k]))


def test_flat_observation_reward_conditioned():
    """The reward-conditioned layout: 3 weight columns after the ego
    block, 3371 floats per row."""
    from gpudrive_lab_tpu.env.env_jax import (
        ObsSpec as JaxObsSpec,
        flat_observation as jax_flat_observation,
    )
    from gpudrive_lab_torch.env.env_torch import ObsSpec, flat_observation
    from torch_parity import jax_params, scene_to_jax, state_to_jax

    env, _ = _envs()
    W, A = env.num_worlds, env.max_agent_count
    weights = np.random.default_rng(4).uniform(
        -1, 2, (W, A, 3)).astype(np.float32)
    obs, pmask, _ = flat_observation(
        env.scene, env.state, env.params, ObsSpec(reward_conditioned=True),
        torch.from_numpy(weights))
    jobs, jpmask, _ = jax_flat_observation(
        scene_to_jax(env.scene), state_to_jax(env.state),
        jax_params(env.params), JaxObsSpec(reward_conditioned=True),
        jnp.asarray(weights))
    assert obs.shape == (W, A, 3371)
    np.testing.assert_allclose(obs.numpy()[..., :9 + P],
                               np.asarray(jobs)[..., :9 + P],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jpmask))


def _flax_variables(seed=0, act="tanh"):
    """A flax parameter tree of the policy, every leaf drawn with numpy:
    kernels N(0, 1/fan_in), biases N(0, 0.1), LayerNorm scale 1 + N(0, 0.1)."""
    shapes = jax.eval_shape(
        lambda: FlaxPolicy(FlaxPolicyConfig(act_func=act)).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 3368)))
    )
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            v = rng.standard_normal(leaf.shape) / np.sqrt(leaf.shape[0])
        elif "scale" in name:
            v = 1.0 + 0.1 * rng.standard_normal(leaf.shape)
        else:
            v = 0.1 * rng.standard_normal(leaf.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _policy(variables, fused, act="tanh"):
    policy = LateFusionPolicy(PolicyConfig(act_func=act, fused_embed=fused),
                              device="cpu")
    policy.load_state_dict(params_from_flax(variables))
    return policy.eval()


@pytest.mark.parametrize("act", ["tanh", "gelu"])
def test_policy_matches_flax(act):
    variables = _flax_variables(act=act)
    rng = np.random.default_rng(2)
    obs = rng.standard_normal((16, 3368)).astype(np.float32)
    jvars = jax.tree.map(jnp.asarray, variables)
    for fused in (False, True):
        flax_logits, flax_value = FlaxPolicy(
            FlaxPolicyConfig(act_func=act, fused_embed=fused)
        ).apply(jvars, jnp.asarray(obs))
        with torch.no_grad():
            logits, value = _policy(variables, fused, act)(
                torch.from_numpy(obs))
        np.testing.assert_allclose(logits.numpy(), np.asarray(flax_logits),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(value.numpy(), np.asarray(flax_value),
                                   rtol=1e-5, atol=1e-5)


def test_slice_10_rollout_steps_match():
    """The slice end to end: obs -> policy -> argmax -> step -> rewards,
    dones -> reset of finished worlds, 10 times, in both packages.  Actions
    are compared on the controlled agents, the rows the dynamics read."""
    env, jenv = _envs()
    variables = _flax_variables(seed=3)
    policy = _policy(variables, fused=True)
    flax_policy = FlaxPolicy(FlaxPolicyConfig(fused_embed=True))
    apply = jax.jit(flax_policy.apply)
    jvars = jax.tree.map(jnp.asarray, variables)
    W, A = env.num_worlds, env.max_agent_count
    ctrl = env.scene.agents.controlled.numpy()
    assert ctrl.sum() > 0
    for t in range(10):
        jobs = jenv.get_obs()
        assert_obs_match(env, jenv, env.get_obs(), jobs)
        logits, _ = apply(jvars, jobs.reshape(W * A, -1))
        jact = np.asarray(jnp.argmax(logits, -1)).reshape(W, A)
        res = rollout(env, policy, 1, None, deterministic=True)
        act = res.actions[0].numpy()
        assert act.dtype == np.int32
        np.testing.assert_array_equal(act[ctrl], jact[ctrl], err_msg=f"t={t}")
        jenv.step_dynamics(jnp.asarray(jact))
        np.testing.assert_array_equal(res.rewards[0].numpy(),
                                      np.asarray(jenv.get_rewards()))
        np.testing.assert_array_equal(res.dones[0].numpy(),
                                      np.asarray(jenv.get_dones()))
        finished = np.asarray(
            ((jenv.state.done != 0) | ~jenv.scene.agents.valid).all(axis=1))
        if finished.any():
            jenv.reset(list(np.nonzero(finished)[0]))
    assert_obs_match(env, jenv, env.get_obs(), jenv.get_obs())

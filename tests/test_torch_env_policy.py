"""Env and policy parity, and the slice as a whole.

  * flat_observation [W, A, 3368] within 1e-5 of the JAX env (KNN road rows
    compared as sets, since the order inside K is unspecified), masks exact,
    also unnormalised, with an obs block or all classic blocks off, the
    bicycle and delta-local models, remove and stop, init_steps and
    stacked frames;
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
from torch_parity import (
    POOL_SCENES,
    assert_obs_match,
    flax_variables,
    match_rows,
    python_scene_compiler,
)

PATHS = POOL_SCENES[20:22]
PATHS3 = POOL_SCENES[20:23]
P = (C.MAX_AGENTS - 1) * C.PARTNER_FEAT_DIM


def _envs(paths=PATHS, **overrides):
    kw = dict(SLICE_CONFIG, **overrides)
    env = GPUDriveTorchEnv(EnvConfig(**kw), paths, device="cpu")
    with python_scene_compiler():
        jenv = GPUDriveTPUEnv(JaxEnvConfig(num_worlds=len(paths), **kw),
                              scene_paths=paths)
    return env, jenv


def test_match_rows_pairs_rows_apart_by_float_noise():
    """Two [K, D] sets holding the same road rows in another order, one
    side moved by 1e-5 in a metre-scale coordinate, compare equal after
    match_rows, also where rounding the coordinate to 4 decimals would put
    the two sides on either side of a rounding boundary (12.34565) and
    where two different rows are nearer in that coordinate than the noise
    (their second column tells them apart)."""
    rng = np.random.default_rng(3)
    want = rng.uniform(-50, 50, (2, 40, 14)).astype(np.float32)
    want[:, :4, 0] = [12.345645, 12.345655, 12.34566, 12.345662]
    want[:, :4, 1] = [1.0, 2.0, 3.0, 4.0]
    want[:, 30:] = 0.0  # padding rows, identical
    noise = np.zeros_like(want)
    noise[..., 0] = rng.choice([-1e-5, 1e-5], want.shape[:-1])
    perm = rng.permutation(40)
    got = (want + noise)[:, perm]
    matched = match_rows(got, want)
    np.testing.assert_allclose(matched, want, rtol=0, atol=1.5e-5)
    assert not np.allclose(got, want, atol=1e-3)  # shuffled before


@pytest.mark.parametrize("overrides,paths", [
    ({}, PATHS),
    ({"road_obs_algorithm": "linear"}, PATHS),
    ({"agent_bucket": "auto"}, PATHS),
    ({"reward_type": "distance_to_logs"}, PATHS),
    # the observation, dynamics and collision options, on 3 worlds
    ({"norm_obs": False}, PATHS3),
    ({"partner_obs": False}, PATHS3),
    ({"disable_classic_obs": True}, PATHS3),
    ({"dynamics_model": "bicycle", "collision_behavior": "remove"}, PATHS3),
    ({"dynamics_model": "delta_local", "collision_behavior": "stop"}, PATHS3),
    ({"init_steps": 5}, PATHS3),
    ({"num_stack": 2}, PATHS3),
], ids=["knn", "linear", "agent-bucket", "distance-to-logs", "unnormalised",
        "no-partner-obs", "no-classic-obs", "bicycle-remove",
        "delta-local-stop", "init-steps-5", "stack-2"])
def test_obs_rewards_dones_match(overrides, paths):
    env, jenv = _envs(paths, **overrides)
    linear = overrides.get("road_obs_algorithm") == "linear"
    obs = env.get_obs()
    assert_obs_match(env, jenv, obs, jenv.get_obs(), ordered_roads=linear)
    assert obs.shape[-1] == env.spec.obs_dim * env.config.num_stack
    assert env.spec.obs_dim == (
        0 if overrides.get("disable_classic_obs")
        else 3368 - P if overrides.get("partner_obs") is False else 3368)
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


def _policy(variables, fused, act="tanh"):
    policy = LateFusionPolicy(PolicyConfig(act_func=act, fused_embed=fused),
                              device="cpu")
    policy.load_state_dict(params_from_flax(variables))
    return policy.eval()


@pytest.mark.parametrize("act", ["tanh", "gelu"])
def test_policy_matches_flax(act):
    variables = flax_variables(act=act)
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
    variables = flax_variables(seed=3)
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

"""PPO parity: the port's trainer (gpudrive_lab_torch/ppo/ppo.py) against the
JAX package's on the same inputs, on the CPU.

  * the compacted observation forms (per-world [W, C] and flat
    (w_idx, a_idx)), flat and split, against the JAX flat_observation;
  * GAE to 1e-6;
  * a T-step rollout in each layout (dense, per-world, flat, block-local
    flat) driven by the JAX rollout's actions: rewards, dones,
    masks and episode outcomes equal, values and log-probabilities to 1e-5,
    the carried state within the step's parity bar;
  * one update (GAE and E epochs x M minibatches) from the same parameters,
    trajectory and minibatch order: losses and parameters within 1e-4 (the
    ROADMAP bar), Adam's moments beside them, over the dense, per-world and
    flat layouts, the remat and stored (flat, split, bfloat16) obs stores,
    with fused_embed off and on; and with the bf16 policy dtype in three
    layouts, at the bars of ``bf16_bars``.

The rollouts start 5 steps before the episodes end, so that worlds finish
and are reset inside them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpudrive_lab_tpu.env.env_jax import (
    ObsSpec as JaxObsSpec,
    flat_observation as jax_flat_observation,
)
from gpudrive_lab_tpu.ppo.ppo import EnvCarry as JaxCarry
from gpudrive_lab_tpu.ppo.ppo import compute_gae as jax_compute_gae
from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.env.env_torch import flat_observation
from gpudrive_lab_torch.networks.convert import params_from_flax
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionPolicy,
    PolicyConfig,
)
from gpudrive_lab_torch.ppo.ppo import EnvCarry, PPOConfig, compute_gae
from gpudrive_lab_torch.ppo.train import build_trainer
from gpudrive_lab_torch.rollout import slice_env
from torch_parity import (
    POOL_SCENES,
    assert_states_match,
    assert_trainer_matches,
    bf16_bars,
    flax_variables,
    jax_minibatch_order,
    jax_params,
    jax_ppo,
    match_rows,
    scene_to_jax,
    state_to_jax,
    traj_to_jax,
)

T = 8
START = C.EPISODE_LEN - 5  # world clock of the rollouts' first step
LAYOUTS = {
    "dense": {},
    "world": dict(compact=8, compact_mode="world"),
    "flat": dict(compact=16, compact_mode="flat"),
    # block-local flat selection: each world block fills its own 8 rows
    "blocks": dict(compact=16, compact_mode="flat", compact_blocks=2),
}


@pytest.fixture(scope="module")
def setup():
    """Two pool worlds (5 and 6 controlled agents, agent axis bucketed to
    16), the policy's weights drawn with numpy, and the state START steps
    into the episode."""
    env = slice_env(POOL_SCENES[20:22], device="cpu", agent_bucket="auto")
    variables = flax_variables(seed=3, action_dim=env.action_space_n)
    fresh = stepmod.reset(env.scene, None, env.params)
    state = fresh
    W, A = env.num_worlds, env.max_agent_count
    zero = torch.zeros((W, A, C.ACTION_DIM))
    for _ in range(START):
        state = stepmod.step(env.scene, state, zero, env.params)
    return env, variables, state


def _trainer(env, variables, **overrides):
    cfg = PPOConfig(**{**dict(rollout_len=T, update_epochs=2,
                              num_minibatches=2), **overrides})
    ppo, carry, fresh, _ = build_trainer(env, cfg, seed=1)
    ppo.policy.load_state_dict(params_from_flax(variables))
    return cfg, ppo, fresh


def _start_carry(env, state, seed=0):
    wts = torch.full((env.num_worlds,), START, dtype=torch.int32)
    return EnvCarry(state, wts, torch.Generator().manual_seed(seed))


def _jax_carry(carry, key):
    return JaxCarry(state_to_jax(carry.state),
                    jnp.asarray(carry.world_time_steps.numpy()), key)


def test_gae_matches_jax():
    rng = np.random.default_rng(0)
    r, v = rng.standard_normal((2, 16, 3, 5)).astype(np.float32)
    d = (rng.random((16, 3, 5)) < 0.2).astype(np.float32)
    last = rng.standard_normal((3, 5)).astype(np.float32)
    adv, ret = compute_gae(*map(torch.from_numpy, (r, v, d, last)), 0.99,
                           0.95)
    jadv, jret = jax_compute_gae(*map(jnp.asarray, (r, v, d, last)), 0.99,
                                 0.95)
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), atol=1e-6)


@pytest.mark.parametrize("layout", ["world", "flat"])
def test_compacted_observations_match_jax(setup, layout):
    env, _, state = setup
    cfg, ppo, _ = _trainer(env, flax_variables(0), **LAYOUTS[layout])
    cidx = ppo.ctrl_slots(env.scene)
    jidx = (tuple(jnp.asarray(c.numpy()) for c in cidx)
            if isinstance(cidx, tuple) else jnp.asarray(cidx.numpy()))
    jfn = jax.jit(jax_flat_observation,
                  static_argnames=("params", "spec", "split"))
    args = (env.scene, state, env.params, env.spec, env.reward_weights)
    jargs = (scene_to_jax(env.scene), state_to_jax(state),
             jax_params(env.params), JaxObsSpec(**dataclasses.asdict(env.spec)),
             jnp.asarray(env.reward_weights.numpy()))
    for split in (False, True):
        obs, pmask, rmask = flat_observation(*args, cidx, split=split)
        jobs, jpmask, jrmask = jfn(*jargs, jidx, split=split)
        np.testing.assert_array_equal(pmask.numpy(), np.asarray(jpmask))
        if not split:
            e = C.EGO_FEAT_DIM + (C.MAX_AGENTS - 1) * C.PARTNER_FEAT_DIM
            lead = obs.shape[:-1]
            obs = (obs[..., :C.EGO_FEAT_DIM],
                   obs[..., C.EGO_FEAT_DIM:e].reshape(lead + (-1, 6)),
                   obs[..., e:].reshape(lead + (-1, 13)))
            jobs = np.asarray(jobs)
            jobs = (jobs[..., :C.EGO_FEAT_DIM],
                    jobs[..., C.EGO_FEAT_DIM:e].reshape(lead + (-1, 6)),
                    jobs[..., e:].reshape(lead + (-1, 13)))
        ego, partner, road = (o.numpy() for o in obs)
        assert ego.shape[:-1] == tuple(cidx[0].shape if layout == "flat"
                                       else cidx.shape)
        np.testing.assert_allclose(ego, np.asarray(jobs[0]), atol=1e-5)
        np.testing.assert_allclose(partner, np.asarray(jobs[1]), atol=1e-5)
        # road rows as sets (the order inside K is unspecified)
        road_m = np.concatenate([road, rmask.numpy()[..., None]], -1)
        jroad_m = np.concatenate(
            [np.asarray(jobs[2]), np.asarray(jrmask)[..., None]], -1)
        np.testing.assert_allclose(match_rows(road_m, jroad_m), jroad_m,
                                   atol=1e-5)


@pytest.mark.parametrize("layout", ["dense", "world", "flat", "blocks"])
def test_rollout_matches_jax(setup, layout):
    env, variables, state = setup
    cfg, ppo, fresh = _trainer(env, variables, **LAYOUTS[layout])
    _, fns = jax_ppo(env, cfg)
    jvars = jax.tree.map(jnp.asarray, variables)
    jscene, jfresh = scene_to_jax(env.scene), state_to_jax(fresh)
    jrw = jnp.asarray(env.reward_weights.numpy())
    carry = _start_carry(env, state)
    jcarry = _jax_carry(carry, jax.random.PRNGKey(5))
    steps = []
    for _ in range(T):
        jcarry, t = fns["rollout_step"](jscene, jvars, jcarry, jfresh, jrw)
        steps.append(t)
    jtraj = jax.tree.map(lambda *xs: np.stack(xs), *steps)
    carry, traj = ppo.rollout(env.scene, carry, fresh, env.reward_weights,
                              actions=torch.from_numpy(jtraj.action))
    assert bool(traj.ep_done.any()), "no world finished inside the rollout"
    for name in ("action", "reward", "done", "mask", "ep_done", "ep_goal",
                 "ep_collided", "ep_off_road"):
        np.testing.assert_array_equal(getattr(traj, name).numpy(),
                                      getattr(jtraj, name), err_msg=name)
    for name in ("value", "logprob"):
        np.testing.assert_allclose(getattr(traj, name).numpy(),
                                   getattr(jtraj, name), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    assert_states_match(jcarry.state, carry.state, where="after the rollout")
    np.testing.assert_array_equal(carry.world_time_steps.numpy(),
                                  np.asarray(jcarry.world_time_steps))
    for t in range(T):  # the stored pre-step states
        assert_states_match(
            jax.tree.map(lambda x: x[t], jtraj.env_state),
            type(carry.state)(**{
                f.name: getattr(traj.env_state, f.name)[t]
                for f in dataclasses.fields(traj.env_state)}),
            where=f"t={t}")


UPDATES = {
    "dense-remat": {},
    "dense-f32-fused": dict(remat_obs=False, fused_embed=True),
    "world-remat-fused": dict(LAYOUTS["world"], fused_embed=True),
    "world-split-f32-embed-remat": dict(
        LAYOUTS["world"], remat_obs=False, obs_store="split",
        embed_remat=True),
    "flat-remat-fused": dict(LAYOUTS["flat"], fused_embed=True),
    "flat-split-bf16-fused": dict(
        LAYOUTS["flat"], remat_obs=False, obs_store="split",
        obs_store_dtype="bfloat16", fused_embed=True),
    "flat-remat-rows-clip-vloss": dict(
        LAYOUTS["flat"], minibatch_rows=8, num_minibatches=4,
        clip_vloss=True),
    # the bf16 policy dtype: the JAX package's production pairing (split
    # bf16 store, fused), the recomputed f32 obs, and an unfused layout
    "flat-split-bf16-fused-bf16policy": dict(
        LAYOUTS["flat"], remat_obs=False, obs_store="split",
        obs_store_dtype="bfloat16", fused_embed=True,
        policy_dtype="bfloat16"),
    "flat-remat-fused-bf16policy": dict(
        LAYOUTS["flat"], fused_embed=True, policy_dtype="bfloat16"),
    "world-bf16-bf16policy": dict(
        LAYOUTS["world"], remat_obs=False, obs_store_dtype="bfloat16",
        policy_dtype="bfloat16"),
}


def jax_update(env, cfg, variables, carry, traj, key):
    """The JAX package's update on the port's trajectory: returns
    (variables, opt_state, metrics) as numpy trees."""
    _, fns = jax_ppo(env, cfg)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(cfg.learning_rate, eps=1e-5))
    jvars = jax.tree.map(jnp.asarray, variables)
    out = fns["update"](scene_to_jax(env.scene), jvars, tx.init(jvars),
                        _jax_carry(carry, key), traj_to_jax(traj),
                        jnp.asarray(env.reward_weights.numpy()),
                        jnp.float32(cfg.ent_coef))
    jvars, jopt, _, metrics = jax.tree.map(np.asarray, out)
    return jvars, jopt, metrics


@pytest.mark.parametrize("name", list(UPDATES))
def test_update_matches_jax(setup, name):
    env, variables, state = setup
    cfg, ppo, fresh = _trainer(env, variables, **UPDATES[name])
    carry, traj = ppo.rollout(env.scene, _start_carry(env, state, seed=2),
                              fresh, env.reward_weights)
    key = jax.random.PRNGKey(7)
    jvars, jopt, jm = jax_update(env, cfg, variables, carry, traj, key)
    perms, starts = jax_minibatch_order(key, cfg)
    m = ppo.update(env.scene, carry, traj, env.reward_weights, perms=perms,
                   row_starts=starts)
    # bf16 policy: logits and values carry bf16's 2^-8 relative rounding
    bf16 = cfg.policy_dtype == "bfloat16"
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl"):
        bar = 1e-4 + (1e-2 * abs(float(jm[k])) if bf16 else 0.0)
        assert abs(float(m[k]) - float(jm[k])) <= bar, (k, m[k], jm[k])
    for k in ("samples", "episodes", "mean_reward", "perc_goal_achieved",
              "perc_collisions", "perc_off_road"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    assert float(m["samples"]) == float(traj.mask.sum())
    if not bf16:
        assert_trainer_matches(ppo, jvars, jopt)
        return
    bars = bf16_bars(cfg, params_from_flax(variables))
    assert_trainer_matches(ppo, jvars, jopt, loose=bars)
    # the control: the same update with one small leaf (the partner
    # block's LayerNorm bias) left where it started must fail the bars
    leaf = "partner_embed.1.bias"
    with torch.no_grad():
        ppo.policy.state_dict()[leaf].copy_(bars["start"][leaf])
    with pytest.raises(AssertionError, match=leaf):
        assert_trainer_matches(ppo, jvars, jopt, loose=bars)


def test_update_per_minibatch_losses_match_jax(setup):
    """Minibatch by minibatch, through the JAX package's per-minibatch
    update (its dispatch path): the losses of each of the E x M steps."""
    env, variables, state = setup
    cfg, ppo, fresh = _trainer(env, variables, **UPDATES["flat-remat-fused"])
    carry, traj = ppo.rollout(env.scene, _start_carry(env, state, seed=3),
                              fresh, env.reward_weights)
    _, fns = jax_ppo(env, cfg)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(cfg.learning_rate, eps=1e-5))
    jvars = jax.tree.map(jnp.asarray, variables)
    jopt = tx.init(jvars)
    jscene = scene_to_jax(env.scene)
    jrw = jnp.asarray(env.reward_weights.numpy())
    key = jax.random.PRNGKey(11)
    jtraj = traj_to_jax(traj)
    batch, _ = fns["_prepare_batch"](jscene, jvars, _jax_carry(carry, key),
                                     jtraj, jrw)
    perms, _ = jax_minibatch_order(key, cfg)
    want = []
    for e in range(cfg.update_epochs):
        for m in range(cfg.num_minibatches):
            jvars, jopt, aux = fns["_mb_update"](
                jvars, jopt, batch, jtraj.env_state, jnp.asarray(perms[e, m]),
                key, jscene, jrw, jnp.float32(cfg.ent_coef))
            want.append({k: float(v) for k, v in aux.items()})
    batch = ppo.prepare(env.scene, carry, traj, env.reward_weights)
    got = ppo.learn(env.scene, batch, traj, env.reward_weights, perms=perms)
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl"):
        np.testing.assert_allclose(
            got[k].reshape(-1).numpy(), [w[k] for w in want], rtol=0,
            atol=1e-4, err_msg=k)
    assert_trainer_matches(ppo, jax.tree.map(np.asarray, jvars),
                           jax.tree.map(np.asarray, jopt))


def test_alias_options_give_equal_updates(setup):
    """unroll and epoch_preshuffle only change how XLA runs the JAX
    update; here they are accepted and change nothing."""
    env, variables, state = setup
    results = []
    for alias in ({}, dict(unroll=True, epoch_preshuffle=True)):
        cfg, ppo, fresh = _trainer(env, variables, **LAYOUTS["flat"],
                                   **alias)
        carry, traj = ppo.rollout(env.scene, _start_carry(env, state),
                                  fresh, env.reward_weights)
        m = ppo.update(env.scene, carry, traj, env.reward_weights)
        results.append((m, ppo.policy.state_dict()))
    (m0, sd0), (m1, sd1) = results
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k


def test_policy_split_input_and_embed_remat():
    """LateFusionPolicy takes the pre-split (ego, partner, road) tuple with
    the same result as the flat vector, and embed_remat recomputes the
    embeds in the backward pass with the same gradients."""
    variables = flax_variables(seed=1)
    rng = np.random.default_rng(4)
    obs = torch.from_numpy(rng.standard_normal((12, 3368)).astype(np.float32))
    split = (obs[:, :6], obs[:, 6:768].reshape(12, 127, 6),
             obs[:, 768:].reshape(12, 200, 13))
    grads = []
    for remat in (False, True):
        policy = LateFusionPolicy(PolicyConfig(embed_remat=remat),
                                  device="cpu")
        policy.load_state_dict(params_from_flax(variables))
        logits, value = policy(obs)
        logits_s, value_s = policy(split)
        assert torch.equal(logits, logits_s) and torch.equal(value, value_s)
        (logits.square().sum() + value.square().sum()).backward()
        grads.append([p.grad.clone() for p in policy.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)

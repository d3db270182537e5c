"""The wrappers, the IPPO learner, the actors and the evaluation utilities
of the port against the JAX package's, on the CPU:

  * MaskedRolloutBuffer: GAE over NaN-padded rewards and values within
    1e-6 (float32 in both, the same operations in the same order), and the
    same valid minibatch rows, in the same order, for the same seed;
  * IPPO: two updates from converted weights on the same minibatch, with
    and without fused_embed: every parameter within 1e-4 and Adam's
    moments beside them (torch_parity.assert_trainer_matches), the loss
    metrics within 1e-4 relative;
  * SB3MultiAgentEnv: 95 steps and a resample; NaN rows, rewards, dones,
    infos and info_dict exact, obs within the env bar (1e-5);
  * the MARL view's obs dict, rewards and dones; merge_actions; the
    RandomActor's draws; deterministic PolicyActor actions from a JAX
    policy.pkl and the port's policy.pt;
  * rollout by expert replay (metrics exact), and deterministic
    evaluate_policy over 2 batches and multi_policy_rollout (metrics
    exact: argmax of logits within 1e-5 of each other).
"""

import pickle
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.agents import PolicyActor as JaxPolicyActor
from gpudrive_lab_tpu.agents import RandomActor as JaxRandomActor
from gpudrive_lab_tpu.agents import merge_actions as jax_merge_actions
from gpudrive_lab_tpu.env.config import EnvConfig as JaxEnvConfig
from gpudrive_lab_tpu.env.dataset import SceneDataLoader as JaxLoader
from gpudrive_lab_tpu.env.env_jax import GPUDriveTPUEnv
from gpudrive_lab_tpu.env.wrappers import sb3_learner as jlearner
from gpudrive_lab_tpu.env.wrappers.marl_wrapper import (
    GPUDriveMARLEnv as JaxMARLEnv,
)
from gpudrive_lab_tpu.env.wrappers.sb3_wrapper import (
    SB3MultiAgentEnv as JaxSB3Env,
)
from gpudrive_lab_tpu.networks.late_fusion import (
    LateFusionPolicy as FlaxPolicy,
    PolicyConfig as FlaxPolicyConfig,
)
from gpudrive_lab_tpu.utils import evaluation as jeval
from gpudrive_lab_tpu.utils.multi_policy_rollout import (
    multi_policy_rollout as jax_multi_policy_rollout,
)
from gpudrive_lab_torch.agents import PolicyActor, RandomActor, merge_actions
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.env.wrappers import sb3_learner
from gpudrive_lab_torch.env.wrappers.marl_wrapper import GPUDriveMARLEnv
from gpudrive_lab_torch.env.wrappers.sb3_wrapper import SB3MultiAgentEnv
from gpudrive_lab_torch.networks.convert import params_from_flax
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionPolicy,
    PolicyConfig,
)
from gpudrive_lab_torch.rollout import SLICE_CONFIG
from gpudrive_lab_torch.utils import evaluation
from gpudrive_lab_torch.utils.multi_policy_rollout import (
    multi_policy_rollout,
)
from torch_parity import (
    POOL_SCENES,
    assert_flat_obs_match,
    assert_trainer_matches,
    flax_variables,
    jax_params,
    no_matplotlib,
    python_scene_compiler,
    scene_to_jax,
)

PATHS = [POOL_SCENES[i] for i in (20, 21)]  # 5 and 6 controlled agents


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("scenes")
    for i, k in enumerate((20, 21, 22, 23)):
        shutil.copy(POOL_SCENES[k], d / f"tfrecord-{i:02d}.json")
    return str(d)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---- MaskedRolloutBuffer ---------------------------------------------------

def _buffer_data(T=9, N=7, D=5, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    obs = rng.standard_normal((T, N, D)).astype(f)
    rew = rng.standard_normal((T, N)).astype(f)
    val = rng.standard_normal((T, N)).astype(f)
    dead = rng.random((T, N)) < 0.3
    rew[dead] = np.nan
    val[dead] = np.nan
    obs[dead] = np.nan
    starts = (rng.random((T, N)) < 0.2).astype(f)
    starts[2, 1] = np.nan
    return dict(obs=obs, action=rng.integers(0, 91, (T, N)), reward=rew,
                start=starts, value=val,
                logp=np.where(dead, np.nan, -rng.random((T, N))).astype(f),
                last_value=np.where(rng.random(N) < 0.3, np.nan,
                                    rng.standard_normal(N)).astype(f),
                dones=(rng.random(N) < 0.3).astype(f))


@pytest.mark.parametrize("seed", [0, 1])
def test_masked_buffer_matches_jax(seed):
    d = _buffer_data(seed=seed)
    T, N, D = d["obs"].shape
    buf = sb3_learner.MaskedRolloutBuffer(T, N, D)
    jbuf = jlearner.MaskedRolloutBuffer(T, N, D)
    for t in range(T):
        args = [d[k][t] for k in ("obs", "action", "reward", "start",
                                  "value", "logp")]
        buf.add(*[torch.from_numpy(np.asarray(a)) for a in args])
        jbuf.add(*args)
    buf.compute_returns_and_advantage(torch.from_numpy(d["last_value"]),
                                      torch.from_numpy(d["dones"]))
    jbuf.compute_returns_and_advantage(d["last_value"], d["dones"])
    for name in ("advantages", "returns"):
        np.testing.assert_allclose(_np(getattr(buf, name)),
                                   getattr(jbuf, name), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert buf.num_valid_samples == jbuf.num_valid_samples
    got = list(buf.get(8, np.random.default_rng(seed)))
    want = list(jbuf.get(8, np.random.default_rng(seed)))
    assert len(got) == len(want) == -(-jbuf.num_valid_samples // 8)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(_np(g["action"]), w["action"])
        for k in g:
            np.testing.assert_allclose(_np(g[k]), w[k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


# ---- IPPO ----------------------------------------------------------------

def _minibatch(n=12, seed=0):
    env = GPUDriveTorchEnv(EnvConfig(**SLICE_CONFIG), PATHS, device="cpu")
    obs = env.get_obs()[env.cont_agent_mask][:n]
    rng = np.random.default_rng(seed)
    n = obs.shape[0]
    f = np.float32
    return {"obs": obs.numpy(), "action": rng.integers(0, 91, n),
            "value": rng.standard_normal(n).astype(f),
            "logprob": (-4.5 + 0.1 * rng.standard_normal(n)).astype(f),
            "adv": rng.standard_normal(n).astype(f),
            "ret": rng.standard_normal(n).astype(f)}


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_ippo_update_matches_jax(fused):
    variables = flax_variables(seed=6)
    mb = _minibatch()
    cfg = sb3_learner.IPPOConfig()
    jcfg = jlearner.IPPOConfig()
    stub = types.SimpleNamespace(num_envs=4, obs_dim=3368, device="cpu",
                                 action_space_n=91,
                                 action_space=types.SimpleNamespace(n=91))
    ippo = sb3_learner.IPPO(stub, cfg, PolicyConfig(fused_embed=fused))
    ippo.policy.load_state_dict(params_from_flax(variables))
    jippo = jlearner.IPPO(stub, jcfg, FlaxPolicyConfig(fused_embed=fused))
    jvars = jax.tree.map(jnp.asarray, variables)
    jopt = jippo.tx.init(jvars)
    tmb = {k: torch.from_numpy(v) for k, v in mb.items()}
    jmb = {k: jnp.asarray(v) for k, v in mb.items()}
    for _ in range(2):
        aux = ippo.update(tmb)
        jvars, jopt, jaux = jippo._update(jvars, jopt, jmb,
                                          jax.random.PRNGKey(0))
        for k, v in jaux.items():
            np.testing.assert_allclose(float(aux[k]), float(v), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    assert_trainer_matches(ippo, jvars, jopt, tol=1e-4)


def test_ippo_learns_with_a_resample(data_dir):
    """learn on the SB3 env with a resample between rollouts: the buffer
    follows the new agent count, losses are finite, parameters move."""
    env = SB3MultiAgentEnv(EnvConfig(**SLICE_CONFIG),
                           SceneDataLoader(data_dir, 2, 100), device="cpu")
    n0 = env.num_envs
    ippo = sb3_learner.IPPO(
        env, sb3_learner.IPPOConfig(n_steps=4, batch_size=16, n_epochs=1,
                                    resample_freq=1),
        PolicyConfig(fused_embed=True), seed=1)
    before = [p.detach().clone() for p in ippo.policy.parameters()]
    hist = ippo.learn(total_timesteps=2 * 4 * n0 - 1)
    assert len(hist) == 2
    assert env.num_envs != n0  # the second batch, another agent count
    assert ippo.buffer.n_envs == env.num_envs
    for m in hist:
        assert all(np.isfinite(v) for v in m.values()), m
        assert m["valid_samples"] > 0
    assert any(not torch.equal(a, b)
               for a, b in zip(ippo.policy.parameters(), before))


# ---- SB3 and MARL wrappers ---------------------------------------------------

def test_sb3_env_matches_jax(data_dir):
    kw = dict(SLICE_CONFIG, collision_behavior="remove")
    env = SB3MultiAgentEnv(EnvConfig(**kw), SceneDataLoader(data_dir, 2, 100),
                           device="cpu")
    with python_scene_compiler():
        jenv = JaxSB3Env(JaxEnvConfig(**kw), JaxLoader(data_dir, 2, 100))
    assert (env.num_envs, env.obs_dim) == (jenv.num_envs, jenv.obs_dim)
    assert env.observation_space == jenv.observation_space
    assert env.action_space == jenv.action_space
    assert_flat_obs_match(env.reset(), jenv.reset())
    rng = np.random.default_rng(3)
    saw_dead = saw_info = False
    with python_scene_compiler():
        for t in range(95):
            if t == 60:
                env.resample_scenario_batch()
                jenv.resample_scenario_batch()
                assert env.num_envs == jenv.num_envs
                assert_flat_obs_match(env.reset(), jenv.reset())
            acts = rng.integers(0, 91, env.num_envs)
            obs, rew, dones, infos = env.step(torch.from_numpy(acts))
            jobs, jrew, jdones, jinfos = jenv.step(acts)
            np.testing.assert_array_equal(_np(rew), jrew)
            np.testing.assert_array_equal(_np(dones), jdones)
            assert infos == jinfos
            np.testing.assert_array_equal(_np(env.dead_agent_mask),
                                          jenv.dead_agent_mask)
            assert_flat_obs_match(obs, jobs)
            assert env.info_dict == jenv.info_dict
            assert env.num_episodes == jenv.num_episodes
            saw_dead |= bool(np.isnan(jrew).any())
            saw_info |= bool(jenv.info_dict)
    assert saw_dead and saw_info


def test_sb3_env_refuses_rendering(data_dir, monkeypatch):
    """Rendering is ported (tests/test_torch_periphery.py holds its frames
    and videos); on a machine without matplotlib the first rendered step
    raises rather than collecting no frames."""
    no_matplotlib(monkeypatch)
    env = SB3MultiAgentEnv(EnvConfig(**SLICE_CONFIG),
                           SceneDataLoader(data_dir, 2, 100), render=True,
                           device="cpu")
    env.reset()
    with pytest.raises(ModuleNotFoundError, match="matplotlib"):
        env.step(torch.zeros(env.num_envs, dtype=torch.int64))


def test_marl_env_matches_jax():
    env = GPUDriveTorchEnv(EnvConfig(**SLICE_CONFIG), PATHS[1:],
                           device="cpu")
    marl = GPUDriveMARLEnv(env.scene, env.params, env.action_keys)
    jmarl = JaxMARLEnv(scene_to_jax(env.scene), jax_params(env.params),
                       jnp.asarray(env.action_keys.numpy()))
    assert marl.agents == jmarl.agents and marl.num_agents == 6
    assert marl.observation_space_dim() == jmarl.observation_space_dim()
    assert marl.action_space_n() == jmarl.action_space_n()
    obs, state = marl.reset()
    jobs, jstate = jmarl.reset()
    rng = np.random.default_rng(5)
    for _ in range(3):
        names = list(obs)
        assert names == list(jobs)
        assert_flat_obs_match(torch.stack([obs[n] for n in names]),
                              np.stack([np.asarray(jobs[n]) for n in names]))
        acts = {n: int(a) for n, a in zip(names, rng.integers(0, 91, 6))}
        obs, state, rew, dones, infos = marl.step_env(None, state, acts)
        jobs, jstate, jrew, jdones, jinfos = jmarl.step_env(None, jstate,
                                                            acts)
        assert {n: float(v) for n, v in rew.items()} == {
            n: float(v) for n, v in jrew.items()}
        assert {n: bool(v) for n, v in dones.items()} == {
            n: bool(v) for n, v in jdones.items()}
        assert infos == jinfos


# ---- actors ----------------------------------------------------------------

def test_merge_actions_matches_jax():
    rng = np.random.default_rng(0)
    ids = rng.permutation(24)
    actions = {"a": rng.integers(0, 91, 10), "b": rng.integers(0, 91, 7)}
    idd = {"a": ids[:10], "b": ids[10:17]}
    got = merge_actions({k: torch.from_numpy(v) for k, v in actions.items()},
                        {k: torch.from_numpy(v) for k, v in idd.items()},
                        torch.zeros(4, 6))
    np.testing.assert_array_equal(
        got.numpy(), jax_merge_actions(actions, idd, np.zeros((4, 6))))


def test_random_actor_draws_as_jax():
    actor = RandomActor(None, 91, seed=11)
    jactor = JaxRandomActor(None, 91, seed=11)
    for n in (5, 17, 1):
        got = actor.select_action(torch.zeros(n, 3))
        np.testing.assert_array_equal(got.numpy(),
                                      jactor.select_action(np.zeros((n, 3))))


def test_policy_actor_loads_both_checkpoints(tmp_path):
    """A JAX policy.pkl and the port's policy.pt give the same
    deterministic actions, equal to the JAX actor's."""
    variables = flax_variables(seed=8)
    with open(tmp_path / "policy.pkl", "wb") as f:
        pickle.dump({"variables": variables, "global_step": 3}, f)
    env = GPUDriveTorchEnv(EnvConfig(**SLICE_CONFIG), PATHS, device="cpu")
    obs = env.get_obs()[env.cont_agent_mask]
    actor = PolicyActor(None, checkpoint_path=str(tmp_path / "policy.pkl"),
                        deterministic=True, device="cpu")
    torch.save({"policy": actor.policy.state_dict()}, tmp_path / "policy.pt")
    actor_pt = PolicyActor(None, checkpoint_path=str(tmp_path / "policy.pt"),
                           policy_config=PolicyConfig(fused_embed=True),
                           deterministic=True, device="cpu")
    jactor = JaxPolicyActor(None, variables=jax.tree.map(jnp.asarray,
                                                         variables),
                            deterministic=True)
    want = np.asarray(jactor.select_action(obs.numpy()))
    np.testing.assert_array_equal(actor.select_action(obs).numpy(), want)
    np.testing.assert_array_equal(actor_pt.select_action(obs).numpy(), want)
    with pytest.raises(ValueError, match="checkpoint_path"):
        PolicyActor(None, device="cpu")


# ---- evaluation ------------------------------------------------------------

def _eval_envs(data_dir, **overrides):
    kw = dict(SLICE_CONFIG, **overrides)
    env = GPUDriveTorchEnv(EnvConfig(**kw), device="cpu",
                           data_loader=SceneDataLoader(data_dir, 2, 100))
    with python_scene_compiler():
        jenv = GPUDriveTPUEnv(JaxEnvConfig(**kw),
                              data_loader=JaxLoader(data_dir, 2, 100))
    return env, jenv


def test_expert_replay_rollout_matches_jax(data_dir):
    env, jenv = _eval_envs(data_dir, collision_behavior="remove")
    got = evaluation.rollout(env)
    assert got == jeval.rollout(jenv)
    assert got["goal_achieved"] > 0.5


def test_evaluate_policy_matches_jax(data_dir):
    """Deterministic evaluation over 2 batches with a swap between them,
    fused embed in both packages."""
    variables = flax_variables(seed=2)
    env, jenv = _eval_envs(data_dir, collision_behavior="remove")
    policy = LateFusionPolicy(PolicyConfig(fused_embed=True), device="cpu")
    with python_scene_compiler():
        got = evaluation.evaluate_policy(env, policy,
                                         params_from_flax(variables),
                                         num_batches=2)
        want = jeval.evaluate_policy(
            jenv, FlaxPolicy(FlaxPolicyConfig(fused_embed=True)),
            jax.tree.map(jnp.asarray, variables), num_batches=2)
    assert got == want
    assert len(got["per_scene"]) == 4


def test_multi_policy_rollout_matches_jax(data_dir):
    """A PolicyActor (argmax) and a RandomActor on disjoint halves of the
    controlled agents, 40 steps."""
    variables = flax_variables(seed=4)
    env, jenv = _eval_envs(data_dir)
    ctrl = env.cont_agent_mask
    flat = torch.nonzero(ctrl.reshape(-1))[:, 0]
    half = torch.zeros(ctrl.numel(), dtype=torch.bool)
    half[flat[::2]] = True
    masks = {"policy": (half.reshape(ctrl.shape) & ctrl),
             "random": (~half.reshape(ctrl.shape) & ctrl)}
    actors = {"policy": PolicyActor(None, params_from_flax(variables),
                                    deterministic=True, device="cpu"),
              "random": RandomActor(None, 91, seed=3)}
    jactors = {"policy": JaxPolicyActor(
        None, variables=jax.tree.map(jnp.asarray, variables),
        deterministic=True), "random": JaxRandomActor(None, 91, seed=3)}
    got = multi_policy_rollout(env, actors, masks, max_steps=40)
    want = jax_multi_policy_rollout(
        jenv, jactors, {k: v.numpy() for k, v in masks.items()},
        max_steps=40)
    assert got == want
    # with render_sim_state the frames come too (held against the JAX
    # visualizer in tests/test_torch_periphery.py)
    _, frames = multi_policy_rollout(env, actors, masks, max_steps=2,
                                     render_sim_state=True)
    assert len(frames) == 2 and frames[0][0].dtype == np.uint8

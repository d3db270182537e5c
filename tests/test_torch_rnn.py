"""Recurrent PPO parity: the port's LSTM policy and trainer
(gpudrive_lab_torch/networks/late_fusion.py, ppo/ppo_rnn.py, ppo/train_rnn.py)
against the JAX package's on the same inputs, on the CPU.

  * the LSTM policy step against flax's within 1e-5 (logits, value and both
    carries), the carry reset by ``done``, and the bf16 dtype at the bars
    of ``test_lstm_policy_bf16_matches_flax``;
  * ``lstm_params_from_flax`` takes every flax leaf once;
  * a T-step rollout in the dense and flat layouts driven by the JAX
    rollout's actions, from a random LSTM state with one world marked just
    reset, starting 5 steps before the episodes end so that worlds finish
    and are reset inside it: rewards, dones, masks, ``reset_pre`` and the
    episode outcomes equal, log-probabilities, values and the LSTM state
    within 1e-5;
  * one train step (rollout, GAE and E epochs x M minibatches of BPTT) from
    the same parameters, trajectory and minibatch order: losses and
    parameters within 1e-4 with Adam's moments beside them, dense and flat,
    and the bf16 dtype with the bf16 observation store at ``bf16_bars``;
  * the dense layout on an agent axis bucketed to the batch (the test env's
    16 rows): the port sizes the LSTM state by the env's rows;
  * the CLI: two iterations, a resume from its own checkpoint and one from
    a JAX ``policy.pkl``.
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpudrive_lab_tpu.env.env_jax import ObsSpec as JaxObsSpec
from gpudrive_lab_tpu.networks.late_fusion import (
    LateFusionLSTMPolicy as FlaxLSTM,
    PolicyConfig as FlaxPolicyConfig,
)
from gpudrive_lab_tpu.ppo import ppo_rnn as jrnn
from gpudrive_lab_tpu.ppo.ppo import PPOConfig as JaxPPOConfig
from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.networks.convert import (
    load_jax_checkpoint,
    lstm_params_from_flax,
)
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionLSTMPolicy,
    PolicyConfig,
)
from gpudrive_lab_torch.ppo import train_rnn
from gpudrive_lab_torch.ppo.ppo import PPOConfig
from gpudrive_lab_torch.ppo.ppo_rnn import RnnCarry, RnnPPO
from gpudrive_lab_torch.rollout import slice_env
from torch_parity import (
    POOL_SCENES,
    assert_states_match,
    assert_trainer_matches,
    bf16_bars,
    jax_params,
    scene_to_jax,
    state_to_jax,
)

H = 32  # lstm_hidden
T = 8
START = C.EPISODE_LEN - 5
LAYOUTS = {"dense": {}, "flat": dict(compact=16, compact_mode="flat")}


def lstm_variables(seed=0, action_dim=91, hidden=H):
    """A flax parameter tree of the LSTM policy, every leaf drawn with
    numpy: kernels N(0, 1/fan_in), biases N(0, 0.1), LayerNorm scale
    1 + N(0, 0.1)."""
    cfg = FlaxPolicyConfig(action_dim=action_dim)
    pol = FlaxLSTM(cfg, lstm_hidden=hidden)
    shapes = jax.eval_shape(lambda: pol.init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.obs_dim)),
        pol.initialize_carry((1,)), jnp.zeros(1)))
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


def obs_rows(n, seed):
    """n observation rows drawn with numpy, partner rows past 40 zeroed (as
    missing partners are)."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((n, PolicyConfig().obs_dim)).astype(np.float32)
    obs[:, 6 + 40 * 6:768] = 0.0
    return obs


def port_policy(variables, dtype=torch.float32, action_dim=91):
    pol = LateFusionLSTMPolicy(PolicyConfig(action_dim=action_dim,
                                            dtype=dtype),
                               lstm_hidden=H, device="cpu")
    pol.load_state_dict(lstm_params_from_flax(variables))
    return pol


def test_converter_takes_every_leaf_once():
    variables = lstm_variables()
    sd = lstm_params_from_flax(variables)
    n_leaves = len(jax.tree_util.tree_leaves(variables))
    pol = LateFusionLSTMPolicy(PolicyConfig(), lstm_hidden=H, device="cpu")
    assert set(sd) == set(pol.state_dict())
    # the four gates' kernels are packed side by side: 4 + 4 + 4 biases
    # into 3 tensors, every other leaf one to one
    assert len(sd) == n_leaves - 12 + 3
    stray = jax.tree.map(lambda x: x, variables)
    stray["params"]["OptimizedLSTMCell_0"]["extra"] = {
        "kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="extra"):
        lstm_params_from_flax(stray)


def test_lstm_policy_step_matches_flax():
    """One step from a random carry with some rows done: logits, value and
    both carries within 1e-5; then a second step from the new carry."""
    variables = lstm_variables(1)
    jpol = FlaxLSTM(FlaxPolicyConfig(), lstm_hidden=H)
    pol = port_policy(variables)
    rng = np.random.default_rng(2)
    obs = obs_rows(12, 3)
    c0, h0 = rng.standard_normal((2, 12, H)).astype(np.float32)
    done = (rng.random(12) < 0.3).astype(np.float32)
    jcarry = (jnp.asarray(c0), jnp.asarray(h0))
    carry = (torch.from_numpy(c0), torch.from_numpy(h0))
    for _ in range(2):
        jcarry, jlogits, jvalue = jpol.apply(variables, jnp.asarray(obs),
                                             jcarry, jnp.asarray(done))
        with torch.no_grad():
            carry, logits, value = pol(torch.from_numpy(obs), carry,
                                       torch.from_numpy(done))
        for got, want in ((logits, jlogits), (value, jvalue),
                          (carry[0], jcarry[0]), (carry[1], jcarry[1])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5)
        done = np.zeros_like(done)


def test_lstm_policy_carry_reset():
    """done = 1 gives the step from a zero carry; the memory carries over
    to a second step otherwise."""
    pol = port_policy(lstm_variables(4))
    obs = torch.from_numpy(obs_rows(4, 5))
    with torch.no_grad():
        c1, logits, _ = pol(obs, pol.initialize_carry((4,)), torch.zeros(4))
        _, logits2, _ = pol(obs, c1, torch.zeros(4))
        _, logits_reset, _ = pol(obs, c1, torch.ones(4))
    assert not torch.allclose(logits, logits2)
    torch.testing.assert_close(logits_reset, logits, rtol=0, atol=0)


def test_lstm_policy_bf16_matches_flax():
    """The bf16 dtype against flax's bf16 module on the same inputs.  Both
    round the same operations to bf16 but sum the products in another
    order, so a bf16 value can land one ulp (2^-8 relative) apart and carry
    on through the next operations: logits within 2e-2 of the largest logit
    magnitude and at most 5% of them beyond 4e-3 of it, the value within
    2e-2 of its largest magnitude, the carries (float32, from bf16 gates)
    within 2e-2.  Readings: 0.0048, 1.0%, 0.0063, and 0.0064 and 0.0043 (c
    and h, largest magnitudes 1.58 and 0.75)."""
    variables = lstm_variables(6)
    jpol = FlaxLSTM(FlaxPolicyConfig(dtype=jnp.bfloat16), lstm_hidden=H)
    pol = port_policy(variables, torch.bfloat16)
    rng = np.random.default_rng(7)
    obs = obs_rows(64, 8)
    c0, h0 = (0.5 * rng.standard_normal((2, 64, H))).astype(np.float32)
    done = (rng.random(64) < 0.2).astype(np.float32)
    jcarry, jlogits, jvalue = jpol.apply(
        variables, jnp.asarray(obs), (jnp.asarray(c0), jnp.asarray(h0)),
        jnp.asarray(done))
    with torch.no_grad():
        carry, logits, value = pol(
            torch.from_numpy(obs), (torch.from_numpy(c0),
                                    torch.from_numpy(h0)),
            torch.from_numpy(done))
    assert carry[0].dtype == carry[1].dtype == torch.float32
    scale = float(np.abs(np.asarray(jlogits)).max())
    err = np.abs(logits.numpy() - np.asarray(jlogits))
    assert err.max() <= 2e-2 * scale, err.max()
    assert (err > 4e-3 * scale).mean() <= 0.05
    vscale = float(np.abs(np.asarray(jvalue)).max())
    assert np.abs(value.numpy() - np.asarray(jvalue)).max() <= 2e-2 * vscale
    for got, want in zip(carry, jcarry):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-2


# ---- the trainer -----------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    """Two pool worlds (5 and 6 controlled agents, agent axis bucketed to
    16), the state START steps into the episode and the t=0 reset state."""
    env = slice_env(POOL_SCENES[20:22], device="cpu", agent_bucket="auto")
    fresh = stepmod.reset(env.scene, None, env.params)
    state = fresh
    zero = torch.zeros((env.num_worlds, env.max_agent_count, C.ACTION_DIM))
    for _ in range(START):
        state = stepmod.step(env.scene, state, zero, env.params)
    return env, state, fresh


def _config(layout, **overrides):
    return PPOConfig(**{**dict(rollout_len=T, update_epochs=2,
                               num_minibatches=2), **LAYOUTS[layout],
                        **overrides})


def _trainer(env, variables, cfg):
    dtype = (torch.bfloat16 if cfg.policy_dtype == "bfloat16"
             else torch.float32)
    pol = port_policy(variables, dtype, env.action_space_n)
    return RnnPPO(pol, env.params, env.spec, env.action_keys,
                  env.config.reward_type, cfg)


def _jax_funcs(env, cfg):
    """The JAX package's (train_step, rollout) for a port env and config:
    ``rollout`` is the function train_step closes over."""
    jpol = FlaxLSTM(FlaxPolicyConfig(
        action_dim=env.action_space_n,
        dtype=(jnp.bfloat16 if cfg.policy_dtype == "bfloat16"
               else jnp.float32)), lstm_hidden=H)
    fields = {f.name for f in dataclasses.fields(JaxPPOConfig)}
    jcfg = JaxPPOConfig(**{k: v for k, v in dataclasses.asdict(cfg).items()
                           if k in fields})
    init_fn, train_step = jrnn.make_rnn_ppo_funcs(
        jpol, jax_params(env.params),
        JaxObsSpec(**dataclasses.asdict(env.spec)),
        jnp.asarray(env.action_keys.numpy()), env.config.reward_type, jcfg)
    closure = dict(zip(train_step.__code__.co_freevars,
                       (c.cell_contents for c in train_step.__closure__)))
    return init_fn, jax.jit(train_step), jax.jit(closure["rollout"])


def _start(env, rnn, state, seed):
    """The port's and the JAX package's carry at ``state``: a random LSTM
    state and world 0 marked just reset."""
    rng = np.random.default_rng(seed)
    c0, h0 = rnn.initial_lstm(env.scene)
    c0, h0 = (0.5 * rng.standard_normal((2,) + tuple(c0.shape))).astype(
        np.float32)
    jr = np.zeros(env.num_worlds, bool)
    jr[0] = True
    wts = torch.full((env.num_worlds,), START, dtype=torch.int32)
    carry = RnnCarry(state, (torch.from_numpy(c0), torch.from_numpy(h0)),
                     wts, torch.Generator().manual_seed(seed),
                     torch.from_numpy(jr))
    jcarry = jrnn.RnnCarry(
        state=state_to_jax(state), lstm=(jnp.asarray(c0), jnp.asarray(h0)),
        world_time_steps=jnp.asarray(wts.numpy()),
        rng=jax.random.PRNGKey(seed), just_reset=jnp.asarray(jr))
    return carry, jcarry


def _jax_inputs(env, fresh, variables):
    return (scene_to_jax(env.scene), jax.tree.map(jnp.asarray, variables),
            state_to_jax(fresh), jnp.asarray(env.reward_weights.numpy()))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_rollout_matches_jax(setup, layout):
    env, state, fresh = setup
    variables = lstm_variables(3, env.action_space_n)
    cfg = _config(layout)
    rnn = _trainer(env, variables, cfg)
    _, _, jrollout = _jax_funcs(env, cfg)
    jscene, jvars, jfresh, jrw = _jax_inputs(env, fresh, variables)
    carry, jcarry = _start(env, rnn, state, 5)
    jcarry, jtraj = jax.tree.map(np.asarray, jrollout(jscene, jvars, jcarry,
                                                      jfresh, jrw))
    carry, traj = rnn.rollout(env.scene, carry, fresh, env.reward_weights,
                              actions=torch.from_numpy(jtraj.action.copy()))
    assert bool(traj.ep_done.any()), "no world finished inside the rollout"
    assert bool((traj.reset_pre[1:] > 0).any())
    for name in ("action", "reward", "done", "mask", "reset_pre", "ep_done",
                 "ep_goal", "ep_collided", "ep_off_road"):
        np.testing.assert_array_equal(getattr(traj, name).numpy(),
                                      getattr(jtraj, name), err_msg=name)
    for name in ("value", "logprob"):
        np.testing.assert_allclose(getattr(traj, name).numpy(),
                                   getattr(jtraj, name), rtol=0, atol=1e-5,
                                   err_msg=name)
    for got, want in zip(carry.lstm, jcarry.lstm):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(carry.just_reset.numpy(), jcarry.just_reset)
    np.testing.assert_array_equal(carry.world_time_steps.numpy(),
                                  jcarry.world_time_steps)
    assert_states_match(jcarry.state, carry.state, where="after the rollout")


def _jax_perms(key, cfg, rows):
    """The minibatch rows the JAX train step draws from the carry's key
    after the rollout (ppo_rnn.py:274-279, 315-316)."""
    rng_epochs, _ = jax.random.split(key)
    M = min(cfg.num_minibatches, rows)
    return np.stack([np.asarray(jax.random.permutation(k, rows)).reshape(
        M, rows // M) for k in jax.random.split(rng_epochs,
                                                cfg.update_epochs)])


UPDATES = {
    "dense": ("dense", {}),
    "flat": ("flat", {}),
    "flat-bf16": ("flat", dict(policy_dtype="bfloat16",
                               obs_store_dtype="bfloat16")),
}


@pytest.mark.parametrize("name", list(UPDATES))
def test_train_step_matches_jax(setup, name):
    env, state, fresh = setup
    layout, over = UPDATES[name]
    variables = lstm_variables(9, env.action_space_n)
    cfg = _config(layout, **over)
    rnn = _trainer(env, variables, cfg)
    _, jtrain, jrollout = _jax_funcs(env, cfg)
    jscene, jvars, jfresh, jrw = _jax_inputs(env, fresh, variables)
    carry, jcarry = _start(env, rnn, state, 11)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(cfg.learning_rate, eps=1e-5))
    out = jtrain(jscene, jvars, tx.init(jvars), jcarry, jfresh, jrw,
                 jnp.float32(cfg.ent_coef))
    jvars_new, jopt, _, jm = jax.tree.map(np.asarray, out)
    jcarry_mid, jtraj = jrollout(jscene, jvars, jcarry, jfresh, jrw)
    perms = _jax_perms(jcarry_mid.rng, cfg, jtraj.action.shape[1])

    init_lstm = carry.lstm
    carry, traj = rnn.rollout(env.scene, carry, fresh, env.reward_weights,
                              actions=torch.from_numpy(
                                  np.array(jtraj.action)))
    m = rnn.update(env.scene, carry, traj, env.reward_weights, init_lstm,
                   perms=perms)
    bf16 = cfg.policy_dtype == "bfloat16"
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl"):
        bar = 1e-4 + (1e-2 * abs(float(jm[k])) if bf16 else 0.0)
        assert abs(float(m[k]) - float(jm[k])) <= bar, (k, m[k], jm[k])
    for k in ("samples", "episodes", "mean_reward", "perc_goal_achieved",
              "perc_collisions", "perc_off_road"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6,
                                   err_msg=k)
    loose = (bf16_bars(cfg, lstm_params_from_flax(variables)) if bf16
             else None)
    assert_trainer_matches(rnn, jvars_new, jopt, loose=loose)


def test_dense_auto_bucket_sizes_lstm_by_env_rows(setup):
    """The dense layout on the 16-row bucketed agent axis: the port's LSTM
    state has the env's rows; the JAX init_fn sizes it (W, 128), which the
    JAX train step cannot broadcast against the 16-row done mask (a fault
    of the JAX package, ROADMAP Queue C), while a 16-row carry runs."""
    env, state, fresh = setup
    cfg = _config("dense")
    rnn = _trainer(env, lstm_variables(0, env.action_space_n), cfg)
    c, h = rnn.initial_lstm(env.scene)
    assert env.max_agent_count == 16
    assert c.shape == h.shape == (env.num_worlds, 16, H)
    init_fn, jtrain, _ = _jax_funcs(env, cfg)
    _, _, jlstm = init_fn(jax.random.PRNGKey(0), env.num_worlds,
                          jnp.zeros((1, PolicyConfig().obs_dim)))
    assert jlstm[0].shape == (env.num_worlds, C.MAX_AGENTS, H)
    variables = lstm_variables(0, env.action_space_n)
    jscene, jvars, jfresh, jrw = _jax_inputs(env, fresh, variables)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(cfg.learning_rate, eps=1e-5))
    _, jcarry = _start(env, rnn, state, 1)
    with pytest.raises(TypeError, match="broadcast|shapes"):
        jtrain(jscene, jvars, tx.init(jvars), jcarry._replace(lstm=jlstm),
               jfresh, jrw, jnp.float32(cfg.ent_coef))


# ---- the CLI -----------------------------------------------------------------


def _scene_dir(tmp_path, n=2):
    d = tmp_path / "scenes"
    d.mkdir()
    for i, p in enumerate(POOL_SCENES[20:20 + n]):
        (d / f"tfrecord-{i}.json").write_text(open(p).read())
    return str(d)


def _run(argv, capsys):
    train_rnn.main(argv)
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_cli_trains_and_resumes(tmp_path, capsys):
    """Two iterations on the CPU, then a resume from policy.pt: the step
    count carries on and the resumed run's first parameters are the saved
    ones."""
    data = _scene_dir(tmp_path)
    ckpt = tmp_path / "ckpt"
    base = ["--device", "cpu", "--data-dir", data, "--num-worlds", "2",
            "--rollout-len", "8", "--num-minibatches", "2",
            "--lstm-hidden", "16", "--agent-bucket", "auto",
            "--checkpoint-path", str(ckpt)]
    # the first batch's controlled agents x 8 steps bounds one iteration's
    # samples, so one more than that takes at least two iterations
    args = train_rnn.parse_args(base)
    env, _, _, _ = train_rnn.build(args)
    cap = int(env.scene.agents.controlled.sum()) * 8
    lines = _run(base + ["--total-timesteps", str(cap + 1)], capsys)
    final = lines[-1]["final_global_step"]
    assert lines[-2]["iteration"] >= 2 and final > cap
    assert all(np.isfinite(lines[-2][k]) for k in ("pg_loss", "v_loss"))
    saved = torch.load(ckpt / "policy.pt", map_location="cpu")
    assert saved["global_step"] == final
    assert saved["arch"] == {"lstm_hidden": 16, "action_dim": 91}
    lines = _run(base + ["--total-timesteps", str(final + 1),
                         "--continue-training"], capsys)
    assert lines[0] == {"resumed_from": final}
    assert lines[-2]["iteration"] == 1
    assert len(open(ckpt / "rnn.metrics.jsonl").readlines()) == 2


def test_cli_resumes_from_jax_checkpoint(tmp_path, capsys):
    """A policy.pkl as scripts/train_rnn.py writes it (variables, optax
    state, global_step, arch) loads into the port's trainer: parameters
    exact, Adam's moments and step count mapped; the CLI resumes from it."""
    data = _scene_dir(tmp_path)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    variables = lstm_variables(12, 91, hidden=16)
    tx = optax.chain(optax.clip_by_global_norm(0.5),
                     optax.adam(3e-4, eps=1e-5))
    jvars = jax.tree.map(jnp.asarray, variables)
    opt_state = tx.init(jvars)
    grads = jax.tree.map(lambda x: 0.01 * jnp.ones_like(x), jvars)
    _, opt_state = tx.update(grads, opt_state, jvars)
    with open(ckpt / "policy.pkl", "wb") as f:
        pickle.dump({"variables": jax.tree.map(np.asarray, variables),
                     "opt_state": jax.tree.map(np.asarray, opt_state),
                     "global_step": 40,
                     "arch": {"lstm_hidden": 16, "action_dim": 91}}, f)
    base = ["--device", "cpu", "--data-dir", data, "--num-worlds", "2",
            "--rollout-len", "8", "--num-minibatches", "2",
            "--lstm-hidden", "16", "--agent-bucket", "auto",
            "--checkpoint-path", str(ckpt)]
    _, rnn, _, _ = train_rnn.build(train_rnn.parse_args(base))
    assert train_rnn.load_checkpoint(ckpt, rnn) == 40
    want = lstm_params_from_flax(variables)
    for k, v in rnn.policy.state_dict().items():
        assert torch.equal(v, want[k]), k
    for st in rnn.optimizer.state.values():
        assert float(st["step"]) == 1.0
        assert float(st["exp_avg"].abs().max()) > 0
    assert load_jax_checkpoint(ckpt / "policy.pkl", rnn.policy) == 40
    lines = _run(base + ["--total-timesteps", "41", "--continue-training"],
                 capsys)
    assert lines[0] == {"resumed_from": 40}
    assert lines[-1]["final_global_step"] > 40


def test_entry_points_refuse_without_cuda(monkeypatch, tmp_path):
    """The LSTM policy and the CLI ask for CUDA unless told otherwise, and
    raise without it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LateFusionLSTMPolicy()
    with pytest.raises(RuntimeError, match="CUDA"):
        train_rnn.main(["--data-dir", _scene_dir(tmp_path), "--num-worlds",
                        "2", "--checkpoint-path", str(tmp_path / "c")])

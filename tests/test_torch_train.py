"""The port's PPO entry point (gpudrive_lab_torch/ppo/train.py) and the
carrying of state between the two packages, on the CPU:

  * build_trainer: the compaction capacity check, the init_steps warm-up of
    every reset (as the JAX env applies it), and the JAX package's dispatch
    options accepted as aliases with the same samples and metrics;
  * checkpoints: the port's own round trip, and a JAX trainer's policy.pkl
    (parameters and Adam state) resumed in the port, where one further
    update matches the JAX update to 1e-4;
  * the CLI: trains 2 iterations on 2 worlds, writes a checkpoint that
    --continue-training resumes, and refuses what is not ported yet.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gpudrive_lab_tpu.env.config import EnvConfig as JaxEnvConfig
from gpudrive_lab_tpu.env.env_jax import GPUDriveTPUEnv
from gpudrive_lab_tpu.ppo import train as jtrain
from gpudrive_lab_tpu.ppo.ppo import EnvCarry as JaxCarry
from gpudrive_lab_torch.networks import convert
from gpudrive_lab_torch.ppo import train
from gpudrive_lab_torch.ppo.ppo import PPOConfig
from gpudrive_lab_torch.rollout import SLICE_CONFIG, slice_env
from torch_parity import (
    POOL_SCENES,
    ROOT,
    assert_states_match,
    flax_variables,
    jax_minibatch_order,
    jax_ppo,
    python_scene_compiler,
    scene_to_jax,
    state_to_jax,
    traj_to_jax,
)

PATHS = POOL_SCENES[20:22]  # 5 and 6 controlled agents
SMALL = dict(rollout_len=8, update_epochs=2, num_minibatches=2)


@pytest.fixture(scope="module")
def env():
    return slice_env(PATHS, device="cpu", agent_bucket="auto")


def test_check_compact_capacity_refuses_overflow(env):
    check = train.check_compact_capacity
    check(env, 6, "world")
    check(env, 11, "flat")
    check(env, 12, "flat", compact_blocks=2)
    with pytest.raises(ValueError, match="per world"):
        check(env, 5, "world")
    with pytest.raises(ValueError, match="total 11"):
        check(env, 10, "flat")
    with pytest.raises(ValueError, match="blocks"):
        check(env, 10, "flat", compact_blocks=2)
    with pytest.raises(ValueError):
        train.build_trainer(env, PPOConfig(**SMALL, compact=10,
                                           compact_mode="flat"))


def test_init_steps_warms_reset_as_jax():
    """init_steps=3: the env's reset plays 3 expert steps, its clocks read
    3, and the trainer's auto-reset target and clock restart there."""
    kw = dict(SLICE_CONFIG, init_steps=3)
    env = slice_env(PATHS, device="cpu", init_steps=3)
    with python_scene_compiler():
        jenv = GPUDriveTPUEnv(JaxEnvConfig(num_worlds=len(PATHS), **kw),
                              scene_paths=PATHS)
    assert_states_match(jenv.state, env.state, where="after the reset")
    np.testing.assert_array_equal(env.world_time_steps.numpy(),
                                  np.asarray(jenv.world_time_steps))
    assert env.world_time_steps.tolist() == [3, 3]
    env.step_dynamics(None)
    env.reset([1])  # a per-world reset comes back warmed up too
    assert env.world_time_steps.tolist() == [4, 3]
    ppo, carry, fresh, _ = train.build_trainer(env, PPOConfig(**SMALL))
    assert ppo.config.reset_time_step == 3
    assert carry.world_time_steps.tolist() == [3, 3]
    jfresh = jtrain.make_fresh(jenv)
    assert_states_match(jfresh, fresh, where="make_fresh")


def _one_iteration(env, **build):
    ppo, carry, fresh, fn = train.build_trainer(
        env, PPOConfig(**SMALL, compact=16, compact_mode="flat"), seed=3,
        **build)
    carry, m = fn(env.scene, carry, fresh, env.reward_weights)
    return m, ppo.policy.state_dict()


def test_dispatch_options_are_aliases(env):
    base_m, base_sd = _one_iteration(env)
    for build in (dict(rollout_mode="unroll"), dict(rollout_mode="loop"),
                  dict(rollout_mode="dispatch"), dict(packed_io=True)):
        m, sd = _one_iteration(env, **build)
        for k in base_m:
            assert torch.equal(m[k], base_m[k]), (build, k)
        for k in base_sd:
            assert torch.equal(sd[k], base_sd[k]), (build, k)
    # K iterations per call: the same as K calls, with a leading [K] axis
    ppo, carry, fresh, fn = train.build_trainer(
        env, PPOConfig(**SMALL), seed=3, iters_per_dispatch=2)
    _, folded = fn(env.scene, carry, fresh, env.reward_weights)
    ppo, carry, fresh, fn = train.build_trainer(env, PPOConfig(**SMALL),
                                                seed=3)
    for i in range(2):
        carry, m = fn(env.scene, carry, fresh, env.reward_weights)
        for k in m:
            assert torch.equal(folded[k][i], m[k]), k
    for build in (dict(rollout_mode="dispatch", packed_io=True),
                  dict(rollout_mode="loop", iters_per_dispatch=2),
                  dict(rollout_mode="nope")):
        with pytest.raises(ValueError):
            train.build_trainer(env, PPOConfig(**SMALL), **build)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.build_trainer(env, PPOConfig(**SMALL, policy_dtype="bfloat16"))


def test_checkpoint_round_trip(env, tmp_path):
    ppo, carry, fresh, fn = train.build_trainer(env, PPOConfig(**SMALL))
    fn(env.scene, carry, fresh, env.reward_weights)
    train.save_checkpoint(tmp_path, ppo.policy, ppo.optimizer, 1, 88)
    other, *_ = train.build_trainer(env, PPOConfig(**SMALL), seed=9)
    assert train.load_checkpoint(tmp_path, other.policy,
                                 other.optimizer) == 88
    for k, v in ppo.policy.state_dict().items():
        assert torch.equal(v, other.policy.state_dict()[k]), k
    a, b = ppo.optimizer.state_dict(), other.optimizer.state_dict()
    for i, st in a["state"].items():
        for k, v in st.items():
            assert torch.equal(v, b["state"][i][k]), (i, k)
    assert train.load_checkpoint(tmp_path / "none", other.policy) is None


def test_jax_checkpoint_resumes_in_the_port(env, tmp_path):
    """A JAX update's parameters and optax Adam state, saved by the JAX
    trainer's save_checkpoint, load into the port; one further update on
    the same trajectory and minibatch order then matches the JAX one."""
    cfg = PPOConfig(**SMALL, compact=16, compact_mode="flat")
    ppo, carry, fresh, _ = train.build_trainer(env, cfg, seed=1)
    variables = flax_variables(seed=3, action_dim=env.action_space_n)
    ppo.policy.load_state_dict(convert.params_from_flax(variables))
    carry, traj = ppo.rollout(env.scene, carry, fresh, env.reward_weights)
    _, fns = jax_ppo(env, cfg)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(cfg.learning_rate, eps=1e-5))
    jvars = jax.tree.map(jnp.asarray, variables)
    jopt = tx.init(jvars)
    args = (scene_to_jax(env.scene), traj_to_jax(traj),
            jnp.asarray(env.reward_weights.numpy()), jnp.float32(cfg.ent_coef))
    jstate = state_to_jax(carry.state)
    jwts = jnp.asarray(carry.world_time_steps.numpy())

    def jax_update(jvars, jopt, key):
        return fns["update"](args[0], jvars, jopt, JaxCarry(jstate, jwts, key),
                             *args[1:])

    jvars, jopt, _, _ = jax_update(jvars, jopt, jax.random.PRNGKey(1))
    jtrain.save_checkpoint(tmp_path, jax.tree.map(np.asarray, jvars),
                           jax.tree.map(np.asarray, jopt), 1, 88)
    other, *_ = train.build_trainer(env, cfg, seed=5)
    assert train.load_checkpoint(tmp_path, other.policy,
                                 other.optimizer) == 88
    key = jax.random.PRNGKey(2)
    jvars, jopt, _, jm = jax.tree.map(np.asarray, jax_update(jvars, jopt,
                                                             key))
    perms, _ = jax_minibatch_order(key, cfg)
    m = other.update(env.scene, carry, traj, env.reward_weights, perms=perms)
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-4, k
    want = convert.params_from_flax(jvars)
    for k, v in other.policy.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-4,
                                   err_msg=k)
    adam = convert.adam_state_from_optax(jopt, other.policy)
    for i, p in enumerate(other.policy.parameters()):
        assert float(other.optimizer.state[p]["step"]) == float(
            adam[i]["step"]) == 8.0  # two updates of 2 x 2 minibatches
        np.testing.assert_allclose(
            other.optimizer.state[p]["exp_avg"].numpy(),
            adam[i]["exp_avg"].numpy(), rtol=1e-3, atol=1e-6)


def _cli(*args, timeout=300):
    out = subprocess.run(
        [sys.executable, "-m", "gpudrive_lab_torch.ppo.train", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def test_cli_trains_and_resumes(tmp_path):
    """2 iterations on 2 worlds (88 samples each) and a checkpoint; then
    --continue-training resumes from its global step for one more."""
    common = ["--device", "cpu", "--num-worlds", "2", "--rollout-len", "8",
              "--num-minibatches", "2", "--update-epochs", "1",
              "--agent-bucket", "auto", "--compact", "16", "--compact-mode",
              "flat", "--checkpoint-path", str(tmp_path),
              "--data-dir", os.path.dirname(PATHS[0])]
    # the CLI takes the first --num-worlds sorted scenes: copy the two
    data = tmp_path / "scenes"
    data.mkdir()
    for p in PATHS:
        (data / os.path.basename(p)).write_text(Path(p).read_text())
    common[-1] = str(data)
    lines = _cli(*common, "--total-timesteps", "150")
    assert lines[-1] == {"final_global_step": 176}
    ckpt = torch.load(tmp_path / train.CHECKPOINT)
    assert (ckpt["iteration"], ckpt["global_step"]) == (2, 176)
    lines = _cli(*common, "--total-timesteps", "200", "--continue-training")
    assert {"resumed_from": 176} in lines
    assert lines[-1] == {"final_global_step": 264}


def test_cli_refuses_what_is_not_ported():
    for flag in (["--resample-interval", "5"], ["--video-interval", "1"],
                 ["--dashboard"], ["--policy-dtype", "bf16"]):
        with pytest.raises(SystemExit, match="ROADMAP"):
            train.main(["--device", "cpu", *flag])


def test_cli_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--num-worlds", "1", "--total-timesteps", "1"])

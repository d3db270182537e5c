"""The port's entry points outside the package against the JAX scripts they
port, on the same inputs:

  * ``utils/eval_checkpoint`` (``scripts/eval_checkpoint.py``): a trainer
    checkpoint of seeded flax weights converted by the port's converter,
    and the examples' synthetic reference checkpoint (safetensors), each
    evaluated deterministically on 3 pool_v3 worlds: the goal, collision
    and off-road rates equal the JAX ``multi_policy_rollout`` of
    ``PolicyActor(variables=...)``;
  * ``bench_sb3`` (``scripts/bench_sb3.py``): bench.py's JSON schema; with
    one action given to every agent on both sides, ``num_envs`` and each
    window's live samples equal to the JAX SB3 wrapper and IPPO's on the
    same scenes, and ``valid_samples`` their timed windows' sum;
  * ``scene/pool`` (``scripts/make_scene_pool.py``, loaded with importlib):
    the same scenes, JSON byte for byte, for 8 v3 and 4 v2 seeds; ``main``
    writes seeds 1000-1007 equal to the files of data/pool_v3; the port's
    ``validate_pool`` prints the JAX ``validate_pool``'s counts;
  * ``entry`` (``__graft_entry__.py``): logits and value within 1e-5 of the
    JAX ``entry()`` under converted weights;
  * ``scripts/campaign_report.py`` (shared by both packages) on the JSONL
    that 2 iterations of the port's trainer write.
"""

import importlib.util
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.agents import PolicyActor as JaxPolicyActor
from gpudrive_lab_tpu.env.config import EnvConfig as JaxEnvConfig
from gpudrive_lab_tpu.env.dataset import SceneDataLoader as JaxLoader
from gpudrive_lab_tpu.env.env_jax import GPUDriveTPUEnv
from gpudrive_lab_tpu.env.wrappers.sb3_learner import IPPO as JaxIPPO
from gpudrive_lab_tpu.env.wrappers.sb3_learner import (
    IPPOConfig as JaxIPPOConfig,
)
from gpudrive_lab_tpu.env.wrappers.sb3_wrapper import (
    SB3MultiAgentEnv as JaxSB3Env,
)
from gpudrive_lab_tpu.networks.convert import load_pretrained as jax_pretrained
from gpudrive_lab_tpu.networks.late_fusion import (
    PolicyConfig as FlaxPolicyConfig,
)
from gpudrive_lab_tpu.utils.multi_policy_rollout import (
    multi_policy_rollout as jax_rollout,
)
from gpudrive_lab_torch import bench_sb3, entry
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.env.wrappers.sb3_learner import IPPO
from gpudrive_lab_torch.env.wrappers.sb3_wrapper import SB3MultiAgentEnv
from gpudrive_lab_torch.networks.convert import params_from_flax
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionPolicy,
    PolicyConfig,
)
from gpudrive_lab_torch.ppo import train
from gpudrive_lab_torch.scene import pool
from gpudrive_lab_torch.utils import eval_checkpoint
from torch_parity import POOL_SCENES, ROOT, flax_variables


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MSP = _load("make_scene_pool", "scripts/make_scene_pool.py")
GRAFT = _load("graft_entry", "__graft_entry__.py")
REPORT = _load("campaign_report", "scripts/campaign_report.py")
EXAMPLE_09 = _load("pretrained_policy_example",
                   "examples/torch/09_pretrained_policy.py")
EVAL_WORLDS = 3


def _json_lines(capsys):
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()
            if x.startswith("{")]


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """A directory of the first EVAL_WORLDS pool_v3 scenes."""
    d = tmp_path_factory.mktemp("scenes")
    for p in POOL_SCENES[:EVAL_WORLDS]:
        shutil.copy(p, d)
    return str(d)


def jax_eval(scenes_dir, variables, policy_config):
    """scripts/eval_checkpoint.py's deterministic episode with the policy
    handed in as flax variables: (rates, controlled agents)."""
    paths = sorted(os.path.join(scenes_dir, f) for f in os.listdir(scenes_dir))
    env = GPUDriveTPUEnv(
        JaxEnvConfig(
            num_worlds=len(paths), reward_type="weighted_combination",
            collision_weight=-0.75, off_road_weight=-0.75,
            goal_achieved_weight=1.0, dynamics_model="classic",
            collision_behavior="ignore", init_steps=11,
            remove_non_vehicles=True),
        scene_paths=paths)
    actor = JaxPolicyActor(None, variables=variables,
                           policy_config=policy_config, deterministic=True)
    actor._rng = jax.random.PRNGKey(0)
    mask = np.asarray(env.cont_agent_mask)
    return (jax_rollout(env, {"policy": actor}, {"policy": mask})["policy"],
            int(mask.sum()))


@pytest.mark.parametrize("source", ["trainer", "reference"])
def test_eval_checkpoint_matches_jax(source, scenes, tmp_path, capsys):
    argv = ["--scenes-dir", scenes, "--num-worlds", str(EVAL_WORLDS),
            "--device", "cpu"]
    if source == "trainer":
        variables = flax_variables(seed=5)
        pc = FlaxPolicyConfig(action_dim=91)
        policy = LateFusionPolicy(PolicyConfig(action_dim=91), device="cpu")
        policy.load_state_dict(params_from_flax(variables))
        train.save_checkpoint(tmp_path, policy,
                              torch.optim.Adam(policy.parameters()), 1, 10)
        # the directory names the trainer's checkpoint; two deterministic
        # episodes are forced to one, with the JAX script's note
        got = eval_checkpoint.main(argv + ["--checkpoint", str(tmp_path),
                                           "--episodes", "2"])
    else:
        ck = EXAMPLE_09.synth_checkpoint()
        try:
            _, variables, pc = jax_pretrained(ck)
            got = eval_checkpoint.main(argv + ["--checkpoint", ck])
        finally:
            shutil.rmtree(ck)
    lines = _json_lines(capsys)
    assert lines[-1] == got
    if source == "trainer":
        assert lines[0] == {"note": "deterministic mode: episodes forced to 1"}
    want, n = jax_eval(scenes, variables, pc)
    for k in ("goal_achieved", "collided", "off_road"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert (got["episodes"], got["controlled_agents"], got["num_worlds"],
            got["deterministic"]) == (1, n, EVAL_WORLDS, True)


# the one action every agent takes in the SB3 bench's test: full
# acceleration at full steer, which brings agents to their goals (and out
# of the live mask) within the test's windows
SB3_ACTION = 90


def _fixed_action(monkeypatch, env_cls, full_like):
    """Make ``env_cls.step`` apply SB3_ACTION to every agent, whatever the
    learner sampled, so that two learners' rollouts are the same."""
    real = env_cls.step
    monkeypatch.setattr(env_cls, "step", lambda self, actions: real(
        self, full_like(actions, SB3_ACTION)))


def test_bench_sb3_schema_and_valid_samples(scenes, tmp_path, capsys,
                                            monkeypatch):
    """bench_sb3 prints scripts/bench_sb3.py's two lines, and its counts
    are the JAX stack's: with every agent given the same action on both
    sides, ``num_envs`` and each window's live samples equal those of the
    JAX ``SB3MultiAgentEnv`` and ``IPPO`` on the same scenes, and
    ``valid_samples`` is the timed windows' sum."""
    data = tmp_path / "scenes"
    shutil.copytree(scenes, data)
    _fixed_action(monkeypatch, SB3MultiAgentEnv, torch.full_like)
    _fixed_action(monkeypatch, JaxSB3Env, np.full_like)
    buffered = []
    real_train = IPPO.train

    def spy(self):
        # the window's live samples, from the buffer's NaN-masked rewards
        buffered.append(int((~torch.isnan(self.buffer.rewards)).sum()))
        return real_train(self)

    monkeypatch.setattr(IPPO, "train", spy)
    got = bench_sb3.main(["--worlds", "2", "--scenes-dir", str(data),
                          "--n-steps", "16", "--n-epochs", "1",
                          "--batch-size", "64", "--windows", "2",
                          "--device", "cpu"])
    meta, line = _json_lines(capsys)
    assert set(meta) == {"mode", "worlds", "num_envs", "n_steps", "windows",
                         "valid_samples", "elapsed_s", "backend", "v_loss"}
    assert (meta["mode"], meta["backend"]) == ("sb3_ippo_train", "cpu")
    assert set(line) == {"metric", "value", "unit", "vs_baseline"}
    assert (line["metric"], line["unit"]) == ("sb3_train_sps",
                                              "valid-agent-steps/s")
    assert got == dict(line, meta=meta)

    # scripts/bench_sb3.py's stack on the same scenes: the warm-up window
    # and 2 timed ones (its training moves no count: the actions are fixed)
    jenv = JaxSB3Env(JaxEnvConfig(num_worlds=2),
                     JaxLoader(root=str(data), batch_size=2, dataset_size=4))
    jippo = JaxIPPO(jenv, JaxIPPOConfig(n_steps=16, batch_size=64,
                                        n_epochs=1))
    want = []
    for _ in range(3):
        before = jippo.num_timesteps
        jippo.collect_rollouts()
        want.append(jippo.num_timesteps - before)
    assert meta["num_envs"] == jenv.num_envs
    assert buffered == want, (buffered, want)
    assert meta["valid_samples"] == sum(want[1:])
    # agents reached their goals within the timed windows
    assert sum(want[1:]) < 2 * 16 * jenv.num_envs


@pytest.mark.parametrize("version,seeds", [(3, range(8)), (2, range(4))])
def test_pool_scenes_equal_the_jax_script(version, seeds):
    port = pool.make_scene_v3 if version == 3 else pool.make_scene
    jax_side = MSP.make_scene_v3 if version == 3 else MSP.make_scene
    for s in seeds:
        assert json.dumps(port(s)) == json.dumps(jax_side(s)), s


def test_pool_main_writes_pool_v3_and_validates_as_jax(tmp_path, capsys):
    paths = pool.main(["--out", str(tmp_path), "--num", "8", "--validate",
                       "8", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    for p in paths:
        with open(p) as f, open(os.path.join(ROOT, "data", "pool_v3",
                                             os.path.basename(p))) as g:
            assert f.read() == g.read(), p
    assert os.path.basename(paths[0]) == "tfrecord-synth3_1000.json"
    assert MSP.validate_pool(paths)
    want = capsys.readouterr().out.splitlines()
    assert out[-1] == want[-1], (out, want)
    assert out[-1].startswith("validate: 8 scenes") and "collided 0" in out[-1]
    assert pool.validate_pool(paths[:4], ignore_non_vehicles=True,
                              device="cpu") == MSP.validate_pool(
        paths[:4], ignore_non_vehicles=True)
    port_line, jax_line = capsys.readouterr().out.splitlines()
    assert port_line == jax_line


def test_entry_matches_jax():
    jfn, (jvars, jobs) = GRAFT.entry()
    fn, (variables, obs) = entry.entry("cpu")
    assert tuple(obs.shape) == tuple(jobs.shape) and not bool(obs.any())
    assert set(variables) == set(params_from_flax(jvars))
    variables = params_from_flax(jvars)
    rng = np.random.default_rng(0)
    for x in (np.zeros(obs.shape, np.float32),
              rng.standard_normal(obs.shape).astype(np.float32)):
        with torch.no_grad():
            logits, value = fn(variables, torch.from_numpy(x))
        jlogits, jvalue = jfn(jvars, x)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(value.numpy(), np.asarray(jvalue),
                                   rtol=0, atol=1e-5)


def train_env_config():
    """The trainer CLI's env configuration (ppo/train.py main)."""
    from gpudrive_lab_torch.env.config import EnvConfig

    return EnvConfig(reward_type="weighted_combination",
                     collision_weight=-0.75, off_road_weight=-0.75,
                     goal_achieved_weight=1.0, dynamics_model="classic",
                     collision_behavior="ignore", agent_bucket="auto")


def test_campaign_report_reads_the_port_trainers_jsonl(tmp_path, capsys,
                                                       monkeypatch):
    """2 iterations of the port's trainer on 2 copies of one scene, one
    metrics line each; the shared report summarizes them."""
    data = tmp_path / "scenes"
    data.mkdir()
    shutil.copy(POOL_SCENES[0], data)
    env = GPUDriveTorchEnv(train_env_config(), [POOL_SCENES[0]] * 2,
                           device="cpu")
    per_iter = 8 * int(env.cont_agent_mask.sum())
    run = tmp_path / "run"
    train.main(["--device", "cpu", "--data-dir", str(data), "--num-worlds",
                "2", "--rollout-len", "8", "--num-minibatches", "2",
                "--update-epochs", "1", "--agent-bucket", "auto",
                "--log-interval", "1", "--total-timesteps",
                str(per_iter + 1), "--checkpoint-path", str(run)])
    capsys.readouterr()
    rows = REPORT.load_rows(str(run))
    assert [r["iteration"] for r in rows] == [1, 2]
    assert rows[-1]["global_step"] == 2 * per_iter
    monkeypatch.setattr("sys.argv", ["campaign_report.py", str(run),
                                     "--points", "2"])
    REPORT.main()
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("| agent-steps |") and len(out) == 5
    summary = json.loads(out[-1])
    assert summary["final_step"] == 2 * per_iter
    assert summary["mean_sps"] > 0
    assert 0.0 <= summary["final_goal_rate"] <= 1.0
    assert np.isfinite(summary["final_entropy"])

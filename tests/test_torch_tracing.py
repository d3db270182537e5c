"""The port's spans (``gpudrive_lab_torch/utils/profiling.py``).

Off, a span makes no record and never enters ``record_function``.  Under a
torch.profiler session the spans of the bench step sit in the exported
chrome trace nested as in the code, and ``recorded()`` gives the same
nesting, parents and sequence numbers; inside ``recording()`` they record
with no profiler session.  A PPO iteration records its phases, steps and
minibatches.  Recording changes no output of ``bench_step`` or of
``PPO.train_step``.  A ``recording(names)`` block records only the spans
it names, drops them at its end, and leaves the records of a recorder
that was on before it in place.  The PPO trainer's and ``rollout()``'s
timers read these spans.
"""

import contextlib
import dataclasses
import json
import os

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from gpudrive_lab_torch import bench
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.env.env_torch import ObsSpec
from gpudrive_lab_torch.ppo.ppo import PPOConfig
from gpudrive_lab_torch.ppo.train import build_trainer
from gpudrive_lab_torch.rollout import pool_scene_paths, slice_env
from gpudrive_lab_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3

# one bench step's spans, as the code nests them
BENCH_TREE = ("bench.step", (
    ("sim.step", (("sim.movement", ()),
                  ("sim.collision", (("sim.agent_road", ()),)),
                  ("sim.reward_done", ()))),
    ("obs", (("obs.ego", ()), ("obs.partner", ()), ("obs.road", ()),
             ("obs.assemble", ()))),
    ("sim.reset", ()),
))
SIM_TREE, OBS_TREE = BENCH_TREE[1][:2]
POLICY_TREE = ("policy.forward", (("policy.embed_pool", ()),) * 2)


@pytest.fixture(scope="module")
def env():
    """Two pool worlds, the agent axis bucketed to 16."""
    return slice_env(pool_scene_paths(ROOT)[20:22], device="cpu",
                     agent_bucket="auto")


@pytest.fixture(autouse=True)
def no_records():
    profiling.clear()
    yield
    profiling.clear()


def run_bench(env, steps: int = STEPS, around=contextlib.nullcontext):
    """``steps`` bench steps from the reset state with seeded action
    indices, inside ``around()``; the states and accumulators they
    return."""
    table = bench.action_table(env.config, "cpu")
    fresh = stepmod.reset(env.scene, None, env.params)
    W, A = env.scene.agents.valid.shape
    weights = torch.zeros((W, A, 3))
    gen = torch.Generator().manual_seed(5)
    state, acc, out = fresh, torch.zeros(()), []
    with around():
        for _ in range(steps):
            idx = torch.randint(0, table.shape[0], (W, A), generator=gen)
            state, acc = bench.bench_step(env.scene, fresh, table, weights,
                                          state, idx, acc, env.params,
                                          ObsSpec())
            out.append((state, acc))
    return out


def tree_of(records, i):
    return (records[i].name, tuple(
        tree_of(records, j) for j, r in enumerate(records) if r.parent == i))


def top_trees(records):
    return [tree_of(records, i) for i, r in enumerate(records)
            if r.parent is None]


def trace_trees(path, names):
    """Top-level trees of the chrome trace's ``names`` events, nested by
    their time intervals on each thread."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e for e in events if e.get("ph") == "X"
                    and e.get("name") in names),
                   key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    roots, stack = [], []
    for e in spans:
        node = (e["name"], [])
        while stack and (stack[-1][0]["tid"] != e["tid"] or e["ts"] >= (
                stack[-1][0]["ts"] + stack[-1][0]["dur"])):
            stack.pop()
        (stack[-1][1][1] if stack else roots).append(node)
        stack.append((e, node))

    def freeze(node):
        return (node[0], tuple(freeze(c) for c in node[1]))

    return [freeze(n) for n in roots]


def names_of(tree):
    return {tree[0]} | {n for c in tree[1] for n in names_of(c)}


@pytest.fixture
def record_function_calls(monkeypatch):
    """How many times record_function has been entered."""
    calls = []
    real = autograd_profiler.record_function

    def counting(*args, **kwargs):
        calls.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(autograd_profiler, "record_function", counting)
    return calls


def test_off_a_span_records_nothing(env, record_function_calls):
    run_bench(env, 1)
    assert profiling.recorded() == [] and profiling.dropped() == 0
    assert record_function_calls == []


def test_recording_records_without_a_profiler(env, record_function_calls):
    run_bench(env, around=profiling.recording)
    recs = profiling.recorded()
    assert top_trees(recs) == [BENCH_TREE] * STEPS
    assert record_function_calls == []  # no profiler session to mark
    assert all(not r.on_stream and r.ms >= 0 and r.end_ns >= r.start_ns
               for r in recs)
    # a parent holds its children
    for r in recs:
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    run_bench(env, 1)  # the block has closed
    assert len(profiling.recorded()) == len(recs)


def test_profiler_trace_and_records_nest_alike(env, tmp_path,
                                               record_function_calls):
    prof = profile(activities=[ProfilerActivity.CPU])
    run_bench(env, around=lambda: prof)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    recs = profiling.recorded()
    assert top_trees(recs) == [BENCH_TREE] * STEPS
    assert trace_trees(path, names_of(BENCH_TREE)) == [BENCH_TREE] * STEPS
    assert len(record_function_calls) == len(recs)
    # each step's spans share its top-level span's sequence number
    tops = [i for i, r in enumerate(recs) if r.parent is None]
    seqs = [recs[i].seq for i in tops]
    assert seqs == list(range(seqs[0], seqs[0] + STEPS))
    for r in recs:
        top = r
        while top.parent is not None:
            top = recs[top.parent]
        assert r.seq == top.seq


def test_recording_leaves_the_bench_step_bit_identical(env):
    off = run_bench(env)
    on = run_bench(env, around=profiling.recording)
    for (s0, a0), (s1, a1) in zip(off, on):
        assert torch.equal(a0, a1)
        for f in dataclasses.fields(s0):
            assert torch.equal(getattr(s0, f.name), getattr(s1, f.name))


def ppo_iteration(env, around=contextlib.nullcontext):
    """One PPO iteration (T 4, 2 minibatches of 2 steps, flat rows with the
    observations recomputed) from a fixed seed, inside ``around()``:
    (carry, metrics, weights)."""
    cfg = PPOConfig(rollout_len=4, update_epochs=1, num_minibatches=2,
                    compact=16, compact_mode="flat")
    ppo, carry, fresh, train_fn = build_trainer(env, cfg, seed=3)
    with around():
        carry, metrics = train_fn(env.scene, carry, fresh,
                                  env.reward_weights)
    return carry, metrics, ppo.policy.state_dict()


def test_a_ppo_iteration_records_its_phases_bit_identical(env):
    off = ppo_iteration(env)
    on = ppo_iteration(env, around=profiling.recording)
    recs = profiling.recorded()
    trees = top_trees(recs)
    assert [t[0] for t in trees] == ["ppo.rollout", "ppo.prepare",
                                     "ppo.learn"]
    assert len({recs[i].seq for i, r in enumerate(recs)
                if r.parent is None}) == 3
    step = ("ppo.rollout_step", (OBS_TREE, POLICY_TREE, ("ppo.action", ()),
                                 SIM_TREE, ("ppo.reward", ()),
                                 ("sim.reset", ())))
    assert trees[0] == ("ppo.rollout", (step,) * 4)
    assert trees[1] == ("ppo.prepare", (OBS_TREE, POLICY_TREE))
    minibatch = ("ppo.minibatch", (("ppo.gather", ()),)
                 + (OBS_TREE,) * 2
                 + (("ppo.loss", (POLICY_TREE,)), ("ppo.backward", ()),
                    ("ppo.optimizer", ())))
    assert trees[2] == ("ppo.learn", (minibatch,) * 2)
    (c0, m0, w0), (c1, m1, w1) = off, on
    for f in dataclasses.fields(c0.state):
        assert torch.equal(getattr(c0.state, f.name),
                           getattr(c1.state, f.name))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(w0[k], w1[k]) for k in w0)


def test_the_record_cap_counts_what_it_drops(env, monkeypatch):
    monkeypatch.setattr(profiling, "MAX_RECORDS", 5)
    run_bench(env, 1, around=profiling.recording)
    n = len(names_of(BENCH_TREE))
    assert len(profiling.recorded()) == 5
    assert profiling.dropped() == n - 5
    profiling.clear()
    assert profiling.dropped() == 0


def test_rollout_times_its_phases_with_spans(env):
    from gpudrive_lab_torch.rollout import rollout, slice_policy

    env.reset()
    policy = slice_policy(device="cpu")
    policy.config = dataclasses.replace(policy.config, fused_embed=False)
    res = rollout(env, policy, 2, torch.Generator().manual_seed(0))
    assert res.sim_ms > 0 and res.policy_ms > 0 and res.sensor_ms is None
    assert profiling.recorded() == []  # its records are dropped once read


def test_a_named_block_records_only_its_spans(env, record_function_calls):
    with profiling.recording(("sim.step", "obs.road")) as first:
        run_bench(env)
        recs = profiling.recorded(first)
        assert [(r.name, r.parent) for r in recs] == [
            ("sim.step", None), ("obs.road", None)] * STEPS
        assert len(profiling.span_ms("obs.road", start=first)) == STEPS
    assert record_function_calls == []
    assert profiling.recorded() == []  # dropped at the block's end


@pytest.mark.parametrize("outer", ["recording", "profiler"])
def test_a_named_block_leaves_an_outer_recorders_records(env, outer):
    from gpudrive_lab_torch.rollout import rollout, slice_policy

    policy = slice_policy(device="cpu")
    policy.config = dataclasses.replace(policy.config, fused_embed=False)
    env.reset()
    around = (profiling.recording() if outer == "recording"
              else profile(activities=[ProfilerActivity.CPU]))
    with around:
        res = rollout(env, policy, 2, torch.Generator().manual_seed(0))
    assert res.sim_ms > 0 and res.policy_ms > 0
    # every layer inside rollout()'s phases recorded for the outer recorder
    trees = top_trees(profiling.recorded())
    assert [t[0] for t in trees] == ["rollout.obs", "rollout.policy",
                                     "rollout.step", "rollout.reset"] * 2
    assert trees[0] == ("rollout.obs", (OBS_TREE,))
    assert trees[1][1][0] == POLICY_TREE
    assert trees[2][1][0] == SIM_TREE


def test_span_ms_reads_a_span_inside_another(env):
    with profiling.recording():
        ppo_iteration(env)
    recs = profiling.recorded()

    def inside(r, name):
        while r.parent is not None:
            r = recs[r.parent]
            if r.name == name:
                return True
        return False

    learn = [r.ms for r in recs if r.name == "obs" and inside(r, "ppo.learn")]
    assert profiling.span_ms("obs", "ppo.learn") == learn and learn
    assert len(profiling.span_ms("obs")) > len(learn)
    assert profiling.span_ms("ppo.learn") == [
        r.ms for r in recs if r.name == "ppo.learn"]
    assert profiling.span_ms("obs", "ppo.optimizer") == []


def test_chip_smokes_phase_timer_reads_the_ppo_spans(env):
    from chip_smoke import PhaseTimer

    with PhaseTimer() as timer:
        ppo_iteration(env)
    (it,) = timer.iterations()
    assert set(it) == {"rollout", "gae", "update"}
    assert all(v > 0 for v in it.values())
    assert profiling.recorded() == []


# one OfficialVBDSource sample's spans, as the code nests them
VBD_STEPS = 3
VBD_TREE = ("vbd.sample", (
    ("vbd.prepare", (("vbd.batch", ()), ("vbd.inputs", ()))),
    ("vbd.encode", ()),
    *(("vbd.denoise", ()),) * VBD_STEPS,
    ("vbd.rollout", ()),
    ("vbd.scatter", ()),
))


@pytest.fixture(scope="module")
def vbd_source():
    """The official VBD at full width with 8 agents, 3 diffusion steps and
    one encoder layer, seeded."""
    from gpudrive_lab_torch.vbd import integration, model_official

    cfg = model_official.OfficialVBDConfig(
        agents_len=8, diffusion_steps=VBD_STEPS, encoder_layers=1)
    model = model_official.OfficialVBD(
        cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    return integration.OfficialVBDSource(model.eval(), seed=2)


def test_a_vbd_sample_records_its_stages(env, vbd_source):
    with profiling.recording():
        trajs = vbd_source(env.scene, env.state)
    assert top_trees(profiling.recorded()) == [VBD_TREE]
    assert trajs.shape[:2] == env.scene.agents.valid.shape
    assert len(profiling.span_ms("vbd.denoise", "vbd.sample")) == VBD_STEPS


def test_the_sampler_counts_samples_and_diffusion_steps(env, vbd_source):
    from gpudrive_lab_torch.vbd.model_official import sample_official

    before = sample_official.samples, sample_official.denoise_steps
    vbd_source(env.scene, env.state)
    assert (sample_official.samples - before[0],
            sample_official.denoise_steps - before[1]) == (1, VBD_STEPS)
    assert profiling.recorded() == []  # off, the spans record nothing


@pytest.mark.parametrize("use_vbd", [True, False])
def test_the_vbd_obs_and_reward_spans_run_only_with_use_vbd(use_vbd):
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.rollout import SLICE_CONFIG

    vbd = dict(use_vbd=True, vbd_in_obs=True,
               reward_type="distance_to_vdb_trajs") if use_vbd else {}
    env = GPUDriveTorchEnv(EnvConfig(**dict(
        SLICE_CONFIG, agent_bucket="auto", **vbd)),
        pool_scene_paths(ROOT)[20:22], device="cpu")
    with profiling.recording():
        env.step_dynamics(None)
        env.get_obs()
        env.get_rewards()
    names = [r.name for r in profiling.recorded()]
    want = 1 if use_vbd else 0
    assert names.count("obs.vbd") == names.count("reward.vbd") == want
    assert names.count("obs") == 1

"""World-parallel training across processes (gpudrive_lab_torch/parallel/,
the group options of ppo/ppo.py and ppo/ppo_rnn.py), on the CPU with gloo:

  * ``shard_scene_paths`` against the JAX function for the layouts of
    tests/test_distributed.py (its ``jax.local_devices`` monkeypatched over
    the 8 virtual devices of tests/conftest.py), wrapping included;
  * ``shard_worlds`` and ``gather_worlds`` round-trip a Scene, and a 2-rank
    world-sharded step (5 steps on synthetic_scene(4, 3, 8, seed=7)) gives
    the position total of one process and of the JAX package;
  * ``dryrun_multiprocess(2, "cpu")`` at a small size: every learner
    configuration of the JAX dryrun at its bars, the ranks' parameters
    bitwise equal;
  * a recurrent minibatch with no row on one rank.

Ranks start in subprocesses under ``init_method="file://<tmp_path>/..."``,
so test workers never race for a port; each is waited for with a timeout
and killed on expiry.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.parallel import distributed as jdist
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.core.types import (
    CollisionBehaviour,
    DynamicsModel,
    Params,
    RewardType,
)
from gpudrive_lab_torch.parallel import distributed as tdist
from gpudrive_lab_torch.parallel.mesh import WorldGroup, shard_worlds
from gpudrive_lab_torch.scene.synthetic import synthetic_scene
from torch_parity import ROOT

TIMEOUT = 240  # seconds for a whole multi-process test

# the JAX ground truth's parameters (tests/test_distributed.py:101-106)
STEP_PARAMS = Params(
    dynamics_model=DynamicsModel.CLASSIC,
    collision_behaviour=CollisionBehaviour.IGNORE,
    reward_type=RewardType.DISTANCE_BASED,
    max_num_controlled_agents=0,
)


def _position_total(pos: np.ndarray) -> float:
    return float(np.where(np.isfinite(pos), pos, 0.0).sum())


def _single_total() -> float:
    scene = synthetic_scene(num_worlds=4, num_agents=3, num_roads=8, seed=7,
                            device="cpu")
    state = stepmod.reset(scene, None, STEP_PARAMS)
    acts = torch.zeros((4, scene.max_agents, 10))
    for _ in range(5):
        state = stepmod.step(scene, state, acts, STEP_PARAMS)
    return _position_total(state.pos.numpy())


@pytest.mark.parametrize("hosts,devices_per_host,wpd,n_paths", [
    (2, 4, 4, 64),   # test_shard_scene_paths_contiguous_blocks
    (1, 1, 5, 3),    # test_shard_scene_paths_wraps_short_lists
    (8, 1, 3, 20),   # one device per host, wrapping at the end
    (4, 2, 2, 16),
])
def test_shard_scene_paths_matches_jax(monkeypatch, hosts, devices_per_host,
                                       wpd, n_paths):
    """Rank r of the port holds global device r: a JAX host's paths are
    the concatenation of its devices' rank blocks."""
    devices = jax.devices()[: hosts * devices_per_host]
    paths = [f"scene_{i:03d}.json" for i in range(n_paths)]
    monkeypatch.setattr(jax, "devices", lambda: devices)
    for h in range(hosts):
        local = devices[h * devices_per_host:(h + 1) * devices_per_host]
        monkeypatch.setattr(jax, "local_devices", lambda loc=local: loc)
        want = jdist.shard_scene_paths(paths, worlds_per_device=wpd)
        got = []
        for d in range(h * devices_per_host, (h + 1) * devices_per_host):
            got += tdist.shard_scene_paths(paths, wpd, d, len(devices))
        assert got == want
    with pytest.raises(ValueError, match="rank"):
        tdist.shard_scene_paths(paths, wpd, len(devices), len(devices))


def test_one_process_needs_no_group(monkeypatch):
    """Without WORLD_SIZE or GPUDRIVE_TORCH_NUM_PROCESSES, initialize
    starts nothing and returns a group of one, which shards and gathers
    the identity."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv(tdist.NUM_PROCESSES_ENV, raising=False)
    g = tdist.initialize(device="cpu")
    assert (g.rank, g.size) == (0, 1)
    assert not torch.distributed.is_initialized()
    scene = synthetic_scene(num_worlds=4, seed=7, device="cpu")
    for got in (shard_worlds(scene, g), tdist.gather_worlds(scene, g)):
        for f in dataclasses.fields(scene.agents):
            assert torch.equal(getattr(got.agents, f.name),
                               getattr(scene.agents, f.name))
    monkeypatch.setenv(tdist.NUM_PROCESSES_ENV, "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(ValueError, match="rank"):
        tdist.initialize(device="cpu")
    with pytest.raises(ValueError, match="equal blocks"):
        WorldGroup(0, 3).block(4)


def _fake_cards(monkeypatch, n_cards: int) -> dict:
    """CUDA with ``n_cards`` cards and a process group that records its
    start, for the device choices of initialize and rank_devices."""
    import torch.distributed as tdd

    seen = {"init": None, "set_device": []}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen["set_device"].append(torch.device(d)))

    def init_process_group(backend, init_method, world_size, rank):
        seen["init"] = (backend, init_method, world_size, rank,
                        list(seen["set_device"]))

    monkeypatch.setattr(tdd, "init_process_group", init_process_group)
    monkeypatch.setattr(tdd, "is_initialized",
                        lambda: seen["init"] is not None)
    monkeypatch.setattr(tdd, "get_rank", lambda group=None: seen["init"][3])
    monkeypatch.setattr(tdd, "get_world_size",
                        lambda group=None: seen["init"][2])
    return seen


def test_initialize_puts_each_torchrun_rank_on_its_own_card(monkeypatch):
    """Under torchrun (WORLD_SIZE, RANK, LOCAL_RANK; two hosts of two
    cards) with no device named, rank 3 runs on cuda:1, made the current
    card before NCCL starts; a local rank beyond the host's cards raises
    instead of landing on a card another rank holds."""
    seen = _fake_cards(monkeypatch, 2)
    for k, v in {"WORLD_SIZE": "4", "RANK": "3", "LOCAL_RANK": "1"}.items():
        monkeypatch.setenv(k, v)
    g = tdist.initialize()
    assert (g.rank, g.size, g.device) == (3, 4, torch.device("cuda", 1))
    assert seen["init"] == ("nccl", "env://", 4, 3,
                            [torch.device("cuda", 1)])
    seen["init"] = None
    monkeypatch.setenv("LOCAL_RANK", "2")
    with pytest.raises(ValueError, match="no card of its own"):
        tdist.initialize()
    # a card named by the caller is kept, and made current
    g = tdist.initialize("gloo", device="cuda:0")
    assert g.device == torch.device("cuda", 0)
    assert seen["init"][0] == "gloo" and seen["set_device"][-1] == g.device


@pytest.mark.parametrize("n_cards,device,want,shared", [
    (4, "cuda", ["cuda:0", "cuda:1"], False),   # a card per rank
    (1, "cuda", ["cuda:0", "cuda:0"], True),    # more ranks than cards
    (4, "cuda:0", ["cuda:0", "cuda:0"], True),  # a card named by index
    (0, "cpu", ["cpu", "cpu"], True),
])
def test_rank_devices_and_backend(monkeypatch, n_cards, device, want,
                                  shared):
    """Ranks get a card each where the host has one per rank, and share
    the named device otherwise; NCCL is refused for ranks that share a
    card, gloo taken."""
    if n_cards:
        _fake_cards(monkeypatch, n_cards)
    devs = tdist.rank_devices(device, 2)
    assert devs == [torch.device(d) for d in want]
    if devs[0].type == "cpu":
        assert tdist.rank_backend(None, devs) == "gloo"
    elif shared:
        with pytest.raises(ValueError, match="gloo"):
            tdist.rank_backend(None, devs)
        assert tdist.rank_backend("gloo", devs) == "gloo"
    else:
        assert tdist.rank_backend(None, devs) == "nccl"


def test_run_ranks_reports_a_failed_rank(tmp_path):
    """run_ranks returns each rank's value in rank order (operator.is_(rank,
    spec) is False), and a rank that raises makes it raise with the rank's
    traceback (operator.add(rank, spec) raises TypeError)."""
    import operator

    assert tdist.run_ranks(operator.is_, 2, {}, timeout=60) == [False,
                                                                 False]
    with pytest.raises(RuntimeError, match="(?s)rank 0 failed.*TypeError"):
        tdist.run_ranks(operator.add, 2, {}, timeout=60)


_RANK = r"""
import dataclasses, json, sys
import numpy as np, torch
torch.set_num_threads(1)
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.core.types import (
    CollisionBehaviour, DynamicsModel, Params, RewardType)
from gpudrive_lab_torch.parallel import distributed as dist
from gpudrive_lab_torch.parallel.mesh import shard_worlds, tree_map
from gpudrive_lab_torch.scene.synthetic import synthetic_scene

rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
g = dist.initialize("gloo", init, 2, rank, "cpu")
params = Params(dynamics_model=DynamicsModel.CLASSIC,
                collision_behaviour=CollisionBehaviour.IGNORE,
                reward_type=RewardType.DISTANCE_BASED,
                max_num_controlled_agents=0)
full = synthetic_scene(num_worlds=4, num_agents=3, num_roads=8, seed=7,
                       device="cpu")
scene = shard_worlds(full, g)
back = dist.gather_worlds(scene, g)
same = []
tree_map(lambda x: same.append(x), full)
got = []
tree_map(lambda x: got.append(x), back)
state = stepmod.reset(scene, None, params)
acts = torch.zeros((scene.num_worlds, scene.max_agents, 10))
for _ in range(5):
    state = stepmod.step(scene, state, acts, params)
pos = torch.where(torch.isfinite(state.pos), state.pos, 0.0)
total = g.all_reduce(pos.sum().double()[None])
gathered = dist.gather_worlds(state, g)
json.dump({"worlds": scene.num_worlds, "block": [g.block(4).start,
           g.block(4).stop],
           "round_trip": all(torch.equal(a, b) for a, b in zip(same, got)),
           "total": float(total), "gathered_pos": gathered.pos.tolist()},
          open(out, "w"))
dist.shutdown()
"""


def test_two_rank_sharded_step_matches_one_process_and_jax(tmp_path):
    init = "file://" + str(tmp_path / "pg_init")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), init,
         str(tmp_path / f"out{r}.json")], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o
    res = [json.load(open(tmp_path / f"out{r}.json")) for r in range(2)]
    assert [r["block"] for r in res] == [[0, 2], [2, 4]]
    assert all(r["worlds"] == 2 and r["round_trip"] for r in res)
    assert res[0]["total"] == res[1]["total"]
    single = _single_total()
    assert abs(res[0]["total"] - single) <= 1e-3 + 1e-6 * abs(single)
    # every rank gathers the same [4, ...] state: one process's, bit for bit
    assert res[0]["gathered_pos"] == res[1]["gathered_pos"]
    assert _position_total(np.asarray(res[0]["gathered_pos"],
                                      np.float32)) == single
    # and the JAX package's total (tests/test_distributed.py:90-119)
    from gpudrive_lab_tpu.core import step as jstep
    from gpudrive_lab_tpu.core.types import Params as JParams
    from gpudrive_lab_tpu.scene.synthetic import synthetic_scene as jsynth

    jp = JParams(**{f.name: getattr(STEP_PARAMS, f.name)
                    for f in dataclasses.fields(STEP_PARAMS)})
    jscene = jsynth(num_worlds=4, num_agents=3, num_roads=8, seed=7)
    js = jax.jit(jstep.reset, static_argnames="params")(jscene, None, jp)
    step_fn = jax.jit(jstep.step, static_argnames="params")
    for _ in range(5):
        js = step_fn(jscene, js, np.zeros((4, jscene.agents.valid.shape[1],
                                           10), np.float32), jp)
    jtotal = _position_total(np.asarray(js.pos))
    assert abs(res[0]["total"] - jtotal) <= 1e-3 + 1e-6 * abs(jtotal)


def test_dryrun_two_ranks_at_the_bars(monkeypatch):
    """The three configurations of the JAX dryrun, 2 gloo ranks of 2 pool
    worlds each, a narrow policy, rollout_len 4: metrics and parameters
    within 1e-5 (5e-3 for flat + bf16), ranks' parameters bitwise equal
    (dryrun_multiprocess raises otherwise)."""
    from gpudrive_lab_torch.parallel.dryrun import CONFIGS, dryrun_multiprocess

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    report = dryrun_multiprocess(2, "cpu", worlds_per_rank=2,
                                 widths=dict(hidden_dim=32), lstm_hidden=16,
                                 timeout=TIMEOUT)
    assert report["backend"] == "gloo"
    for name in CONFIGS:
        r = report[name]
        assert r["max_param_delta"] <= (5e-3 if "bf16" in name else 1e-5)
        assert np.isfinite(list(r["metrics"].values())).all()
        assert r["metrics"]["samples"] > 0
    # block-local flat rows split evenly; the recurrent learner's rows are
    # each rank's own controlled count
    assert len(set(report["flat+bf16+dot+swap"]["rank_rows"])) == 1
    assert sum(report["rnn-flat"]["rank_rows"]) > 0


_RNN_RANK = r"""
import sys, torch
torch.set_num_threads(1)
from gpudrive_lab_torch.parallel import distributed as dist
from gpudrive_lab_torch.parallel.dryrun import _Learner, _flat_compact, _plan

rank, init, out, root, acts, order = sys.argv[1:7]
rank = int(rank)
g = None if rank < 0 else dist.initialize("gloo", init, 2, rank, "cpu")
plan = _plan(root, 2, 2)
spec = dict(procs=2, worlds_per_rank=2, plan=plan,
            widths=dict(hidden_dim=32), lstm_hidden=16,
            **_flat_compact(plan, 2))
learner = _Learner("rnn-flat", spec, torch.device("cpu"), g)
t = learner.trainer
rows = t.global_rows(learner.scene)
acts = torch.load(acts).index_select(1, rows) if acts else None
init_lstm = learner.carry.lstm
carry, traj = t.rollout(learner.scene, learner.carry, learner.fresh,
                        learner.weights, actions=acts)
batch = t.prepare(learner.scene, carry, traj, learner.weights)
losses = t.learn(batch, init_lstm, perms=[torch.load(order)],
                 rows=None if g is None else rows)
torch.save({"losses": {k: v.tolist() for k, v in losses.items()},
            "params": t.policy.state_dict(), "actions": traj.action,
            "rows": rows.tolist()}, out)
if g is not None:
    dist.shutdown()
"""


def test_rnn_minibatch_without_rows_on_a_rank(tmp_path):
    """A recurrent minibatch that holds one rank's rows only: the other
    rank joins its sums with none, and both ranks apply one process's
    update."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    order = str(tmp_path / "order.pt")

    def run(ranks, acts=""):
        procs = [subprocess.Popen(
            [sys.executable, "-c", _RNN_RANK, str(r),
             "file://" + str(tmp_path / "pg_init"),
             str(tmp_path / f"rnn{r}.pt"), ROOT, acts, order], env=env,
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in ranks]
        try:
            outs = [p.communicate(timeout=TIMEOUT)[0].decode() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, o in zip(procs, outs):
            assert p.returncode == 0, o
        return [torch.load(tmp_path / f"rnn{r}.pt") for r in ranks]

    from gpudrive_lab_torch.parallel.dryrun import _flat_compact, _plan

    B = _flat_compact(_plan(ROOT, 2, 2), 2)["rnn_compact"]
    k = B // 2
    halves = [list(range(k)), list(range(k, 2 * k))]
    torch.save(halves, order)
    (single,) = run([-1])
    torch.save(single["actions"], tmp_path / "acts.pt")
    ranks = run([0, 1], str(tmp_path / "acts.pt"))
    rows = [set(r["rows"]) for r in ranks]
    assert rows[0] | rows[1] == set(range(B)) and not rows[0] & rows[1]
    # one of the two minibatches lies on one rank only
    assert any(set(h) <= rows[0] or set(h) <= rows[1] for h in halves)
    for r in ranks:
        for name, v in single["params"].items():
            assert (r["params"][name] - v).abs().max() <= 1e-5, name
        for name, v in single["losses"].items():
            np.testing.assert_allclose(r["losses"][name], v, rtol=1e-5,
                                       atol=1e-6)
    for name, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][name])

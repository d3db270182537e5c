"""Kernel K5's wrapper (``env/flat_obs_kernel.py``) on the CPU.

The CPU takes K5's plain version: one ``flat_observation`` per time step,
written into one output.  These tests hold it to the stacked per-step
observations for every ego selection and for the specs K5 leaves to it,
pin the specs K5 covers and the update's choice between the two, and check
that PPO's update gives the same bits through the wrapper as through the
per-step loop it replaced.  The kernel itself runs in
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import dataclasses
import os

import pytest
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.types import Params, RoadObsAlgorithm, SimState
from gpudrive_lab_torch.env import flat_obs_kernel as k5
from gpudrive_lab_torch.env.env_torch import ObsSpec, flat_observation
from gpudrive_lab_torch.ppo.ppo import PPOConfig
from gpudrive_lab_torch.ppo.train import build_trainer
from gpudrive_lab_torch.rollout import pool_scene_paths, slice_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_IDX = [2, 0, 3]  # out of order, as a minibatch draws them
LINEAR = Params(road_obs_algorithm=RoadObsAlgorithm.LINEAR,
                observation_radius=50.0)


@pytest.fixture(scope="module")
def env():
    """Three pool worlds, the agent axis bucketed below 128, roads LINEAR
    (each pool world has fewer than 200 road points)."""
    e = slice_env(pool_scene_paths(ROOT)[40:43], device="cpu",
                  agent_bucket="auto", road_obs_algorithm="linear")
    assert e.max_agent_count < C.MAX_AGENTS
    assert int(e.scene.roads.valid.sum(-1).max()) < C.MAX_AGENT_MAP_OBS
    return e


def trainer(env, **cfg):
    base = dict(rollout_len=4, update_epochs=1, num_minibatches=2,
                compact=48, compact_mode="flat")
    return build_trainer(env, PPOConfig(**{**base, **cfg}), seed=3)


@pytest.fixture(scope="module")
def traj(env):
    """A 4-step rollout's stored pre-step states and the flat selection."""
    ppo, carry, fresh, _ = trainer(env)
    _, tr = ppo.rollout(env.scene, carry, fresh, env.reward_weights)
    return tr, ppo.ctrl_slots(env.scene)


def selections(env, flat):
    """Each form of ego selection: the flat pairs, [W, C] slots in a
    shuffled order (padded egos among them), every row, a row block."""
    W, A = env.scene.agents.valid.shape
    g = torch.Generator().manual_seed(0)
    world = torch.stack([torch.randperm(A, generator=g)[:9]
                         for _ in range(W)])
    return {"flat": flat, "world": world, "dense": None,
            "rows": tuple(c[8:32] for c in flat)}


def stacked(env, states, t_idx, ego_idx, params=None, spec=ObsSpec()):
    obs = [flat_observation(env.scene, k5.state_at(states, t),
                            params or env.params, spec, env.reward_weights,
                            ego_idx)[0] for t in t_idx]
    return torch.stack(obs).reshape(-1, obs[0].shape[-1])


@pytest.mark.parametrize("sel", ["flat", "world", "dense", "rows"])
def test_plain_rows_equal_the_stacked_observations(env, traj, sel):
    tr, flat = traj
    ego = selections(env, flat)[sel]
    got = k5.flat_obs_rows(env.scene, tr.env_state, T_IDX, ego, env.params,
                           ObsSpec(), env.reward_weights)
    want = stacked(env, tr.env_state, T_IDX, ego)
    assert got.shape == want.shape and got.shape[1] == k5.OBS_DIM
    assert torch.equal(got, want)


@pytest.mark.parametrize("spec,knearest", [
    (ObsSpec(), True), (ObsSpec(norm_obs=False), False),
    (ObsSpec(reward_conditioned=True), False),
    (ObsSpec(partner_obs=False), False)])
def test_plain_rows_cover_the_specs_k5_leaves(env, traj, spec, knearest):
    tr, flat = traj
    params = env.params
    if knearest:
        params = dataclasses.replace(
            params, road_obs_algorithm=RoadObsAlgorithm.KNEAREST)
    assert not k5.supports(spec, params)
    got = k5.flat_obs_rows_plain(env.scene, tr.env_state, T_IDX, flat,
                                 params, spec, env.reward_weights)
    want = stacked(env, tr.env_state, T_IDX, flat, params, spec)
    assert got.shape == (len(T_IDX) * len(flat[0]), spec.obs_dim)
    assert torch.equal(got, want)


def test_state_at_slices_every_field(traj):
    tr, _ = traj
    got = k5.state_at(tr.env_state, 3)
    for f in dataclasses.fields(SimState):
        assert torch.equal(getattr(got, f.name),
                           getattr(tr.env_state, f.name)[3])


@pytest.mark.parametrize("spec,params,ok", [
    (ObsSpec(), LINEAR, True),
    (ObsSpec(), dataclasses.replace(
        LINEAR, road_obs_algorithm=RoadObsAlgorithm.KNEAREST), False),
    (ObsSpec(reward_conditioned=True), LINEAR, False),
    (ObsSpec(norm_obs=False), LINEAR, False),
    (ObsSpec(partner_obs=False), LINEAR, False),
])
def test_supports_the_classic_linear_spec_only(spec, params, ok):
    assert k5.supports(spec, params) is ok


def test_the_benchmark_spec_is_supported(env):
    assert k5.supports(ObsSpec(), env.params)


def old_recompute(scene, states, t_idx, ego_idx, params, spec, weights):
    """The update's recompute before K5: one flat_observation per time
    step, stacked."""
    obs = [flat_observation(scene, k5.state_at(states, t), params, spec,
                            weights, ego_idx)[0] for t in t_idx]
    return torch.stack(obs).reshape(-1, obs[0].shape[-1])


@pytest.mark.parametrize("cfg", [
    {}, {"minibatch_rows": 24, "num_minibatches": 4},
    {"compact": 16, "compact_mode": "world"}])
def test_learn_gives_the_same_bits_as_the_per_step_loop(env, cfg,
                                                       monkeypatch):
    calls = []
    wrapped = k5.flat_obs_rows

    def counted(*args):
        calls.append(len(args[2]))
        return wrapped(*args)

    out = {}
    for name, fn in (("wrapper", counted), ("loop", old_recompute)):
        monkeypatch.setattr(k5, "flat_obs_rows", fn)
        ppo, carry, fresh, _ = trainer(env, **cfg)
        rw = env.reward_weights
        carry, tr = ppo.rollout(env.scene, carry, fresh, rw)
        batch = ppo.prepare(env.scene, carry, tr, rw)
        out[name] = (ppo.learn(env.scene, batch, tr, rw),
                     [p.detach().clone() for p in ppo.policy.parameters()])
    n_mb = ppo.config.update_epochs * ppo.config.num_minibatches
    assert len(calls) == n_mb
    (la, pa), (lb, pb) = out["wrapper"], out["loop"]
    assert la.keys() == lb.keys()
    assert all(torch.equal(la[k], lb[k]) for k in la)
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))


@pytest.mark.parametrize("roads", ["linear", "k_nearest_roadpoints"])
def test_learn_takes_k5_where_supports_holds(env, roads, monkeypatch):
    if roads != "linear":
        env = slice_env(pool_scene_paths(ROOT)[40:43], device="cpu",
                        agent_bucket="auto", road_obs_algorithm=roads)
    calls = {"k5": 0, "plain": 0}

    def count(name, fn):
        def counted(*args):
            calls[name] += 1
            return fn(*args)
        return counted

    # on the CPU the wrapper is the plain version: count the two entries
    plain = k5.flat_obs_rows_plain
    monkeypatch.setattr(k5, "flat_obs_rows", count("k5", plain))
    monkeypatch.setattr(k5, "flat_obs_rows_plain", count("plain", plain))
    ppo, carry, fresh, train = trainer(env)
    train(env.scene, carry, fresh, env.reward_weights)
    n_mb = ppo.config.update_epochs * ppo.config.num_minibatches
    assert calls == ({"k5": n_mb, "plain": 0} if roads == "linear"
                     else {"k5": 0, "plain": n_mb})


def test_ego_pairs_follow_flat_observations_row_order():
    W, A = 3, 5
    slots = torch.tensor([[1, 0], [4, 2], [0, 3]])
    w, a = k5.ego_pairs(slots, W, A, "cpu")
    assert w.tolist() == [0, 0, 1, 1, 2, 2]
    assert a.tolist() == [1, 0, 4, 2, 0, 3]
    w, a = k5.ego_pairs(None, W, A, "cpu")
    assert (w * A + a).tolist() == list(range(W * A))
    pair = (torch.tensor([2, 0], dtype=torch.int32), torch.tensor([1, 4]))
    w, a = k5.ego_pairs(pair, W, A, "cpu")
    assert w.dtype == a.dtype == torch.int64
    assert w.tolist() == [2, 0] and a.tolist() == [1, 4]

"""Kernel K6's wrappers (``env/flat_obs_kernel.py``) on the CPU.

On the CPU the rows path, ``flat_obs_rows``, takes its plain version: one
``flat_observation`` per time step, written into one output.  These tests
hold it to the stacked per-step observations for every ego selection, both
road selections and the specs K6 leaves, pin the specs K6 covers and the
two places that choose by them (``flat_observation`` for one state,
``flat_obs_rows`` for stacked times: the kernel wherever the predicate
holds on CUDA tensors, the plain version everywhere else, never the kernel
on CPU tensors), check that PPO's update recomputes through
``flat_obs_rows`` alone and gives the same bits as the per-step loop, and
hold ``agent_map_observations`` to the road order K6 writes
(``road_order.py``: nearest first, ties to the lower index), also where
more than 200 roads lie in the radius.  The kernel itself runs in
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import dataclasses
import glob
import os

import pytest
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import observations as obsmod
from gpudrive_lab_torch.core.types import Params, RoadObsAlgorithm, SimState
from gpudrive_lab_torch.env import flat_obs_kernel as k5
from gpudrive_lab_torch.env.env_torch import ObsSpec, flat_observation
from gpudrive_lab_torch.ppo.ppo import PPOConfig
from gpudrive_lab_torch.ppo.train import build_trainer
from gpudrive_lab_torch.rollout import pool_scene_paths, slice_env

import road_order

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_IDX = [2, 0, 3]  # out of order, as a minibatch draws them
LINEAR = Params(road_obs_algorithm=RoadObsAlgorithm.LINEAR,
                observation_radius=50.0)
KNEAREST = dataclasses.replace(LINEAR,
                               road_obs_algorithm=RoadObsAlgorithm.KNEAREST)


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


def fake_cuda(monkeypatch):
    """Every tensor reports is_cuda; K6's launches and the plain rows are
    recorded instead of run (the plain rows still run and are returned)."""
    calls = {"k6": 0, "plain": 0}
    plain = k5.flat_obs_rows_plain

    def k6(*args, **kw):
        calls["k6"] += 1
        return "k6", None, None

    def counted(*args):
        calls["plain"] += 1
        return plain(*args)

    monkeypatch.setattr(k5, "_k6", k6)
    monkeypatch.setattr(k5, "flat_obs_rows_plain", counted)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    return calls


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
    (ObsSpec(road_map_obs=False), True), (ObsSpec(norm_obs=False), False),
    (ObsSpec(reward_conditioned=True), True),
    (ObsSpec(partner_obs=False), False)])
def test_rows_take_the_plain_version_for_the_specs_k6_leaves(
        env, traj, spec, knearest, monkeypatch):
    """Also on CUDA tensors (faked): the rows path takes the plain
    version, whose rows equal the stacked observations."""
    tr, flat = traj
    params = env.params
    if knearest:
        params = dataclasses.replace(
            params, road_obs_algorithm=RoadObsAlgorithm.KNEAREST)
    assert not k5.step_supports(spec, params)
    want = stacked(env, tr.env_state, T_IDX, flat, params, spec)
    calls = fake_cuda(monkeypatch)
    got = k5.flat_obs_rows(env.scene, tr.env_state, T_IDX, flat, params,
                           spec, env.reward_weights)
    assert calls == {"k6": 0, "plain": 1}
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
    (ObsSpec(), KNEAREST, True),
    (ObsSpec(reward_conditioned=True), LINEAR, False),
    (ObsSpec(norm_obs=False), LINEAR, False),
    (ObsSpec(partner_obs=False), LINEAR, False),
])
def test_rows_take_k6_where_step_supports_holds(env, traj, spec, params, ok,
                                               monkeypatch):
    """The rows path's dispatch: on CPU tensors always the plain version;
    on CUDA tensors (faked) K6 wherever ``step_supports`` holds, either
    road selection, else the plain version."""
    tr, flat = traj
    assert k5.step_supports(spec, params) is ok
    args = (env.scene, tr.env_state, T_IDX, flat, params, spec,
            env.reward_weights)
    monkeypatch.setattr(k5, "_lib", lambda: pytest.fail("the CPU reached "
                                                        "the CUDA library"))
    assert torch.is_tensor(k5.flat_obs_rows(*args))
    calls = fake_cuda(monkeypatch)
    got = k5.flat_obs_rows(*args)
    assert calls == ({"k6": 1, "plain": 0} if ok else {"k6": 0, "plain": 1})
    assert (got == "k6") is ok


def test_the_benchmark_spec_takes_k6(env):
    """The train cell's spec and roads (LINEAR), and the sim cells'
    (KNEAREST)."""
    assert k5.step_supports(ObsSpec(), env.params)
    assert env.params.road_obs_algorithm == RoadObsAlgorithm.LINEAR
    assert k5.step_supports(ObsSpec(), KNEAREST)


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
def test_learn_recomputes_through_flat_obs_rows(env, roads, monkeypatch):
    """Either road selection: one ``flat_obs_rows`` call a minibatch, which
    on CPU tensors runs the plain version and never the kernel."""
    if roads != "linear":
        env = slice_env(pool_scene_paths(ROOT)[40:43], device="cpu",
                        agent_bucket="auto", road_obs_algorithm=roads)
    calls = {"rows": 0, "plain": 0}

    def count(name, fn):
        def counted(*args):
            calls[name] += 1
            return fn(*args)
        return counted

    monkeypatch.setattr(k5, "flat_obs_rows", count("rows", k5.flat_obs_rows))
    monkeypatch.setattr(k5, "flat_obs_rows_plain",
                        count("plain", k5.flat_obs_rows_plain))
    monkeypatch.setattr(k5, "_k6", lambda *a: pytest.fail("K6 on the CPU"))
    ppo, carry, fresh, train = trainer(env)
    train(env.scene, carry, fresh, env.reward_weights)
    n_mb = ppo.config.update_epochs * ppo.config.num_minibatches
    assert calls == {"rows": n_mb, "plain": n_mb}


def test_ego_pairs_follow_flat_observations_row_order():
    W, A = 3, 5
    slots = torch.tensor([[1, 0], [4, 2], [0, 3]])
    w, a = road_order.ego_pairs(slots, W, A, "cpu")
    assert w.tolist() == [0, 0, 1, 1, 2, 2]
    assert a.tolist() == [1, 0, 4, 2, 0, 3]
    w, a = road_order.ego_pairs(None, W, A, "cpu")
    assert (w * A + a).tolist() == list(range(W * A))
    pair = (torch.tensor([2, 0], dtype=torch.int32), torch.tensor([1, 4]))
    w, a = road_order.ego_pairs(pair, W, A, "cpu")
    assert w.dtype == a.dtype == torch.int64
    assert w.tolist() == [2, 0] and a.tolist() == [1, 4]


# ---- K6: flat_observation of one state in two launches --------------------

ROADS = ["k_nearest_roadpoints", "linear"]


@pytest.fixture(scope="module", params=ROADS)
def data_env(request):
    """The three scenes of tests/data (1 to 7 roads, 1 to 4 agents in a
    bucket of 16), roads selected either way, after two steps."""
    e = slice_env(sorted(glob.glob(os.path.join(ROOT, "tests", "data",
                                                "*.json"))),
                  device="cpu", agent_bucket="auto",
                  road_obs_algorithm=request.param)
    g = torch.Generator().manual_seed(5)
    for _ in range(2):
        e.step_dynamics(torch.randint(0, e.action_space_n,
                                      e.scene.agents.valid.shape,
                                      generator=g))
    return e


def k6_selections(env):
    """Every ego selection K6 takes: every row, [W, C] slots (padded egos
    among them) and flat pairs across worlds."""
    W, A = env.scene.agents.valid.shape
    g = torch.Generator().manual_seed(1)
    world = torch.stack([torch.randperm(A, generator=g)[:5]
                         for _ in range(W)])
    flat = (torch.tensor([2, 0, 2, 1, 0]), torch.tensor([3, 1, 0, 7, 0]))
    return {"dense": None, "world": world, "flat": flat}


def one_time(state: SimState) -> SimState:
    """One state stacked along a leading [1]."""
    return SimState(**{f.name: getattr(state, f.name)[None]
                       for f in dataclasses.fields(SimState)})


@pytest.mark.parametrize("sel", ["dense", "world", "flat"])
def test_step_plain_equals_flat_observation(data_env, sel):
    """The step's plain version, the rows path at T = 1 on the CPU, gives
    ``flat_observation``'s rows for either road selection."""
    env = data_env
    ego = k6_selections(env)[sel]
    got = k5.flat_obs_rows(env.scene, one_time(env.state), [0], ego,
                           env.params, ObsSpec(), env.reward_weights)
    want = flat_observation(env.scene, env.state, env.params, ObsSpec(),
                            env.reward_weights, ego)[0]
    assert got.shape == (want[..., 0].numel(), k5.OBS_DIM)
    assert torch.equal(got, want.reshape(got.shape))


def test_cpu_tensors_never_reach_k6(data_env, monkeypatch):
    """flat_observation and the rows path take the plain code on the CPU;
    the kernel wrapper refuses CPU tensors."""
    def refuse():
        raise AssertionError("a CPU call reached the CUDA library")

    monkeypatch.setattr(k5, "_lib", refuse)
    before = k5.flat_obs_step.launches
    for ego in k6_selections(data_env).values():
        flat_observation(data_env.scene, data_env.state, data_env.params,
                         ObsSpec(), data_env.reward_weights, ego)
        k5.flat_obs_rows(data_env.scene, one_time(data_env.state), [0], ego,
                         data_env.params, ObsSpec(), data_env.reward_weights)
        with pytest.raises(ValueError, match="CUDA"):
            k5.flat_obs_step(data_env.scene, data_env.state,
                             data_env.params, ObsSpec(), ego)
    assert k5.flat_obs_step.launches == before == 0


@pytest.mark.parametrize("spec,params,ok", [
    (ObsSpec(), KNEAREST, True),
    (ObsSpec(), LINEAR, True),
    (ObsSpec(norm_obs=False), KNEAREST, False),
    (ObsSpec(reward_conditioned=True), KNEAREST, False),
    (ObsSpec(ego_state=False), LINEAR, False),
    (ObsSpec(partner_obs=False), KNEAREST, False),
    (ObsSpec(road_map_obs=False), LINEAR, False),
])
def test_step_supports_the_classic_spec_either_road_selection(spec, params,
                                                              ok):
    assert k5.step_supports(spec, params) is ok


def test_k6_refuses_the_specs_it_leaves(data_env):
    with pytest.raises(ValueError, match="K6"):
        k5.flat_obs_step(data_env.scene, data_env.state, data_env.params,
                         ObsSpec(norm_obs=False))


@pytest.mark.parametrize("spec,split,takes_k6", [
    (ObsSpec(), False, True),
    (ObsSpec(), True, False),
    (ObsSpec(norm_obs=False), False, False),
    (ObsSpec(reward_conditioned=True), False, False),
    (ObsSpec(partner_obs=False), False, False),
])
def test_flat_observation_takes_k6_on_cuda_tensors_only(data_env, spec,
                                                        split, takes_k6,
                                                        monkeypatch):
    """The dispatch inside flat_observation, with CUDA faked by the
    tensors' is_cuda: K6 for the specs it covers and not split, the plain
    code for the rest; real CPU tensors always take the plain code."""
    env = data_env
    calls = []
    monkeypatch.setattr(k5, "flat_obs_step",
                        lambda *a: calls.append(a) or "k6")
    args = (env.scene, env.state, env.params, spec, env.reward_weights)
    assert flat_observation(*args, split=split) != "k6"
    assert not calls
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    got = flat_observation(*args, split=split)
    assert (got == "k6") is takes_k6
    assert len(calls) == int(takes_k6)


def _as_sets(x: torch.Tensor) -> torch.Tensor:
    """Each [K, F] row block sorted by its rows, lexicographically."""
    out = x.clone()
    for i in range(x.shape[0]):
        rows = x[i]
        for f in reversed(range(rows.shape[1])):
            rows = rows[torch.sort(rows[:, f], stable=True).indices]
        out[i] = rows
    return out


@pytest.fixture(scope="module")
def small_large_map():
    """Two synthetic large-map worlds of 10,240 roads on the CPU, where
    egos see more than 200 roads in the radius."""
    from gpudrive_lab_torch.scene.large_map import LARGE_MAP, large_map_scene

    scene, state, _ = large_map_scene(**dict(LARGE_MAP, W=2, A=32), seed=4,
                                      device="cpu", grid=False)
    return scene, state


@pytest.mark.parametrize("sel", ["dense", "world", "flat"])
@pytest.mark.parametrize("knn", [True, False])
def test_agent_map_observations_orders_roads_as_k6(small_large_map, knn,
                                                   sel):
    """The plain road rows come in K6's order: KNEAREST nearest first,
    LINEAR in index order, also past 200 roads in the radius; a row where
    two of the 201 nearest share a d2 holds the same rows as a set."""
    scene, state = small_large_map
    params = KNEAREST if knn else LINEAR
    ego = {"dense": None,
           "world": torch.tensor([[3, 0, 30, 7], [1, 29, 2, 0]]),
           "flat": (torch.tensor([1, 0, 1]), torch.tensor([0, 5, 31]))}[sel]
    idx, count, ties = road_order.nearest_first(scene, state, params, ego)
    assert int(count.max()) == C.MAX_AGENT_MAP_OBS  # more in the radius
    got = road_order.road_rows_at(scene, state, params, ego, idx, count)
    want = obsmod.agent_map_observations(scene, state, params, ego)
    assert got.shape == want.shape
    got, want = got.reshape(len(idx), -1, 9), want.reshape(len(idx), -1, 9)
    same = (got.view(torch.int32) == want.view(torch.int32)).all(-1).all(-1)
    assert bool((same | ties).all())
    assert torch.equal(_as_sets(got[ties]), _as_sets(want[ties]))

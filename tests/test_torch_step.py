"""Step parity: 91 steps from the same scene and the same numpy actions
through both packages.  done, the collision flags, reached_goal and
steps_remaining must be equal; pos, yaw and vel within 1e-3, the
reference's own epsilon (ROADMAP "parity bar"), over the four dynamics
models, the three collision behaviours, the distance reward's goal test,
ignore_non_vehicles, init_only_valid_agents=False and 3 or 0 controlled
agents per world.  Also the expert-replay and collision-fixture contracts
of the JAX package's tests, on the port."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.core import step as jstep
from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.core.types import (
    CollisionBehaviour,
    DynamicsModel,
    Params,
    RewardType,
)
from gpudrive_lab_torch.scene.compiler import build_scene
from torch_parity import (
    AGENT_AGENT,
    POOL_SCENES,
    ROAD_EDGE,
    SYNTHETIC_SCENE,
    assert_states_match,
    jax_params,
    scene_to_jax,
    state_to_jax,
)

CASES = {
    # the slice's configuration, dense agent-road branch (K2)
    "dense-ignore": (Params(collision_behaviour=CollisionBehaviour.IGNORE,
                            polyline_reduction_threshold=0.1,
                            use_tile_collision=False), None),
    # road tiles forced on at the 256 bucket (K1)
    "tiles-ignore": (Params(collision_behaviour=CollisionBehaviour.IGNORE,
                            polyline_reduction_threshold=0.1,
                            use_tile_collision=True), None),
    # agents stop on collision, padded 2048 bucket through the tiles
    "tiles-stop-2048": (Params(polyline_reduction_threshold=0.1), 2048),
    # the other dynamics models and collision behaviours
    "bicycle-ignore": (Params(
        dynamics_model=DynamicsModel.INVERTIBLE_BICYCLE,
        collision_behaviour=CollisionBehaviour.IGNORE), None),
    "delta-local-stop": (Params(dynamics_model=DynamicsModel.DELTA_LOCAL),
                         None),
    "state-removed": (Params(dynamics_model=DynamicsModel.STATE,
                             collision_behaviour=(
                                 CollisionBehaviour.AGENT_REMOVED)), None),
    "classic-removed-tiles": (Params(
        collision_behaviour=CollisionBehaviour.AGENT_REMOVED,
        use_tile_collision=True), None),
    # the distance reward's goal test, vehicles only
    "distance-vehicles-only": (Params(
        reward_type=RewardType.DISTANCE_BASED, dist_to_goal_threshold=1.0,
        ignore_non_vehicles=True), None),
    # every agent created, 3 controlled per world
    "all-agents-3-controlled": (Params(init_only_valid_agents=False,
                                       max_num_controlled_agents=3), None),
    "none-controlled": (Params(max_num_controlled_agents=0), None),
}


def _actions(model, rng, shape):
    """[T, W, A, ACTION_DIM] random actions of the dynamics model: accel
    and steer (classic, bicycle), a local displacement and turn (delta
    local), or an absolute state to teleport to (state)."""
    actions = np.zeros(shape + (C.ACTION_DIM,), np.float32)
    if model == DynamicsModel.DELTA_LOCAL:
        actions[..., 0] = rng.uniform(-0.5, 3.0, shape)
        actions[..., 1] = rng.uniform(-0.5, 0.5, shape)
        actions[..., 2] = rng.uniform(-0.3, 0.3, shape)
    elif model == DynamicsModel.STATE:
        actions[..., 0:2] = rng.uniform(-60, 60, shape + (2,))
        actions[..., 3] = rng.uniform(-3, 3, shape)
        actions[..., 4:6] = rng.uniform(-10, 10, shape + (2,))
        actions[..., 9] = rng.uniform(-1, 1, shape)
    else:
        actions[..., 0] = rng.uniform(-4, 4, shape)
        actions[..., 1] = rng.uniform(-0.6, 0.6, shape)
    return actions


@pytest.mark.parametrize("case", sorted(CASES))
def test_rollout_91_steps_matches_jax(case):
    params, max_roads = CASES[case]
    paths = POOL_SCENES[10:13]
    scene = build_scene(paths, params, max_roads=max_roads, device="cpu")
    assert (scene.rtiles is not None) == (
        bool(params.use_tile_collision) or max_roads == 2048)
    jscene = scene_to_jax(scene)
    jp = jax_params(params)
    step_fn = jax.jit(jstep.step, static_argnames="params")

    W, A = scene.agents.valid.shape
    rng = np.random.default_rng(0)
    actions = _actions(params.dynamics_model, rng, (C.EPISODE_LEN, W, A))

    state = stepmod.reset(scene, None, params)
    jstate = jax.jit(jstep.reset, static_argnames="params")(jscene, None, jp)
    assert_states_match(jstate, state, where="reset")
    collided_any = 0
    for t in range(C.EPISODE_LEN):
        state = stepmod.step(scene, state, torch.from_numpy(actions[t]),
                             params)
        jstate = step_fn(jscene, jstate, actions[t], jp)
        assert_states_match(jstate, state, where=f"step {t + 1}")
        collided_any += int(state.collided.sum())
    assert (state.done.bool() | ~scene.agents.valid).all()
    if params.max_num_controlled_agents:  # else every agent replays its log
        assert collided_any > 0  # the random drive does hit roads or agents


def test_partial_reset_matches_jax():
    """reset() with a world mask: the per-world select against the fresh
    state, then the idempotent tail, as in the JAX package."""
    params = Params(collision_behaviour=CollisionBehaviour.IGNORE)
    scene = build_scene(POOL_SCENES[:3], params, device="cpu")
    jscene, jp = scene_to_jax(scene), jax_params(params)
    state = stepmod.reset(scene, None, params)
    act = torch.zeros((3, C.MAX_AGENTS, C.ACTION_DIM))
    act[..., 0] = 2.0
    for _ in range(5):
        state = stepmod.step(scene, state, act, params)
    mask = torch.tensor([True, False, True])
    got = stepmod.reset(scene, state, params, mask)
    want = jstep.reset(jscene, state_to_jax(state), jp, mask.numpy())
    assert_states_match(want, got)
    # the select against the cached fresh state equals the full reset graph
    fresh = stepmod.reset(scene, None, params)
    sel = stepmod.select_worlds(mask, fresh, state)
    for f in dataclasses.fields(sel):
        assert torch.equal(getattr(sel, f.name), getattr(got, f.name)), f.name


EXPERT_PARAMS = Params(
    dynamics_model=DynamicsModel.CLASSIC,
    collision_behaviour=CollisionBehaviour.AGENT_STOP,
    reward_type=RewardType.DISTANCE_BASED,
    dist_to_goal_threshold=1.0,
    observation_radius=10.0,
    polyline_reduction_threshold=0.5,
    ignore_non_vehicles=True,
    max_num_controlled_agents=0,
)


def _expert_replay(n_max=120):
    scene = build_scene([SYNTHETIC_SCENE], EXPERT_PARAMS, device="cpu")
    state = stepmod.reset(scene, None, EXPERT_PARAMS)
    acts = torch.zeros((1, C.MAX_AGENTS, C.ACTION_DIM))
    traj, n = [], 0
    while not bool(state.done.all()) and n < n_max:
        state = stepmod.step(scene, state, acts, EXPERT_PARAMS)
        traj.append(state.pos.clone())
        n += 1
    return scene, state, n, torch.stack(traj)


def test_expert_replay_contract():
    """tests/test_expert_replay.py on the port: an all-expert episode ends
    at the horizon with every vehicle at its goal and no collision, and
    replays deterministically."""
    scene, state, n, traj = _expert_replay()
    assert n == C.EPISODE_LEN
    veh = scene.agents.valid & (scene.agents.etype == C.ET_VEHICLE)
    assert int(veh.sum()) > 0
    assert bool((state.reached_goal.bool() | ~veh).all())
    collisions = ((state.collided_road + state.collided_vehicle
                   + state.collided_non_vehicle) * veh).sum()
    assert int(collisions) == 0
    assert torch.equal(traj, _expert_replay()[3])


def test_collision_fixtures():
    """tests/test_collision_scenarios.py on the port: the road-edge agent
    collides at step 1; the agent-agent pair touches between steps 40 and
    50; the cases stay apart across worlds."""
    params = Params(
        dynamics_model=DynamicsModel.CLASSIC,
        collision_behaviour=CollisionBehaviour.IGNORE,
        reward_type=RewardType.DISTANCE_BASED,
        dist_to_goal_threshold=1.0,
        polyline_reduction_threshold=0.0,
        max_num_controlled_agents=0,
    )
    W = 8
    paths = [AGENT_AGENT if w % 2 == 0 else ROAD_EDGE for w in range(W)]
    scene = build_scene(paths, params, device="cpu")
    state = stepmod.reset(scene, None, params)
    acts = torch.zeros((W, scene.max_agents, C.ACTION_DIM))
    snaps = {}
    for t in range(1, 61):
        state = stepmod.step(scene, state, acts, params)
        if t in (1, 40, 50, 60):
            snaps[t] = state
    aa, road = slice(0, W, 2), slice(1, W, 2)
    assert (snaps[1].collided_road[road, 0] == 1).all()
    assert (snaps[1].collided_vehicle[road, 0] == 0).all()
    assert (snaps[1].collided_vehicle[aa, :2] == 0).all()
    assert (snaps[1].collided_road[aa, :2] == 0).all()
    assert (snaps[40].collided_vehicle[aa, :2] == 0).all()
    assert (snaps[50].collided_vehicle[aa, :2] == 1).all()
    assert (snaps[50].collided_road[aa, :2] == 0).all()
    assert (snaps[60].collided_vehicle[road] == 0).all()

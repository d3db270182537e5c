"""The simulation step (port of ``gpudrive_lab_tpu/core/step.py``).

One Step-graph invocation (reference: src/sim.cpp:785-971):

    movement -> collision -> reward -> step tracker -> done

and the Reset graph ``reset(scene, state, params, reset_mask)`` built from
the same tail (no step decrement), with world regeneration as a per-world
select against the freshly initialised state.
"""

from __future__ import annotations

import dataclasses

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import dynamics
from gpudrive_lab_torch.core.collision import collision_system
from gpudrive_lab_torch.utils.profiling import span
from gpudrive_lab_torch.core.types import (
    CollisionBehaviour,
    DynamicsModel,
    Params,
    RewardType,
    Scene,
    SimState,
    vec_norm,
)


def current_step_index(state: SimState) -> torch.Tensor:
    """Trajectory index used by movement/collision this step
    (reference: src/sim.cpp:23-25), clamped into the stored horizon."""
    return torch.clamp(
        C.EPISODE_LEN - state.steps_remaining, 0, C.TRAJECTORY_LEN - 1
    )


def _take_t(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [W, A, T, ...] at per-agent time idx [W, A] -> [W, A, ...]."""
    i = idx.long().reshape(idx.shape + (1,) * (x.dim() - 2))
    i = i.expand(idx.shape + (1,) + x.shape[3:])
    return torch.gather(x, 2, i).squeeze(2)


def _movement_system(
    scene: Scene, state: SimState, actions: torch.Tensor, params: Params,
    cur_step: torch.Tensor,
) -> SimState:
    """reference: src/sim.cpp:294-383."""
    agents = scene.agents
    valid = agents.valid
    collided_b = (state.collided != 0) & valid
    zero = torch.zeros_like(state.vel)
    f0 = torch.zeros((), dtype=torch.float32, device=valid.device)
    f1 = torch.ones((), dtype=torch.float32, device=valid.device)
    i0 = torch.zeros((), dtype=torch.int32, device=valid.device)
    i1 = torch.ones((), dtype=torch.int32, device=valid.device)
    # filled on the device: torch.tensor(..., device=cuda) would copy from
    # the host and wait for the stream on every step
    pad_xy = torch.stack([
        torch.full((), v, dtype=torch.float32, device=valid.device)
        for v in C.PADDING_POSITION
    ])
    pad_z = torch.full((), torch.finfo(torch.float32).max,  # C.PADDING_Z
                       dtype=torch.float32, device=valid.device)

    done = state.done
    collided = state.collided
    pos, z, vel, ang_vel = state.pos, state.z, state.vel, state.ang_vel
    c_road, c_veh, c_nonveh = (
        state.collided_road, state.collided_vehicle,
        state.collided_non_vehicle,
    )

    # -- phase 1: collision response (src/sim.cpp:302-323) ----------------
    if params.collision_behaviour == CollisionBehaviour.AGENT_STOP:
        done = torch.where(collided_b, i1, done)
        vel = torch.where(collided_b[..., None], zero, vel)
        ang_vel = torch.where(collided_b, f0, ang_vel)
    elif params.collision_behaviour == CollisionBehaviour.AGENT_REMOVED:
        done = torch.where(collided_b, i1, done)
        pos = torch.where(collided_b[..., None], pad_xy, pos)
        z = torch.where(collided_b, pad_z, z)
        vel = torch.where(collided_b[..., None], zero, vel)
        ang_vel = torch.where(collided_b, f0, ang_vel)
    else:  # IGNORE: clear the event + info flags each step
        collided = torch.where(collided_b, i0, collided)
        c_road = torch.where(collided_b, i0, c_road)
        c_veh = torch.where(collided_b, i0, c_veh)
        c_nonveh = torch.where(collided_b, i0, c_nonveh)

    movable = valid & ~agents.static

    # -- phase 2: teleport done (non-static) agents (src/sim.cpp:333-343) --
    # Under AgentStop/AgentRemoved a newly collided agent is done and so is
    # also teleported this same step (the reference re-reads the done flag).
    teleport = movable & (done != 0)
    pos = torch.where(teleport[..., None], pad_xy, pos)
    z = torch.where(teleport, pad_z, z)
    vel = torch.where(teleport[..., None], zero, vel)
    ang_vel = torch.where(teleport, f0, ang_vel)

    # -- phase 3: integrate ------------------------------------------------
    active = movable & (done == 0)
    drive = active & agents.controlled
    expert = active & ~agents.controlled

    if params.dynamics_model == DynamicsModel.CLASSIC:
        n_pos, n_yaw, n_vel, n_w = dynamics.forward_classic(
            actions, agents.size[..., 0], pos, state.yaw, vel
        )
    elif params.dynamics_model == DynamicsModel.INVERTIBLE_BICYCLE:
        n_pos, n_yaw, n_vel, n_w = dynamics.forward_invertible_bicycle(
            actions, pos, state.yaw, vel
        )
    elif params.dynamics_model == DynamicsModel.DELTA_LOCAL:
        n_pos, n_yaw, n_vel, n_w = dynamics.forward_delta_local(
            actions, pos, state.yaw, vel
        )
    else:  # STATE
        n_pos, n_yaw, n_vel, n_w = dynamics.forward_state(actions)

    yaw = torch.where(drive, n_yaw, state.yaw)
    pos = torch.where(drive[..., None], n_pos, pos)
    # Classic sets z=1 explicitly (src/dynamics.hpp:43); live agents always
    # have z=1 under the other models anyway.
    z = torch.where(drive, f1, z)
    vel = torch.where(drive[..., None], n_vel, vel)
    ang_vel = torch.where(drive, n_w, ang_vel)

    # Expert playback (src/sim.cpp:370-382)
    pos = torch.where(expert[..., None], _take_t(agents.traj_pos, cur_step), pos)
    z = torch.where(expert, f1, z)
    vel = torch.where(expert[..., None], _take_t(agents.traj_vel, cur_step), vel)
    ang_vel = torch.where(expert, f0, ang_vel)
    yaw = torch.where(expert, _take_t(agents.traj_yaw, cur_step), yaw)

    return state.replace(
        pos=pos, z=z, yaw=yaw, vel=vel, ang_vel=ang_vel, collided=collided,
        done=done, collided_road=c_road, collided_vehicle=c_veh,
        collided_non_vehicle=c_nonveh,
    )


def _reward_system(scene: Scene, state: SimState, params: Params) -> SimState:
    """reference: src/sim.cpp:560-587."""
    dist = vec_norm(state.pos - scene.agents.goal)
    if params.reward_type == RewardType.DISTANCE_BASED:
        r = -dist
    else:  # ON_GOAL_ACHIEVED
        r = (dist < params.dist_to_goal_threshold).to(torch.float32)
    return state.replace(
        reward=torch.where(scene.agents.valid, r, state.reward)
    )


def _done_system(scene: Scene, state: SimState, params: Params) -> SimState:
    """reference: src/sim.cpp:597-626."""
    valid = scene.agents.valid
    steps = state.steps_remaining
    done = state.done
    reached = state.reached_goal
    i0 = torch.zeros((), dtype=torch.int32, device=valid.device)
    i1 = torch.ones((), dtype=torch.int32, device=valid.device)

    fresh = (steps == C.EPISODE_LEN) & (done != 1)  # early-return branch
    done = torch.where(fresh, i0, torch.where(steps == 0, i1, done))

    near = vec_norm(state.pos - scene.agents.goal) < params.dist_to_goal_threshold
    check = ~fresh & ~((done == 1) & (reached == 1)) & near
    done = torch.where(check, i1, done)
    reached = torch.where(check, i1, reached)

    return state.replace(
        done=torch.where(valid, done, state.done),
        reached_goal=torch.where(valid, reached, state.reached_goal),
    )


def _rest_of_tasks(
    scene: Scene, state: SimState, params: Params, cur_step: torch.Tensor,
    decrement_step: bool,
) -> SimState:
    """Shared tail of the Step and Reset graphs
    (reference: src/sim.cpp:785-943)."""
    state = collision_system(scene, state, params, cur_step)
    with span("sim.reward_done"):
        state = _reward_system(scene, state, params)
        if decrement_step:
            state = state.replace(
                steps_remaining=torch.where(
                    scene.agents.valid, state.steps_remaining - 1,
                    state.steps_remaining,
                )
            )
        return _done_system(scene, state, params)


def step(
    scene: Scene, state: SimState, actions: torch.Tensor, params: Params
) -> SimState:
    """One Step-graph invocation (reference: src/sim.cpp:945-958).
    ``actions``: [W, A, 10] action-union rows (src/types.hpp:109-145)."""
    with span("sim.step"):
        cur_step = current_step_index(state)
        with span("sim.movement"):
            state = _movement_system(scene, state, actions, params, cur_step)
        return _rest_of_tasks(scene, state, params, cur_step,
                              decrement_step=True)


def init_state(scene: Scene) -> SimState:
    """Fresh per-agent state exactly as resetAgent leaves it
    (reference: src/level_gen.cpp:32-54), before the Reset graph's tail."""
    agents = scene.agents
    valid = agents.valid
    dev = valid.device
    f0 = torch.zeros((), dtype=torch.float32, device=dev)
    f1 = torch.ones((), dtype=torch.float32, device=dev)
    i0 = torch.zeros((), dtype=torch.int32, device=dev)
    i1 = torch.ones((), dtype=torch.int32, device=dev)
    yaw0 = agents.traj_yaw[:, :, 0]
    zeros_i = torch.zeros_like(agents.aid)
    return SimState(
        pos=torch.where(valid[..., None], agents.traj_pos[:, :, 0], f0),
        z=torch.where(valid, f1, f0),
        yaw=torch.where(valid, yaw0, f0),
        vel=torch.where(
            (valid & ~agents.static)[..., None], agents.traj_vel[:, :, 0], f0
        ),
        ang_vel=torch.zeros_like(yaw0),
        collided=zeros_i,
        done=torch.where(valid, i0, i1),
        collided_road=zeros_i,
        collided_vehicle=zeros_i,
        collided_non_vehicle=zeros_i,
        reached_goal=zeros_i,
        steps_remaining=torch.where(
            valid, torch.full_like(zeros_i, C.EPISODE_LEN), zeros_i
        ),
        reward=torch.zeros_like(yaw0),
    )


def world_done(scene: Scene, state: SimState) -> torch.Tensor:
    """[W] bool: every created agent of the world is done (the worlds an
    auto-reset replaces)."""
    return ((state.done != 0) | ~scene.agents.valid).all(dim=1)


def select_worlds(mask: torch.Tensor, a: SimState, b: SimState) -> SimState:
    """Per-world select: world w of the result is ``a``'s where mask[w],
    else ``b``'s (mask [W] bool)."""
    with span("sim.reset"):
        return SimState(**{
            f.name: torch.where(
                mask.reshape((-1,) + (1,) * (getattr(a, f.name).dim() - 1)),
                getattr(a, f.name), getattr(b, f.name),
            )
            for f in dataclasses.fields(SimState)
        })


def reset(
    scene: Scene,
    state: SimState | None,
    params: Params,
    reset_mask: torch.Tensor | None = None,
) -> SimState:
    """Reset-graph invocation (reference: src/sim.cpp:150-166, 960-966).

    ``reset_mask``: [W] bool — worlds to regenerate; the others pass through
    the (idempotent) graph tail, as in the reference, which runs the Reset
    taskgraph across all worlds and regenerates only the flagged ones."""
    fresh = init_state(scene)
    if state is None or reset_mask is None:
        state = fresh
    else:
        state = select_worlds(reset_mask, fresh, state)
    cur_step = current_step_index(state)
    return _rest_of_tasks(scene, state, params, cur_step, decrement_step=False)

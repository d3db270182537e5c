"""Synthetic scene construction (port of
``gpudrive_lab_tpu/scene/synthetic.py``).

Builds tiny valid ``Scene``s directly from numpy, with no JSON files: for
unit tests, and a template for users generating procedural scenarios (the
reference has no equivalent: all its worlds come from WOMD JSONs through
MapReader).  The arrays are the JAX module's, value for value, as tensors
on ``device``."""

from __future__ import annotations

import numpy as np
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.types import AgentsStatic, RoadGraph, Scene
from gpudrive_lab_torch.device import resolve_device


def synthetic_scene(
    num_worlds: int,
    num_agents: int = 4,
    num_roads: int = 16,
    max_roads: int = 64,
    seed: int = 0,
    device=None,
) -> Scene:
    """A straight-road world: agents drive +x at 5 m/s between two road
    edges; goals 40m ahead; expert trajectories are the constant-velocity
    rollout.  On ``device`` (CUDA unless another is named)."""
    dev = resolve_device(device)

    def tensor(x):
        return torch.tensor(np.asarray(x), device=dev)

    rng = np.random.default_rng(seed)
    A, T = C.MAX_AGENTS, C.TRAJECTORY_LEN
    W = num_worlds

    valid = np.zeros((W, A), bool)
    valid[:, :num_agents] = True
    etype = np.where(valid, C.ET_VEHICLE, 0).astype(np.int32)
    size = np.zeros((W, A, 3), np.float32)
    size[:, :num_agents] = (4.5, 2.0, 1.5)

    # Lanes spaced 4m apart in y, cars start spread in x
    y0 = (np.arange(num_agents) % 4) * 4.0 - 6.0
    x0 = (np.arange(num_agents) // 4) * 15.0 - 30.0
    start = np.stack([x0, y0], axis=-1)[None].repeat(W, 0)
    start += rng.normal(0, 0.1, start.shape)

    t = np.arange(T, dtype=np.float32)[None, None, :, None]
    vel0 = np.array([5.0, 0.0], np.float32)
    traj_pos = np.zeros((W, A, T, 2), np.float32)
    traj_pos[:, :num_agents] = (
        start[:, :, None, :] + vel0 * t[:, :, :, :] * C.DYNAMICS_DT
    )
    traj_vel = np.zeros((W, A, T, 2), np.float32)
    traj_vel[:, :num_agents] = vel0
    traj_yaw = np.zeros((W, A, T), np.float32)
    traj_valid = np.zeros((W, A, T), np.float32)
    traj_valid[:, :num_agents] = 1.0
    goal = np.zeros((W, A, 2), np.float32)
    goal[:, :num_agents] = traj_pos[:, :num_agents, -1]

    agents = AgentsStatic(
        valid=tensor(valid),
        etype=tensor(etype),
        size=tensor(size),
        goal=tensor(goal),
        aid=tensor(
            np.where(valid, np.arange(A)[None], -1).astype(np.int32)
        ),
        controlled=tensor(valid),
        static=tensor(np.zeros((W, A), bool)),
        mark_as_expert=tensor(np.zeros((W, A), bool)),
        metadata=tensor(np.zeros((W, A, 4), np.int32)),
        traj_pos=tensor(traj_pos),
        traj_vel=tensor(traj_vel),
        traj_yaw=tensor(traj_yaw),
        traj_valid=tensor(traj_valid),
        traj_inv_actions=tensor(
            np.zeros((W, A, T, C.ACTION_DIM), np.float32)
        ),
    )

    # Two long road edges at y = +-10, chopped into segments
    R = max_roads
    seg = np.zeros((W, R, 3), np.float32)
    seg_yaw = np.zeros((W, R), np.float32)
    seg_scale = np.zeros((W, R, 3), np.float32)
    half = 10.0
    n_half = num_roads // 2
    xs = (np.arange(n_half) - n_half / 2) * 2 * half + half
    for i in range(n_half):
        seg[:, i] = (xs[i], 10.0, 1.1)
        seg[:, n_half + i] = (xs[i], -10.0, 1.1)
        seg_scale[:, i] = (half, 0.1, 0.1)
        seg_scale[:, n_half + i] = (half, 0.1, 0.1)
    r_valid = np.zeros((W, R), bool)
    r_valid[:, :num_roads] = True
    roads = RoadGraph(
        pos=tensor(seg),
        yaw=tensor(seg_yaw),
        scale=tensor(seg_scale),
        etype=tensor(
            np.where(r_valid, C.ET_ROAD_EDGE, 0).astype(np.int32)
        ),
        rid=tensor(
            np.where(r_valid, np.arange(R)[None], -1).astype(np.int32)
        ),
        map_type=tensor(np.full((W, R), 15, np.int32)),
        valid=tensor(r_valid),
    )

    return Scene(
        agents=agents,
        roads=roads,
        num_agents=tensor(np.full((W,), num_agents, np.int32)),
        num_roads=tensor(np.full((W,), num_roads, np.int32)),
        means=tensor(np.zeros((W, 3), np.float32)),
        map_name=tensor(np.zeros((W, 32), np.int32)),
        scenario_id=tensor(np.zeros((W, 32), np.int32)),
    )

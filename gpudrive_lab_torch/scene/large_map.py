"""A seeded synthetic large map: the agent-road kernels' input at the road
counts they are built for.

The repository's scenes (``data/pool_v3``) have at most 192 road points, so
the tile-skip kernel K1 only ever sees padding there; the reference allows
up to 10,000 road segments per world.  Until real large WOMD maps are in the
repository, ``large_map`` stands in for one: per world, R road segments
along random-walk polylines over a square of ``side`` metres (about 40 %
road edges, a few stop signs, the rest lanes and lines) and ``n_active``
active vehicles placed on the roads within ``AGENT_RADIUS`` of a random
centre, as a scenario's agents gather around its ego vehicle.  The build is
host numpy from one seed; the tiles come from
``scene/rtiles.build_road_tiles`` and the agent order and mask from the
step's own ``core/collision.tile_mask_and_order``.  ``large_map_scene``
gives the same map as a ``Scene`` (with road tiles and the collision grid)
for the step's own collision pass over every agent-road path.
"""

from __future__ import annotations

import types
from dataclasses import dataclass

import numpy as np
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.collision import tile_mask_and_order
from gpudrive_lab_torch.core.types import (
    AgentsStatic,
    RoadGraph,
    RoadTiles,
    Scene,
    SimState,
)
from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.scene.grid import build_collision_grid
from gpudrive_lab_torch.scene.rtiles import ROAD_TILE, build_road_tiles

# The map of chip_smoke.py's large-map phase: 512 worlds of 128 agent rows
# and 10,240 road segments (40 tiles of 256).
LARGE_MAP = dict(W=512, A=128, R=10240, n_active=24, side=400.0)

SEGMENTS_PER_POLYLINE = 64
SEGMENT_LENGTH = 4.0  # metres
EDGE_SHARE = 0.4  # of the polylines
STOP_SIGN_SHARE = 0.001  # of the segments
AGENT_RADIUS = 80.0  # metres around a world's centre of traffic
VEHICLE_HALF = (4.5 * 0.5 * C.VEHICLE_LENGTH_SCALE,
                2.0 * 0.5 * C.VEHICLE_LENGTH_SCALE)


@dataclass
class LargeMap:
    agents: torch.Tensor  # [W, A, 8] kernel rows, in the env's agent order
    roads_t: torch.Tensor  # [W, 8, R] K2's rows (the tiles' Morton order)
    rtiles: RoadTiles  # K1's tiles
    agents_s: torch.Tensor  # [W, A, 8] Morton-sorted rows for K1
    mask: torch.Tensor  # [W, A/16, T] int32
    inv_perm: torch.Tensor  # [W, A] K1's rows back to the env's order
    params: dict  # what was built, for the record

    def describe(self) -> str:
        p = self.params
        return (f"{p['W']} worlds x {p['R']} road segments ({p['T']} tiles "
                f"of {ROAD_TILE}) over {p['side']:g} m squares: "
                f"{p['edges']:.1%} road edges, {p['stop_signs']} stop signs "
                f"in all, the rest lanes and lines; {p['n_active']} active "
                f"vehicles of {p['A']} agent rows per world; seed {p['seed']}")


def _generate(W: int, A: int, R: int, n_active: int, side: float,
              seed: int) -> dict:
    """The map's host arrays from ``seed``: roads (pos [W, R, 3], yaw,
    scale, etype) and the agent kernel rows [W, A, 8]."""
    if R % ROAD_TILE or R % SEGMENTS_PER_POLYLINE or A % 16 or n_active > A:
        raise ValueError(f"W={W} A={A} R={R} n_active={n_active}")
    rng = np.random.default_rng(seed)
    n_poly = R // SEGMENTS_PER_POLYLINE
    # polylines: a random start and heading, the heading drifting per step
    start = rng.uniform(0.0, side, (W, n_poly, 1, 2))
    heading = (rng.uniform(-np.pi, np.pi, (W, n_poly, 1))
               + np.cumsum(rng.normal(0.0, 0.08,
                                      (W, n_poly, SEGMENTS_PER_POLYLINE)), -1))
    step = SEGMENT_LENGTH * np.stack([np.cos(heading), np.sin(heading)], -1)
    ends = start + np.cumsum(step, axis=2)
    # segment centres, wrapped into the square
    mid = np.mod(ends - 0.5 * step, side).reshape(W, R, 2)
    yaw = np.arctan2(np.sin(heading), np.cos(heading)).reshape(W, R)
    kind = rng.choice([C.ET_ROAD_EDGE, C.ET_ROAD_LANE, C.ET_ROAD_LINE],
                      (W, n_poly, 1), p=[EDGE_SHARE, 0.35, 0.25])
    etype = np.broadcast_to(kind, (W, n_poly, SEGMENTS_PER_POLYLINE))
    etype = etype.reshape(W, R).copy()
    stop = rng.random((W, R)) < STOP_SIGN_SHARE
    etype[stop] = C.ET_STOP_SIGN
    scale = np.empty((W, R, 3), np.float32)
    scale[..., 0] = 0.5 * SEGMENT_LENGTH
    scale[..., 1:] = 0.1
    scale[stop] = (0.5, 0.5, 0.1)
    pos = np.concatenate([mid, np.zeros((W, R, 1))], -1).astype(np.float32)

    # active vehicles on random segments near a centre, the rest padding rows
    centre = rng.uniform(AGENT_RADIUS, side - AGENT_RADIUS, (W, 1, 2))
    near = np.hypot(*np.moveaxis(mid - centre, -1, 0)) <= AGENT_RADIUS
    seg = np.stack([rng.choice(np.flatnonzero(n), n_active) for n in near])
    side_off = rng.normal(0.0, 1.5, (W, n_active))
    a_yaw = (np.take_along_axis(yaw, seg, 1)
             + rng.normal(0.0, 0.1, (W, n_active)))
    normal = np.stack([-np.sin(a_yaw), np.cos(a_yaw)], -1)
    a_pos = (np.take_along_axis(mid, seg[..., None], 1)
             + side_off[..., None] * normal)
    agents = np.zeros((W, A, 8), np.float32)
    agents[:, :n_active, 0:2] = a_pos
    agents[:, :n_active, 2] = np.cos(a_yaw)
    agents[:, :n_active, 3] = np.sin(a_yaw)
    agents[:, :n_active, 4] = VEHICLE_HALF[0] * rng.uniform(0.8, 1.2,
                                                            (W, n_active))
    agents[:, :n_active, 5] = VEHICLE_HALF[1] * rng.uniform(0.9, 1.1,
                                                            (W, n_active))
    agents[:, :n_active, 6] = 1.0
    agents[:, :, 7] = 1.0
    return dict(pos=pos, yaw=yaw.astype(np.float32), scale=scale,
                etype=etype, agents=agents, a_yaw=a_yaw.astype(np.float32),
                stop_signs=int(stop.sum()))


def large_map(W: int, A: int, R: int, n_active: int, side: float = 400.0,
              seed: int = 0, device=None) -> LargeMap:
    """Build the map (R a multiple of 256, A of 16, n_active <= A) on
    ``device``: CUDA unless the caller names another."""
    g = _generate(W, A, R, n_active, side, seed)
    device = resolve_device(device)
    rt = build_road_tiles(g["pos"], g["yaw"], g["scale"], g["etype"],
                          np.ones((W, R), bool), device=device)
    feat = torch.from_numpy(g["agents"]).to(device)

    T = R // ROAD_TILE
    roads_t = rt.feat.permute(0, 2, 1, 3).reshape(W, 8, R).contiguous()
    feat_s, mask, inv_perm = tile_mask_and_order(
        types.SimpleNamespace(rtiles=rt),
        types.SimpleNamespace(pos=feat[..., 0:2]), feat)
    params = dict(W=W, A=A, R=R, T=T, n_active=n_active, side=side,
                  seed=seed, edges=float((g["etype"] == C.ET_ROAD_EDGE).mean()),
                  stop_signs=g["stop_signs"])
    return LargeMap(feat, roads_t, rt, feat_s.contiguous(), mask, inv_perm,
                    params)


def large_map_scene(W: int, A: int, R: int, n_active: int,
                    side: float = 400.0, seed: int = 0, device=None,
                    grid: bool = True):
    """The same map (same seed, same roads and vehicles as ``large_map``)
    as a Scene and the SimState of one collision pass: roads in their
    generation order with road tiles and, with ``grid``, the collision
    grid built from the road arrays; the n_active vehicles controlled and
    valid, the other rows padding.  Returns (scene, state, cur_step) for
    ``core.collision.collision_system``, on ``device`` (CUDA unless the
    caller names another)."""
    g = _generate(W, A, R, n_active, side, seed)
    device = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    valid = np.zeros((W, A), bool)
    valid[:, :n_active] = True
    ag = g["agents"]
    size = np.zeros((W, A, 3), np.float32)
    size[..., 0:2] = ag[..., 4:6] / np.float32(0.5 * C.VEHICLE_LENGTH_SCALE)
    size[..., 2] = 1.5
    yaw = np.zeros((W, A), np.float32)
    yaw[:, :n_active] = g["a_yaw"]
    zf = np.zeros((W, A), np.float32)
    zi = np.zeros((W, A), np.int32)
    agents = AgentsStatic(
        valid=t(valid), etype=t(np.where(valid, C.ET_VEHICLE, 0)
                                 .astype(np.int32)),
        size=t(size), goal=t(np.zeros((W, A, 2), np.float32)),
        aid=t(np.where(valid, np.arange(A), -1).astype(np.int32)),
        controlled=t(valid), static=t(np.zeros((W, A), bool)),
        mark_as_expert=t(np.zeros((W, A), bool)),
        metadata=t(np.zeros((W, A, 4), np.int32)),
        traj_pos=t(ag[:, :, None, 0:2]), traj_vel=t(np.zeros((W, A, 1, 2),
                                                             np.float32)),
        traj_yaw=t(yaw[..., None]), traj_valid=t(valid[..., None]
                                                 .astype(np.float32)),
        traj_inv_actions=t(np.zeros((W, A, 1, C.ACTION_DIM), np.float32)),
    )
    rvalid = np.ones((W, R), bool)
    roads = RoadGraph(pos=t(g["pos"]), yaw=t(g["yaw"]), scale=t(g["scale"]),
                      etype=t(g["etype"].astype(np.int32)),
                      rid=t(np.zeros((W, R), np.int32)),
                      map_type=t(np.zeros((W, R), np.int32)), valid=t(rvalid))
    scene = Scene(
        agents=agents, roads=roads,
        num_agents=t(np.full(W, n_active, np.int32)),
        num_roads=t(np.full(W, R, np.int32)),
        means=t(np.zeros((W, 3), np.float32)),
        map_name=t(np.zeros((W, 32), np.int32)),
        scenario_id=t(np.zeros((W, 32), np.int32)),
        grid=build_collision_grid(
            [({"pos": g["pos"][w], "yaw": g["yaw"][w],
               "scale": g["scale"][w]}, R) for w in range(W)],
            device=device) if grid else None,
        rtiles=build_road_tiles(g["pos"], g["yaw"], g["scale"], g["etype"],
                                rvalid, device=device),
    )
    state = SimState(
        pos=t(ag[..., 0:2]), z=t(np.ones((W, A), np.float32)), yaw=t(yaw),
        vel=t(np.zeros((W, A, 2), np.float32)), ang_vel=t(zf),
        collided=t(zi), done=t(zi), collided_road=t(zi),
        collided_vehicle=t(zi), collided_non_vehicle=t(zi),
        reached_goal=t(zi), steps_remaining=t(np.full((W, A), 91, np.int32)),
        reward=t(zf),
    )
    return scene, state, torch.zeros((W, A), dtype=torch.int32,
                                     device=device)

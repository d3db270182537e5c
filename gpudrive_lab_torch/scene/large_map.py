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
step's own ``core/collision.tile_mask_and_order``.
"""

from __future__ import annotations

import types
from dataclasses import dataclass

import numpy as np
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.collision import tile_mask_and_order
from gpudrive_lab_torch.core.types import RoadTiles
from gpudrive_lab_torch.device import resolve_device
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


def large_map(W: int, A: int, R: int, n_active: int, side: float = 400.0,
              seed: int = 0, device=None) -> LargeMap:
    """Build the map (R a multiple of 256, A of 16, n_active <= A) on
    ``device``: CUDA unless the caller names another."""
    if R % ROAD_TILE or R % SEGMENTS_PER_POLYLINE or A % 16 or n_active > A:
        raise ValueError(f"W={W} A={A} R={R} n_active={n_active}")
    device = resolve_device(device)
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
    rt = build_road_tiles(pos, yaw.astype(np.float32), scale, etype,
                          np.ones((W, R), bool), device=device)

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
    feat = torch.from_numpy(agents).to(device)

    T = R // ROAD_TILE
    roads_t = rt.feat.permute(0, 2, 1, 3).reshape(W, 8, R).contiguous()
    feat_s, mask, inv_perm = tile_mask_and_order(
        types.SimpleNamespace(rtiles=rt),
        types.SimpleNamespace(pos=feat[..., 0:2]), feat)
    params = dict(W=W, A=A, R=R, T=T, n_active=n_active, side=side,
                  seed=seed, edges=float((etype == C.ET_ROAD_EDGE).mean()),
                  stop_signs=int(stop.sum()))
    return LargeMap(feat, roads_t, rt, feat_s.contiguous(), mask, inv_perm,
                    params)

"""Collision-grid construction (port of ``gpudrive_lab_tpu/scene/grid.py``).

Host-side construction of the scene-static spatial hash
(core/types.CollisionGrid), a stand-in for the reference's broadphase BVH:
built once per scene batch by the compiler; the step gathers each agent's
cell row and runs the narrow phase against only those candidates
(core/collision.py).

A collision pass with the grid costs more than dense K2 on the pool worlds
and on the synthetic large map, so dense stays the default; the card's
times per pass and the build's host seconds, from chip_smoke.py's collision
phase, are in PERF.md §6.

Correctness invariant: every road entity whose oriented box can overlap an
agent box whose center lies in a cell MUST be listed in that cell.  Each road
entity is registered with every cell that its axis-aligned bounding box,
expanded by the largest agent half-diagonal plus slack, touches.  Cells never
overflow: the per-cell capacity K is the batch's largest cell.

The registration is vectorised: one (cell, road) pair per registration,
then a stable sort by cell, so each cell lists its roads in ascending order,
as the JAX package's loops append them.  The table is bit for bit the JAX
package's (tests/test_torch_collision_paths.py).
"""

from __future__ import annotations

import numpy as np
import torch

from gpudrive_lab_torch.core.types import CollisionGrid
from gpudrive_lab_torch.device import resolve_device

# Maximum agent half-diagonal: the obs bounds cap vehicles at 30m x 15m and
# collision boxes are scaled by 0.7, so 0.5*0.7*sqrt(30^2+15^2) = 11.74m.
AGENT_RADIUS_MARGIN = 12.0


def _road_aabbs(road: dict, n: int):
    """Axis-aligned bounds of each road entity's oriented box."""
    pos = road["pos"][:n, :2]
    yaw = road["yaw"][:n]
    half = road["scale"][:n, :2]
    c, s = np.abs(np.cos(yaw)), np.abs(np.sin(yaw))
    ex = half[:, 0] * c + half[:, 1] * s
    ey = half[:, 0] * s + half[:, 1] * c
    lo = pos - np.stack([ex, ey], -1)
    hi = pos + np.stack([ex, ey], -1)
    return lo, hi


def _world_pairs(road: dict, num_roads: int, cell_size: float):
    """(origin [2] f32, (gx, gy), cell [P], road [P]): one pair per
    registration, sorted by cell index ``cy * gx + cx`` and, within a cell,
    by road index."""
    if num_roads == 0:
        empty = np.zeros(0, np.int64)
        return np.zeros(2, np.float32), (1, 1), empty, empty
    lo, hi = _road_aabbs(road, num_roads)
    lo = lo - AGENT_RADIUS_MARGIN
    hi = hi + AGENT_RADIUS_MARGIN
    origin = lo.min(axis=0)
    extent = hi.max(axis=0) - origin
    gx = max(1, int(np.ceil(extent[0] / cell_size)))
    gy = max(1, int(np.ceil(extent[1] / cell_size)))
    ilo = np.clip(((lo - origin) / cell_size).astype(int), 0, [gx - 1, gy - 1])
    ihi = np.clip(((hi - origin) / cell_size).astype(int), 0, [gx - 1, gy - 1])
    nx = ihi[:, 0] - ilo[:, 0] + 1
    ny = ihi[:, 1] - ilo[:, 1] + 1
    n = nx * ny  # cells per road
    r = np.repeat(np.arange(num_roads), n)
    k = np.arange(int(n.sum())) - np.repeat(np.cumsum(n) - n, n)
    cx = ilo[r, 0] + k // ny[r]
    cy = ilo[r, 1] + k % ny[r]
    cell = cy * gx + cx
    order = np.argsort(cell, kind="stable")
    return origin.astype(np.float32), (gx, gy), cell[order], r[order]


def _road_of(world):
    """(road dict, num_roads) of a CompiledWorld or of a (road, n) pair;
    the dict needs "pos" [R, >=2], "yaw" [R] and "scale" [R, >=2]."""
    if hasattr(world, "road"):
        return world.road, world.num_roads
    road, n = world
    return road, int(n)


def build_world_grid(road: dict, num_roads: int, cell_size: float = 50.0):
    """Returns (origin [2], dims (gx, gy), cells): ``cells[cy * gx + cx]``
    is the ascending int array of the road indices registered there."""
    origin, (gx, gy), cell, r = _world_pairs(road, num_roads, cell_size)
    bounds = np.searchsorted(cell, np.arange(1, gx * gy))
    return origin, (gx, gy), np.split(r, bounds)


def build_collision_grid(worlds, cell_size: float = 50.0,
                         device=None) -> CollisionGrid:
    """Stack per-world grids, padded to common dims and capacity, on
    ``device`` (CUDA unless the caller names another).  Each world is a
    CompiledWorld or a (road dict, num_roads) pair."""
    device = resolve_device(device)
    per = [_world_pairs(*_road_of(w), cell_size) for w in worlds]
    gx = max(p[1][0] for p in per)
    gy = max(p[1][1] for p in per)
    k = max((int(np.bincount(p[2]).max()) if p[2].size else 0)
            for p in per)
    k = max(k, 1)
    W = len(per)
    table = np.full((W, gy, gx, k), -1, np.int32)
    origin = np.zeros((W, 2), np.float32)
    dims = np.zeros((W, 2), np.int32)
    for w, (o, (pgx, pgy), cell, r) in enumerate(per):
        origin[w] = o
        dims[w] = (pgx, pgy)
        slot = np.arange(cell.size) - np.searchsorted(cell, cell)
        table[w, cell // pgx, cell % pgx, slot] = r
    return CollisionGrid(
        origin=torch.from_numpy(origin).to(device),
        cell_size=torch.full((W,), cell_size, dtype=torch.float32,
                             device=device),
        dims=torch.from_numpy(dims).to(device),
        table=torch.from_numpy(table).to(device),
    )

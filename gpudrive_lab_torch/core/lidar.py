"""Lidar observation (port of ``gpudrive_lab_tpu/core/lidar.py``;
reference: src/sim.cpp:394-460).

Per agent, 3 height planes x S rays over a 120-degree cone centred on the
heading.  Each ray is tested against every road and every other agent with
the oriented-slab test of ``_ray_box_t`` and keeps its nearest hit.  A plane
only sees the entities whose z-extent holds its height (reference:
src/consts.hpp:42-44): the cars plane sees agents and stop signs, the
road-edge plane adds road edges, the road-line plane sees lines, lanes,
crosswalks and speed bumps.  A sample is [depth, type, hit_x, hit_y], the
hit position in the ego ray frame (src/types.hpp:296-313).

Memory.  XLA fuses the slab test into one pass, so the JAX package sizes
its world groups by the output of that pass alone.  Eager PyTorch writes
every intermediate to memory: about ten [rows, S, R] float32 tensors are
alive at once inside ``_ray_box_t``.  So the port computes only the rows of
created agents (``agents.valid``; the other rows are zero, as in the JAX
function) and takes them in groups whose [rows, S, E] lattice holds at most
``GROUP_ELEMS`` elements: 2**26 (256 MiB a tensor, so at most about 3 GiB
of workspace for a group).  At 512 worlds x 128 rows x R = 256 the 4,372 created agents
fit in one group.  ``world_group`` groups the rows by worlds instead and
``road_chunk`` reduces the road axis in chunks; every grouping gives the
dense result bit for bit, because each row's arithmetic is the same.
"""

from __future__ import annotations

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.rows import Rows
from gpudrive_lab_torch.core.types import Params, Scene, SimState

PLANE_OFFSETS = (
    C.LIDAR_CAR_OFFSET,
    C.LIDAR_ROAD_EDGE_OFFSET,
    C.LIDAR_ROAD_LINE_OFFSET,
)

# Elements of one [rows, S, entities] lattice tensor in a group of rows.
GROUP_ELEMS = 2**26

_INF = float("inf")


def _ray_box_t(origin, dir_xy, box_pos, box_yaw, box_half):
    """First positive intersection parameter of rays with 2-D OBBs (slab
    test in the box frame); inf when missed.  Shapes broadcast:
    origin/dir [..., 2], box_pos/box_half [..., 2], box_yaw [...]."""
    c = torch.cos(box_yaw)
    s = torch.sin(box_yaw)
    rel = origin - box_pos
    ox = c * rel[..., 0] + s * rel[..., 1]
    oy = -s * rel[..., 0] + c * rel[..., 1]
    dx = c * dir_xy[..., 0] + s * dir_xy[..., 1]
    dy = -s * dir_xy[..., 0] + c * dir_xy[..., 1]

    eps = 1e-9
    dx = torch.where(dx.abs() < eps, eps, dx)
    dy = torch.where(dy.abs() < eps, eps, dy)

    tx1 = (-box_half[..., 0] - ox) / dx
    tx2 = (box_half[..., 0] - ox) / dx
    ty1 = (-box_half[..., 1] - oy) / dy
    ty2 = (box_half[..., 1] - oy) / dy

    tmin = torch.maximum(torch.minimum(tx1, tx2), torch.minimum(ty1, ty2))
    tmax = torch.minimum(torch.maximum(tx1, tx2), torch.maximum(ty1, ty2))
    hit = (tmax >= tmin) & (tmax > 0.0) & (tmin > 0.0)
    return torch.where(hit, tmin, _INF)


def _nearest(t, ok, etype):
    """Per plane, the nearest hit of t [n, S, E] among the entities that
    ok [n, 3, E] admits: (best_t [n, 3, S], best_type [n, 3, S]).  The
    first index wins a tie, as ``jnp.argmin``."""
    best_t, best_ty = [], []
    for p in range(ok.shape[1]):
        v, i = torch.where(ok[:, p, None, :], t, _INF).min(dim=-1)
        best_t.append(v)
        best_ty.append(torch.gather(etype, 1, i))
    return torch.stack(best_t, 1), torch.stack(best_ty, 1)


def _z_ok(plane_z, lo, hi, valid):
    """[n, 3, E]: the plane height lies within the entity's z-extent."""
    pz = plane_z[:, :, None]
    return (pz >= lo[:, None, :]) & (pz <= hi[:, None, :]) & valid[:, None, :]


def _lidar_rows(rows, scene, state, actions, S, road_chunk, n_roads, n_agents):
    """[n, 3, S, 4] samples of the flat agent rows ``rows`` [n] (w * A + a),
    against the first ``n_roads`` roads and ``n_agents`` agent rows of
    their worlds (the others are invalid in every world of the group)."""
    A = state.pos.shape[1]
    dev = state.pos.device
    w, a = rows // A, rows % A
    roads, agents = scene.roads, scene.agents

    spos, syaw, sz = state.pos[w, a], state.yaw[w, a], state.z[w, a]
    head = torch.where(agents.controlled[w, a], actions[w, a, 2], 0.0)
    idx = torch.arange(S, dtype=torch.float32, device=dev)
    theta = C.LIDAR_ANGLE * (2.0 * idx / S - 1.0)
    theta = theta[None, :] + head[:, None]  # [n, S]
    # Cone centred on the heading: the box x-axis (vehicle length axis) is
    # the madrona `right` vector in sim.cpp:403-414.
    ray_yaw = syaw[:, None] + theta
    dir_xy = torch.stack([torch.cos(ray_yaw), torch.sin(ray_yaw)], dim=-1)
    origin = spos[:, None, None, :]  # [n, 1, 1, 2]
    dirs = dir_xy[:, :, None, :]  # [n, S, 1, 2]
    plane_z = sz[:, None] + torch.tensor(PLANE_OFFSETS, dtype=torch.float32,
                                         device=dev)  # [n, 3]

    # --- road entities, in chunks of the road axis; an earlier chunk wins
    # a tie (strict <), which is the dense first-index argmin
    R = n_roads
    chunk = road_chunk or R
    road_t = road_ty = None
    for r0 in range(0, R, chunk):
        sl = slice(r0, min(r0 + chunk, R))
        rpos = roads.pos[w, sl]
        rscale = roads.scale[w, sl]
        ok = _z_ok(plane_z, rpos[..., 2] - rscale[..., 2],
                   rpos[..., 2] + rscale[..., 2], roads.valid[w, sl])
        t = _ray_box_t(origin, dirs, rpos[:, None, :, 0:2],
                       roads.yaw[w, sl][:, None, :],
                       rscale[:, None, :, 0:2])  # [n, S, chunk]
        c_t, c_ty = _nearest(t, ok, roads.etype[w, sl])
        del t
        if road_t is None:
            road_t, road_ty = c_t, c_ty
        else:
            upd = c_t < road_t
            road_t = torch.where(upd, c_t, road_t)
            road_ty = torch.where(upd, c_ty, road_ty)

    # --- other agents
    An = n_agents
    apos, ayaw, az = state.pos[w, :An], state.yaw[w, :An], state.z[w, :An]
    half = agents.size[w, :An, 0:2] * (0.5 * C.VEHICLE_LENGTH_SCALE)
    not_self = torch.arange(An, device=dev)[None, :] != a[:, None]
    ok = _z_ok(plane_z, az - 0.7, az + 0.7, agents.valid[w, :An] & not_self)
    t = _ray_box_t(origin, dirs, apos[:, None], ayaw[:, None],
                   half[:, None])  # [n, S, An]
    agent_t, agent_ty = _nearest(t, ok, agents.etype[w, :An])
    del t

    # --- nearest hit: the road term wins a tie (the lower concatenated
    # index of the dense argmin)
    agent_wins = agent_t < road_t
    best = torch.where(agent_wins, agent_t, road_t)
    best_type = torch.where(agent_wins, agent_ty, road_ty)
    hit = best <= C.LIDAR_DISTANCE
    depth = torch.where(hit, best, 0.0)
    etype = torch.where(hit, best_type.to(torch.float32), 0.0)
    # local hit position depth * (cos theta, sin theta)
    # (reference: src/sim.cpp:433-435)
    local = depth[..., None] * torch.stack(
        [torch.cos(theta), torch.sin(theta)], dim=-1)[:, None]
    return torch.cat([depth[..., None], etype[..., None], local], dim=-1)


def lidar_observation(
    scene: Scene,
    state: SimState,
    params: Params,
    actions: torch.Tensor,
    road_chunk: int | None = None,
    world_group: int | None = None,
    num_samples: int = C.NUM_LIDAR_SAMPLES,
) -> torch.Tensor:
    """[W, A, 3, S, 4] lidar samples.  ``actions`` [W, A, >=3] supplies
    the head angle of controlled agents (src/sim.cpp:409-410).

    Rows of agents that were not created are zero.  ``world_group`` takes
    the created agents that many worlds at a time; ``road_chunk`` reduces
    the road axis in chunks of that many roads; by default the rows go in
    groups of ``GROUP_ELEMS`` lattice elements."""
    W, A = state.pos.shape[:2]
    S = num_samples
    R = scene.roads.valid.shape[1]
    out = torch.zeros((W * A, 3, S, 4), dtype=torch.float32,
                      device=state.pos.device)
    rows = Rows(scene)
    per_group = max(1, GROUP_ELEMS // (S * max(min(road_chunk or R, R), A)))
    for g in rows.groups(per_group, world_group):
        r = rows.idx[g]
        out[r] = _lidar_rows(r, scene, state, actions, S, road_chunk,
                             *rows.extents(g))
    return out.view(W, A, 3, S, 4)

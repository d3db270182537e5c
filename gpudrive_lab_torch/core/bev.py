"""Birds-eye-view observation (port of ``gpudrive_lab_tpu/core/bev.py``;
reference: src/rasterizer.hpp:27-78 driven by src/sim.cpp:462-555).

Each agent gets a 200 x 200 grid of entity-type ids over a (2 * radius)^2
square in its own frame: the grid rotates with the agent.  The reference
paints rectangles and lets later writes win: first the first
K = kMaxAgentMapObservationsCount roads within the radius, in entity order,
then every other agent.  Here every cell tests coverage against every
candidate entity and keeps the last one that covers it (the highest paint
index), which is the same composition as a reduction.

Cost.  A cell's offset from an entity, rotated into the entity's frame, is
``d0 * c - d1 * s`` with d0 the cell's x offset and d1 its y offset; both
products depend on one grid axis only.  So the products are formed per
[row, 200, E] and only the sum, the two comparisons and the index
reduction run over the [row, 200, 200, E] lattice; every value is the one
the JAX function computes.  Only created agents are rasterized (the other
rows are zero, as in the JAX function), in groups of rows whose lattice
holds at most ``GROUP_ELEMS`` elements: 2**27, so at most about 1.7 GiB
of workspace at the 13 bytes an element that are alive at once.  The entity axis of a
group stops at the last valid road (or agent) of its worlds.

``agent_chunk=0`` selects ``_bev_dense_rows``: the same raster against all
R roads, without the first-K gather; the tests' oracle.
"""

from __future__ import annotations

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.geometry import quat_yaw_diff, rotate_into_frame
from gpudrive_lab_torch.core.rows import Rows
from gpudrive_lab_torch.core.types import Params, Scene, SimState, vec_norm

GROUP_ELEMS = 2**27


def cell_coords(res: int, radius: float, device) -> torch.Tensor:
    """[res] cell-centre coordinates along one axis of the ego frame
    (reference: src/rasterizer.hpp:60-62): cell (i, j) lies at
    (x, y) = (coords[j], coords[i])."""
    scale_px = 2.0 * radius / res
    return torch.arange(res, dtype=torch.float32, device=device) * scale_px \
        - radius


def _last_cover(coords, rel_pos, rel_yaw, half_l, half_w, ok):
    """[n, res, res] index of the last entity that covers each cell, -1
    for none.  rel_pos [n, E, 2], rel_yaw / half_l / half_w / ok [n, E]."""
    E = rel_pos.shape[1]
    c = torch.cos(-rel_yaw)[:, None, :]  # [n, 1, E]
    s = torch.sin(-rel_yaw)[:, None, :]
    d0 = coords[None, :, None] - rel_pos[:, None, :, 0]  # [n, res(j), E]
    d1 = coords[None, :, None] - rel_pos[:, None, :, 1]  # [n, res(i), E]
    eps = 1e-3
    hl = (half_l + eps)[:, None, None, :]
    hw = (half_w + eps)[:, None, None, :]
    # lx = d0 * c - d1 * s, ly = d0 * s + d1 * c over [n, i, j, E]
    lx = (d0 * c)[:, None, :, :] - (d1 * s)[:, :, None, :]
    cov = lx.abs_() <= hl
    del lx
    ly = (d0 * s)[:, None, :, :] + (d1 * c)[:, :, None, :]
    cov &= ly.abs_() <= hw
    del ly
    cov &= ok[:, None, None, :]
    dtype = torch.uint8 if E < 255 else torch.int16 if E < 32767 \
        else torch.int32
    order = torch.arange(1, E + 1, device=coords.device).to(dtype)
    return (cov.to(dtype) * order).amax(dim=-1).long() - 1


def _agent_paint(scene, state, w, a, n_agents, radius, coords):
    """(best index [n, res, res], agent types [n, An]) of the other agents
    of each row's world, at full length and width (src/sim.cpp:544-553)."""
    agents = scene.agents
    An = n_agents
    apos, ayaw = state.pos[w, a], state.yaw[w, a]
    rel = rotate_into_frame(state.pos[w, :An] - apos[:, None, :],
                            ayaw[:, None])
    rel_yaw = quat_yaw_diff(ayaw[:, None], state.yaw[w, :An])
    not_self = torch.arange(An, device=coords.device)[None, :] != a[:, None]
    ok = agents.valid[w, :An] & not_self & (vec_norm(rel) <= radius)
    best = _last_cover(coords, rel, rel_yaw, agents.size[w, :An, 0] / 2.0,
                       agents.size[w, :An, 1] / 2.0, ok)
    return best, agents.etype[w, :An]


def _compose(best_road, road_types, best_agent, agent_types):
    """Last writer wins: any covering agent (paint index R + a) over any
    road; 0 where nothing covers."""
    n = best_road.shape[0]
    road = torch.gather(road_types, 1, best_road.clamp(min=0).view(n, -1))
    agent = torch.gather(agent_types, 1,
                         best_agent.clamp(min=0).view(n, -1))
    road = torch.where(best_road.view(n, -1) >= 0, road, 0)
    return torch.where(best_agent.view(n, -1) >= 0, agent, road)


def _first_k(scene, state, w, a, radius, K):
    """[n, K] ascending indices of the first K roads within the radius
    (R where fewer), exactly (sim.cpp:497-505)."""
    roads = scene.roads
    R = roads.valid.shape[1]
    dist = vec_norm(roads.pos[w, :, 0:2] - state.pos[w, a][:, None, :])
    within = roads.valid[w] & (dist <= radius)
    rank = torch.cumsum(within, dim=-1) - 1
    painted = within & (rank < K)
    ar = torch.arange(R, device=dist.device)
    keys = torch.where(painted, ar, R)
    return torch.sort(keys, dim=-1).values[:, :K]


def bev_observation(
    scene: Scene,
    state: SimState,
    params: Params,
    agent_chunk: int | None = None,
) -> torch.Tensor:
    """[W, A, RES, RES, 1] float type-id grid (export layout of
    bev_observation_tensor).  ``agent_chunk``: rows rasterized per group
    (None sizes the groups to ``GROUP_ELEMS``); 0 selects the dense path
    without the first-K road gather."""
    res = C.BEV_RESOLUTION
    radius = params.observation_radius
    roads = scene.roads
    W, A = state.pos.shape[:2]
    R = roads.valid.shape[1]
    dev = state.pos.device
    coords = cell_coords(res, radius, dev)
    out = torch.zeros((W * A, res * res), dtype=torch.float32, device=dev)
    rows = Rows(scene)
    K = min(C.MAX_AGENT_MAP_OBS, R)
    min_w = 2.0 * radius / res
    if not len(rows):
        return out.view(W, A, res, res, 1)

    if agent_chunk == 0:
        width = max(max(rows.road_ext), max(rows.agent_ext), 1)
        for g in rows.groups(max(1, GROUP_ELEMS // (res * res * width))):
            r, w, a = rows.split(g)
            out[r] = _bev_dense_rows(scene, state, w, a, *rows.extents(g),
                                     radius, K, min_w, coords)
        return out.view(W, A, res, res, 1)

    # first-K within-radius roads of every row, and how many of them live
    _, w_all, a_all = rows.split(slice(None))
    idx = _first_k(scene, state, w_all, a_all, radius, K)  # [N, K]
    n_live = (idx < R).sum(-1).tolist()
    width = max(max(n_live), max(rows.agent_ext), 1)
    per = agent_chunk or max(1, GROUP_ELEMS // (res * res * width))
    for g in rows.groups(per):
        r, w, a = rows.split(g)
        gidx = idx[g, :max(1, max(n_live[g]))]
        live = gidx < R
        gidx = gidx.clamp(max=R - 1)
        apos, ayaw = state.pos[w, a], state.yaw[w, a]
        rpos = roads.pos[w[:, None], gidx][..., 0:2]  # [n, K, 2]
        rscale = roads.scale[w[:, None], gidx]
        rel = rotate_into_frame(rpos - apos[:, None, :], ayaw[:, None])
        rel_yaw = quat_yaw_diff(ayaw[:, None], roads.yaw[w[:, None], gidx])
        # Min segment width (src/sim.cpp:507-510).  The reference passes
        # the MapObservation scale (already half-extents) to a rasterizer
        # that halves again (rasterizer.hpp:37-38), so roads paint at half
        # their true extent; kept as the reference has it.
        best_k = _last_cover(coords, rel, rel_yaw, rscale[..., 0] / 2.0,
                             rscale[..., 1].clamp(min=min_w) / 2.0, live)
        best_a, a_types = _agent_paint(scene, state, w, a,
                                       rows.extents(g)[1], radius, coords)
        out[r] = _compose(best_k, roads.etype[w[:, None], gidx], best_a,
                          a_types).to(torch.float32)
    return out.view(W, A, res, res, 1)


def _bev_dense_rows(scene, state, w, a, n_roads, n_agents, radius, K, min_w,
                    coords):
    """[n, res * res] cell types of rows (w, a) against all roads: the
    first K within the radius (measured in the ego frame), in entity
    order, then the other agents."""
    roads = scene.roads
    Rn = n_roads
    apos, ayaw = state.pos[w, a], state.yaw[w, a]
    rel = rotate_into_frame(roads.pos[w, :Rn, 0:2] - apos[:, None, :],
                            ayaw[:, None])
    rel_yaw = quat_yaw_diff(ayaw[:, None], roads.yaw[w, :Rn])
    within = roads.valid[w, :Rn] & (vec_norm(rel) <= radius)
    painted = within & (torch.cumsum(within, dim=-1) - 1 < K)
    rscale = roads.scale[w, :Rn]
    best_r = _last_cover(coords, rel, rel_yaw, rscale[..., 0] / 2.0,
                         rscale[..., 1].clamp(min=min_w) / 2.0, painted)
    best_a, a_types = _agent_paint(scene, state, w, a, n_agents, radius,
                                   coords)
    return _compose(best_r, roads.etype[w, :Rn], best_a,
                    a_types).to(torch.float32)

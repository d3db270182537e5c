"""Observation collectors (port of ``gpudrive_lab_tpu/core/observations.py``).

Batched replacements for the reference's per-agent observation systems
(reference: src/sim.cpp:168-280; src/knn.hpp).  Each function returns the
export layout of the reference's tensor.  The ego axis is every agent row
of every world, or a compacted selection of them (``ego_idx``, the PPO
learner's compaction): a per-world index [W, C] or a flat
``(w_idx [N], a_idx [N])`` pair of index vectors across worlds.

The K-nearest road selection is one exact ``torch.topk`` over the [W, A, R]
squared-distance lattice (the JAX package's ``approx_top_k`` flag selects
the same exact top-K here).  The candidate order inside K is unspecified, as
in the reference: the policy max-pools over the road entities.
"""

from __future__ import annotations

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.geometry import quat_yaw_diff, rotate_into_frame
from gpudrive_lab_torch.core.types import (
    Params,
    RoadObsAlgorithm,
    Scene,
    SimState,
    vec_norm,
)


def _ego_take(x: torch.Tensor, ego_idx) -> torch.Tensor:
    """Gather ego rows of a per-agent tensor x [W, A, ...] (identity when
    ego_idx is None).  Two layouts:

      * [W, C] per-world slot index -> [W, C, ...] (world compaction);
      * (w_idx [N], a_idx [N]) -> [N, ...] (flat compaction: the ego axis
        holds exactly the selected (world, agent) pairs of the batch)."""
    if ego_idx is None:
        return x
    if isinstance(ego_idx, tuple):
        w_idx, a_idx = ego_idx
        return x[w_idx.long(), a_idx.long()]
    idx = ego_idx.long().reshape(ego_idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(ego_idx.shape + x.shape[2:]))


def self_observation(scene: Scene, state: SimState,
                     ego_idx=None) -> torch.Tensor:
    """[W, A, 8]: speed, size(3), ego-frame rel goal(2), collision, id
    (reference: src/sim.cpp:168-186; layout src/types.hpp:189-208).
    Padding rows are SelfObservation::zero() (id = -1).  ego_idx
    restricts the rows to the selected egos (see ``_ego_take``)."""
    agents = scene.agents
    sel = lambda x: _ego_take(x, ego_idx)
    rel_goal = rotate_into_frame(sel(agents.goal) - sel(state.pos),
                                 sel(state.yaw))
    obs = torch.cat(
        [
            sel(state.speed)[..., None],
            sel(agents.size),
            rel_goal,
            (sel(state.collided) != 0).to(torch.float32)[..., None],
            sel(agents.aid).to(torch.float32)[..., None],
        ],
        dim=-1,
    )
    zero = torch.zeros_like(obs)
    zero[..., 7] = -1.0
    return torch.where(sel(agents.valid)[..., None], obs, zero)


def partner_observations(
    scene: Scene, state: SimState, params: Params, ego_idx=None,
    with_static: bool = False,
):
    """[W, A, A-1, 9]: speed, ego-frame rel pos(2), rel heading, size(3),
    type, id (reference: src/sim.cpp:188-240).  Out-of-radius partners are
    zeroed with id=-1; never-created slots get id=-2; rows of padded ego
    agents are all zero()/id=-1 (src/level_gen.cpp:322-325).

    Slot k of ego i reads agent k + (k >= i) (the OtherAgents wiring,
    src/level_gen.cpp:450-464), built as two slices of the packed per-agent
    columns blended by k < i.  ego_idx restricts the ego axis (see
    ``_ego_take``); partners still span all other agents of the ego's world.

    with_static=True also returns the other agent's raw static flag
    [W, A, A-1] bool (unmasked), which the partner mask needs."""
    agents = scene.agents
    A = state.pos.shape[1]
    dev = state.pos.device
    k = torch.arange(A - 1, device=dev)
    esel = lambda x: _ego_take(x, ego_idx)

    cols = [
        state.pos,                                       # 0:2
        state.speed[..., None],                          # 2
        state.yaw[..., None],                            # 3
        agents.size,                                     # 4:7
        agents.etype.to(torch.float32)[..., None],       # 7
        agents.aid.to(torch.float32)[..., None],         # 8
    ]
    if with_static:
        cols.append(agents.static.to(torch.float32)[..., None])  # 9
    packed = torch.cat(cols, dim=-1)  # [W, A, 9(+1)]
    if ego_idx is None:  # [W, A, A-1, 9(+1)]
        keep = (k[None, :] < torch.arange(A, device=dev)[:, None])
        sel_p = torch.where(keep[None, ..., None], packed[:, None, : A - 1],
                            packed[:, None, 1:])
    elif isinstance(ego_idx, tuple):  # [N, A-1, 9(+1)]
        w_idx, a_idx = ego_idx
        full = packed[w_idx.long()]
        keep = (k[None, :] < a_idx[:, None])[..., None]
        sel_p = torch.where(keep, full[:, : A - 1], full[:, 1:])
    else:  # [W, C, A-1, 9(+1)]
        keep = (k[None, None, :] < ego_idx[..., None])[..., None]
        sel_p = torch.where(keep, packed[:, None, : A - 1],
                            packed[:, None, 1:])
    o_pos = sel_p[..., 0:2]
    o_yaw = sel_p[..., 3]

    ego_yaw = esel(state.yaw)
    rel_ego = rotate_into_frame(
        o_pos - esel(state.pos)[..., None, :], ego_yaw[..., None]
    )
    dist = vec_norm(rel_ego)
    rel_heading = quat_yaw_diff(ego_yaw[..., None], o_yaw)

    obs = torch.cat(
        [
            sel_p[..., 2:3],
            rel_ego,
            rel_heading[..., None],
            sel_p[..., 4:7],
            sel_p[..., 7:8],
            sel_p[..., 8:9],
        ],
        dim=-1,
    )  # [W, A, A-1, 9]

    in_radius = dist <= params.observation_radius
    obs = torch.where(in_radius[..., None], obs, 0.0)

    # Existing-slot predicate: slot k valid iff k < numAgents-1
    # (src/sim.cpp:199,236-239).
    if isinstance(ego_idx, tuple):
        n_ag = scene.num_agents[ego_idx[0].long()]
        exists = k[None, :] < (n_ag[:, None] - 1)
    else:
        exists = k[None, None, :] < (scene.num_agents[:, None, None] - 1)
    id_col = torch.where(
        exists,
        torch.where(in_radius, obs[..., 8], torch.full_like(obs[..., 8], -1.0)),
        torch.full_like(obs[..., 8], -2.0),
    )
    obs = torch.where(exists[..., None], obs, 0.0)
    obs = torch.cat([obs[..., :8], id_col[..., None]], dim=-1)

    # Padded ego rows: PartnerObservation::zero() everywhere (id = -1).
    zero_row = torch.where(torch.arange(9, device=dev) == 8, -1.0, 0.0)
    obs = torch.where(esel(agents.valid)[..., None, None], obs, zero_row)
    if with_static:
        return obs, sel_p[..., 9] > 0.5
    return obs


def _packed_road_columns(roads) -> torch.Tensor:
    """[W, R, 10] attribute pack: pos(2), scale(3), yaw, type, id, mapType,
    valid.  One gather of the pack fetches every attribute of the winners;
    the values are small ints or floats, exact in f32."""
    return torch.cat(
        [
            roads.pos[..., 0:2],
            roads.scale,
            roads.yaw[..., None],
            roads.etype.to(torch.float32)[..., None],
            roads.rid.to(torch.float32)[..., None],
            roads.map_type.to(torch.float32)[..., None],
            roads.valid.to(torch.float32)[..., None],
        ],
        dim=-1,
    )


def _gather_road_features(packed, idx, ego_pos, ego_yaw, w_idx=None):
    """Gather-then-compute: fetch the [..., K] winners' packed columns and
    only then build the 9-wide ego-frame MapObservation features.  Ego axes
    [W, A] per world (w_idx None) or flat [N] (w_idx [N] names each ego's
    world).  Returns (features [..., K, 9], world-frame d2 [..., K],
    valid [..., K])."""
    W, R, D = packed.shape
    flat = packed.reshape(W * R, D)
    if w_idx is not None:
        sel_p = flat[(w_idx.long()[:, None] * R + idx).long()]  # [N, K, 10]
    else:
        w_of = torch.arange(W, device=idx.device).reshape(
            (W,) + (1,) * (idx.dim() - 1))
        sel_p = flat[(w_of * R + idx).long()]  # [W, A, K, 10]
    rel = sel_p[..., 0:2] - ego_pos[..., None, :]
    rel_ego = rotate_into_frame(rel, ego_yaw[..., None])
    heading = quat_yaw_diff(ego_yaw[..., None], sel_p[..., 5])
    sel = torch.cat(
        [rel_ego, sel_p[..., 2:5], heading[..., None], sel_p[..., 6:9]],
        dim=-1,
    )
    sel_d2 = (rel * rel).sum(-1)
    return sel, sel_d2, sel_p[..., 9] > 0.5


def _map_filler(device) -> torch.Tensor:
    """MapObservation::zero(): zeros with id = mapType = -1.  Built by
    kernels: setting one element of a CUDA tensor from a Python number
    copies from the host and waits for the stream."""
    return torch.where(torch.arange(9, device=device) >= 7, -1.0, 0.0)


def agent_map_observations(
    scene: Scene, state: SimState, params: Params, ego_idx=None
) -> torch.Tensor:
    """[W, A, K, 9] ego-frame road observations; ego_idx restricts the ego
    axis (see ``_ego_take``), so the [W, A, R] distance lattice shrinks to
    the selected rows.

    KNEAREST: the K nearest road entities by ego distance, then a radius
    filter; the KNN filler is an all-zero row including id/mapType
    (reference: src/knn.hpp:19-28, 103-158).

    LINEAR: the first K entities (by index) within the radius, filled with
    MapObservation::zero() — id/mapType = -1 (reference: src/sim.cpp:259-280).
    """
    K = C.MAX_AGENT_MAP_OBS
    roads = scene.roads
    ego_pos = _ego_take(state.pos, ego_idx)
    ego_yaw = _ego_take(state.yaw, ego_idx)
    ego_valid = _ego_take(scene.agents.valid, ego_idx)
    dev = ego_pos.device
    if isinstance(ego_idx, tuple):
        w_idx = ego_idx[0].long()
        road_valid = roads.valid[w_idx]                # [N, R]
        road_pos = roads.pos[w_idx, :, 0:2]            # [N, R, 2]
    else:
        w_idx = None
        road_valid = roads.valid[:, None, :]           # [W, 1, R]
        road_pos = roads.pos[:, None, :, 0:2]          # [W, 1, R, 2]
    delta = road_pos - ego_pos[..., None, :]
    d2 = (delta * delta).sum(-1)                       # [..., R]
    R = d2.shape[-1]
    K_eff = min(K, R)
    packed = _packed_road_columns(roads)

    if params.road_obs_algorithm == RoadObsAlgorithm.KNEAREST:
        score = torch.where(road_valid, d2, torch.full_like(d2, float("inf")))
        # Fewer road entities than K: take them all and zero-fill
        # (reference: src/knn.hpp:122-126).
        idx = torch.topk(score, K_eff, dim=-1, largest=False).indices
        if K_eff < K:
            idx = torch.cat(
                [idx, idx.new_zeros(idx.shape[:-1] + (K - K_eff,))], dim=-1
            )
        sel, sel_d2, sel_valid = _gather_road_features(
            packed, idx, ego_pos, ego_yaw, w_idx
        )
        if K_eff < K:
            sel_valid = sel_valid & ~(torch.arange(K, device=dev) >= K_eff)
        keep = sel_valid & (sel_d2 <= params.observation_radius ** 2)
        out = torch.where(keep[..., None], sel, 0.0)
    else:
        # Slot j gets the (j+1)-th within-radius entity in entity order
        # (src/sim.cpp:259-280): the K smallest of key[r] = r if within the
        # radius else R.
        within = road_valid & (d2 <= params.observation_radius ** 2)
        ar = torch.arange(R, dtype=torch.int32, device=dev)
        key = torch.where(within, ar, torch.full_like(ar, R))
        idx = torch.topk(key, K_eff, dim=-1, largest=False).values
        if K_eff < K:
            idx = torch.cat(
                [idx, torch.full(idx.shape[:-1] + (K - K_eff,), R,
                                 dtype=idx.dtype, device=dev)],
                dim=-1,
            )
        filled = idx < R
        idx = torch.where(filled, idx, torch.zeros_like(idx))
        sel, _, _ = _gather_road_features(packed, idx, ego_pos, ego_yaw,
                                          w_idx)
        out = torch.where(filled[..., None], sel, _map_filler(dev))

    # Padded ego agents: MapObservation::zero() rows
    # (src/level_gen.cpp:315-318).
    return torch.where(ego_valid[..., None, None], out, _map_filler(dev))

"""Collision detection (port of ``gpudrive_lab_tpu/core/collision.py``).

Replaces the reference's broadphase BVH + narrow-phase OBB systems
(reference: src/sim.cpp:628-747) with masked all-pairs tests:

  * agent-agent: the [W, A, A] lattice of the closed-form SAT
    (core/obb.obb_overlap_sat), in plain PyTorch;
  * agent-road: kernel K2 (dense, core/kernels.agent_road_hits_dense) at the
    default road buckets, or kernel K1 (tile-skip,
    core/kernels.agent_road_hits_tiled) when the scene carries road tiles;
    or, when asked for, the road candidates of the agent's grid cell
    (``Params.use_collision_grid`` with ``Scene.grid``) or the K roads of
    least (center distance - half length) (``Params.collision_top_k``),
    each gathered and tested with the SAT in plain PyTorch, as the JAX
    package computes both in XLA outside its Pallas kernels.

Skip rules replicate isInvalidExpertOrDone (src/sim.cpp:631-666).  The
collision-pair whitelist (src/sim.hpp:88-102) reduces to: vehicles collide
only with RoadEdge/StopSign among road types; pedestrians/cyclists only with
StopSign; agent-agent pairs always collide.

Top-K is an approximation by design: a hit is missed when K or more roads
score below it.  ``approx_top_k`` selects the same exact ``torch.topk``; the
JAX package's ``lax.approx_max_k`` may drop a hit, which is not copied.
"""

from __future__ import annotations

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import obb
from gpudrive_lab_torch.core.kernels import (
    AGENT_BLOCK,
    agent_road_hits_dense,
    agent_road_hits_tiled,
)
from gpudrive_lab_torch.core.types import Params, Scene, SimState, vec_norm
from gpudrive_lab_torch.scene.rtiles import MORTON_CELLS, morton_interleave
from gpudrive_lab_torch.utils.profiling import span


def agent_half_extents(scene: Scene) -> torch.Tensor:
    """Collision box half extents: (len/2, wid/2) * 0.7
    (reference: src/level_gen.cpp:140-141)."""
    return scene.agents.size[..., 0:2] * (0.5 * C.VEHICLE_LENGTH_SCALE)


def _skip_mask(scene: Scene, state: SimState, cur_step: torch.Tensor):
    """Agents invisible to collision detection (src/sim.cpp:631-666), and
    padded (never-created) agents."""
    traj_valid_now = torch.gather(
        scene.agents.traj_valid, -1, cur_step[..., None].long()
    )[..., 0]
    agents = scene.agents
    uncontrolled_invalid = (~agents.controlled) & (traj_valid_now == 0)
    done_not_collided = (
        agents.controlled & (state.done != 0) & (state.collided == 0)
    )
    return (~agents.valid) | uncontrolled_invalid | done_not_collided


def _road_allowed(agent_etype, road_etype):
    """Complement of the collision-pair whitelist for agent-road pairs
    (reference: src/sim.hpp:88-102)."""
    is_vehicle = agent_etype == C.ET_VEHICLE
    veh_ok = (road_etype == C.ET_ROAD_EDGE) | (road_etype == C.ET_STOP_SIGN)
    other_ok = road_etype == C.ET_STOP_SIGN
    return torch.where(is_vehicle, veh_ok, other_ok)


def agent_features(scene: Scene, state: SimState, active, half):
    """[W, A, 8] kernel rows: px, py, cos, sin, half0, half1, active,
    is_vehicle (the Pallas kernel's packing, collision.py:84-94)."""
    is_veh = scene.agents.etype == C.ET_VEHICLE
    return torch.cat(
        [
            state.pos,
            torch.cos(state.yaw)[..., None],
            torch.sin(state.yaw)[..., None],
            half,
            active.to(torch.float32)[..., None],
            is_veh.to(torch.float32)[..., None],
        ],
        dim=-1,
    )


def road_features_t(scene: Scene) -> torch.Tensor:
    """[W, 8, R] kernel rows: px, py, cos, sin, half0, half1, allow_veh,
    allow_other.  The allow rows are the pair whitelist of
    ``_road_allowed`` for a vehicle and for another agent type, masked by
    ``roads.valid``."""
    roads = scene.roads
    et = roads.etype
    allow_veh = _road_allowed(torch.full_like(et, C.ET_VEHICLE), et)
    allow_other = _road_allowed(torch.full_like(et, C.ET_PEDESTRIAN), et)
    return torch.stack(
        [
            roads.pos[..., 0],
            roads.pos[..., 1],
            torch.cos(roads.yaw),
            torch.sin(roads.yaw),
            roads.scale[..., 0],
            roads.scale[..., 1],
            (allow_veh & roads.valid).to(torch.float32),
            (allow_other & roads.valid).to(torch.float32),
        ],
        dim=1,
    )


def tile_mask_and_order(scene: Scene, state: SimState, feat: torch.Tensor):
    """Morton-sort the agents and build the [agent-block, road-tile]
    reachability mask for K1 (collision.py:96-126).

    Returns (feat_s [W, A, 8] sorted rows, mask [W, A/16, T] int32,
    inv_perm [W, A] int64).  The mask is a conservative AABB distance bound,
    so K1 over it equals the dense SAT."""
    rt = scene.rtiles
    W, A, _ = feat.shape
    active = feat[..., 6] > 0.5
    q = torch.clamp(
        (state.pos - rt.world_min[:, None]) * rt.world_inv_ext[:, None]
        * MORTON_CELLS,
        0.0,
        MORTON_CELLS - 1.0,
    ).to(torch.int32)
    key = morton_interleave(q[..., 0]) | (morton_interleave(q[..., 1]) << 1)
    key = torch.where(active, key, torch.full_like(key, 1 << 30))
    perm = torch.argsort(key, dim=1, stable=True)  # jnp.argsort is stable
    inv_perm = torch.argsort(perm, dim=1)
    feat_s = torch.gather(feat, 1, perm[..., None].expand(-1, -1, feat.shape[2]))

    x = feat_s[..., 0:1]  # [W, A, 1]
    y = feat_s[..., 1:2]
    reach_a = torch.hypot(feat_s[..., 4], feat_s[..., 5])
    active_s = feat_s[..., 6] > 0.5
    b = rt.bounds  # [W, T, 6]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    dx = torch.maximum(
        torch.maximum(b[:, None, :, 0] - x, x - b[:, None, :, 2]), zero
    )
    dy = torch.maximum(
        torch.maximum(b[:, None, :, 1] - y, y - b[:, None, :, 3]), zero
    )
    limit = b[:, None, :, 4] + reach_a[..., None]
    near = (dx * dx + dy * dy <= limit * limit) & (b[:, None, :, 5] > 0.5)
    near = near & active_s[..., None]
    T = b.shape[1]
    mask = near.reshape(W, A // AGENT_BLOCK, AGENT_BLOCK, T).any(dim=2)
    return feat_s, mask.to(torch.int32).contiguous(), inv_perm


def _tiled_road_hits(scene: Scene, state: SimState, feat: torch.Tensor):
    """Agent-road any-hit through K1, in the original agent order."""
    feat_s, mask, inv_perm = tile_mask_and_order(scene, state, feat)
    hits_s = agent_road_hits_tiled(
        feat_s.contiguous(), scene.rtiles.feat, mask
    )
    return torch.gather(hits_s, 1, inv_perm) > 0.5


def _grid_candidates(grid, state: SimState) -> torch.Tensor:
    """[W, A, K] road indices (-1 padding) of each agent's grid cell; a
    position outside the grid takes the nearest edge cell."""
    cell = torch.floor(
        (state.pos - grid.origin[:, None, :]) / grid.cell_size[:, None, None]
    ).to(torch.int32)
    cx = torch.clamp(cell[..., 0], min=0)
    cx = torch.minimum(cx, grid.dims[:, None, 0] - 1)
    cy = torch.clamp(cell[..., 1], min=0)
    cy = torch.minimum(cy, grid.dims[:, None, 1] - 1)
    w = torch.arange(cell.shape[0], device=cell.device)[:, None]
    return grid.table[w, cy.long(), cx.long()]


def _top_k_candidates(scene: Scene, state: SimState, active, k: int):
    """[W, A, K] the K road indices of least (center distance - half
    length) among each agent's allowed pairs (collision.py:205-226).  The
    score bounds the box distance from below, so a hit scores below about
    the agent's radius."""
    roads = scene.roads
    d = vec_norm(roads.pos[:, None, :, 0:2] - state.pos[:, :, None, :])
    score = d - roads.scale[:, None, :, 0]
    pair_ok = (active[:, :, None] & roads.valid[:, None, :]
               & _road_allowed(scene.agents.etype[:, :, None],
                               roads.etype[:, None, :]))
    score = torch.where(pair_ok, score, torch.inf)
    return torch.topk(-score, k, dim=-1).indices


def _candidate_road_hits(scene: Scene, state: SimState, active, half,
                         cand: torch.Tensor) -> torch.Tensor:
    """Agent-road any-hit [W, A] over the road candidates cand [W, A, K]
    (-1 padding): the candidates' boxes gathered, their pair mask checked,
    then the SAT."""
    roads = scene.roads
    W, A, K = cand.shape
    safe = cand.clamp(min=0).long().reshape(W, A * K)

    def take(x):  # [W, R, ...] -> [W, A, K, ...]
        idx = safe.reshape(safe.shape + (1,) * (x.dim() - 2)).expand(
            (W, A * K) + x.shape[2:])
        return torch.gather(x, 1, idx).reshape((W, A, K) + x.shape[2:])

    r_ok = (
        (cand >= 0)
        & active[:, :, None]
        & take(roads.valid)
        & _road_allowed(scene.agents.etype[:, :, None], take(roads.etype))
    )
    hit = obb.obb_overlap_sat(
        state.pos[:, :, None, :], state.yaw[:, :, None], half[:, :, None],
        take(roads.pos[..., 0:2]), take(roads.yaw), take(roads.scale[..., 0:2]),
    )
    return (hit & r_ok).any(dim=-1)


def _agent_road_hits(scene: Scene, state: SimState, params: Params,
                     active: torch.Tensor, half: torch.Tensor) -> torch.Tensor:
    """[W, A] bool: each active agent against the road segments, on the
    path ``params`` and the scene select (K1 tiles, the grid, top-K
    candidates or K2 dense)."""
    use_grid = params.use_collision_grid and scene.grid is not None
    top_k = params.collision_top_k
    use_tiles = (
        scene.rtiles is not None
        and params.use_tile_collision is not False
        and not use_grid
        and top_k is None
    )
    if use_tiles:
        return _tiled_road_hits(
            scene, state, agent_features(scene, state, active, half))
    if use_grid:
        return _candidate_road_hits(scene, state, active, half,
                                    _grid_candidates(scene.grid, state))
    if top_k is not None and top_k < scene.max_roads:
        return _candidate_road_hits(
            scene, state, active, half,
            _top_k_candidates(scene, state, active, top_k))
    return agent_road_hits_dense(
        agent_features(scene, state, active, half),
        road_features_t(scene)) > 0.5


def collision_system(
    scene: Scene, state: SimState, params: Params, cur_step: torch.Tensor
) -> SimState:
    """One collision pass; returns the state with collided/info flags set.

    ``cur_step`` is the pre-decrement trajectory index [W, A]
    (src/sim.cpp:23-25,640)."""
    with span("sim.collision"):
        agents = scene.agents
        active = ~_skip_mask(scene, state, cur_step)
        half = agent_half_extents(scene)

        # ---- agent vs agent ---------------------------------------------
        hit_aa = obb.obb_overlap_sat(
            state.pos[:, :, None, :], state.yaw[:, :, None],
            half[:, :, None], state.pos[:, None, :, :],
            state.yaw[:, None, :], half[:, None, :],
        )  # [W, A, A]
        eye = torch.eye(hit_aa.shape[-1], dtype=torch.bool,
                        device=hit_aa.device)
        hit_aa = hit_aa & (active[:, :, None] & active[:, None, :] & ~eye)

        other_t = agents.etype[:, None, :]
        hit_veh = (hit_aa & (other_t == C.ET_VEHICLE)).any(dim=-1)
        # Info attribution chain (src/sim.cpp:713-724): not road, not
        # vehicle, type <= Cyclist => collidedWithNonVehicle.
        hit_nonveh = (
            hit_aa & (other_t != C.ET_VEHICLE) & (other_t <= C.ET_CYCLIST)
        ).any(dim=-1)
        any_aa = hit_aa.any(dim=-1)

        # ---- agent vs road ----------------------------------------------
        with span("sim.agent_road"):
            any_ar = _agent_road_hits(scene, state, params, active, half)

        one = torch.ones((), dtype=torch.int32, device=active.device)
        return state.replace(
            collided=torch.where(any_aa | any_ar, one, state.collided),
            collided_road=torch.where(any_ar, one, state.collided_road),
            collided_vehicle=torch.where(hit_veh, one,
                                         state.collided_vehicle),
            collided_non_vehicle=torch.where(
                hit_nonveh, one, state.collided_non_vehicle
            ),
        )

"""Collision detection of the plain reference.

A frozen copy of the port's ``core/collision.py`` with every agent-road
path replaced by the plain dense SAT over all pairs (``sat``), taken a
block of worlds at a time: the tile-skip kernel K1 and the dense kernel K2
both compute exactly that any-hit.  Agent-agent pairs are the [W, A, A]
lattice of ``obb.obb_overlap_sat``.  Skip rules replicate
isInvalidExpertOrDone (src/sim.cpp:631-666); vehicles collide only with
RoadEdge/StopSign among road types, pedestrians and cyclists only with
StopSign (src/sim.hpp:88-102).
"""

from __future__ import annotations

import torch

from . import constants as C
from . import obb
from .sat import AGENT_BLOCK, agent_road_hits_dense_plain
from .types import Params, Scene, SimState
from .rtiles import MORTON_CELLS, morton_interleave


# Worlds per block of the plain agent-road lattice: 16 worlds x 32 agent
# rows x 10,240 roads is about 0.7 GB a float32 intermediate.
WORLD_BLOCK = 16


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


def collision_system(
    scene: Scene, state: SimState, params: Params, cur_step: torch.Tensor
) -> SimState:
    """One collision pass; returns the state with collided/info flags set.

    ``cur_step`` is the pre-decrement trajectory index [W, A]
    (src/sim.cpp:23-25,640)."""
    agents = scene.agents
    active = ~_skip_mask(scene, state, cur_step)
    half = agent_half_extents(scene)

    # ---- agent vs agent -------------------------------------------------
    hit_aa = obb.obb_overlap_sat(
        state.pos[:, :, None, :], state.yaw[:, :, None], half[:, :, None],
        state.pos[:, None, :, :], state.yaw[:, None, :], half[:, None, :],
    )  # [W, A, A]
    eye = torch.eye(hit_aa.shape[-1], dtype=torch.bool, device=hit_aa.device)
    hit_aa = hit_aa & (active[:, :, None] & active[:, None, :] & ~eye)

    other_t = agents.etype[:, None, :]
    hit_veh = (hit_aa & (other_t == C.ET_VEHICLE)).any(dim=-1)
    # Info attribution chain (src/sim.cpp:713-724): not road, not vehicle,
    # type <= Cyclist => collidedWithNonVehicle.
    hit_nonveh = (
        hit_aa & (other_t != C.ET_VEHICLE) & (other_t <= C.ET_CYCLIST)
    ).any(dim=-1)
    any_aa = hit_aa.any(dim=-1)

    # ---- agent vs road: the plain dense SAT, WORLD_BLOCK worlds at a time
    feat = agent_features(scene, state, active, half)
    roads_t = road_features_t(scene)
    any_ar = torch.cat([
        agent_road_hits_dense_plain(feat[w:w + WORLD_BLOCK],
                                    roads_t[w:w + WORLD_BLOCK])
        for w in range(0, feat.shape[0], WORLD_BLOCK)]) > 0.5

    one = torch.ones((), dtype=torch.int32, device=active.device)
    return state.replace(
        collided=torch.where(any_aa | any_ar, one, state.collided),
        collided_road=torch.where(any_ar, one, state.collided_road),
        collided_vehicle=torch.where(hit_veh, one, state.collided_vehicle),
        collided_non_vehicle=torch.where(
            hit_nonveh, one, state.collided_non_vehicle
        ),
    )

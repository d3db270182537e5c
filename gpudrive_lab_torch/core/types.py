"""State dataclasses and simulation parameters.

Port of ``gpudrive_lab_tpu/core/types.py``.  The simulator state is two
tensor dataclasses of padded struct-of-arrays tensors:

  * ``Scene``     — everything static within an episode (map geometry,
                    expert trajectories, per-agent flags), produced on the
                    host by the scene compiler.
  * ``SimState``  — everything the step function updates.

Leading dims: W = worlds, A = 128 agent rows, R = road entities (bucketed),
T = 91 trajectory steps.  Dtypes follow the JAX package: int32 ids, flags and
step counters, bool masks, float32 state.  Dataclasses are frozen; ``replace``
returns an updated copy, as flax's ``struct.dataclass`` does.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.device import resolve_device


class DynamicsModel(enum.IntEnum):
    """reference: src/init.hpp:97-103."""

    CLASSIC = 0
    INVERTIBLE_BICYCLE = 1
    DELTA_LOCAL = 2
    STATE = 3


class CollisionBehaviour(enum.IntEnum):
    """reference: src/init.hpp:90-95."""

    AGENT_STOP = 0
    AGENT_REMOVED = 1
    IGNORE = 2


class RewardType(enum.IntEnum):
    """reference: src/init.hpp:76-81."""

    DISTANCE_BASED = 0
    ON_GOAL_ACHIEVED = 1


class RoadObsAlgorithm(enum.IntEnum):
    """reference: src/init.hpp:105-109."""

    KNEAREST = 0
    LINEAR = 1  # AllEntitiesWithRadiusFiltering: first-K within radius


@dataclasses.dataclass(frozen=True)
class Params:
    """Static, hashable step-function configuration, field for field as in
    the JAX package (reference: src/init.hpp:111-127)."""

    dynamics_model: DynamicsModel = DynamicsModel.CLASSIC
    collision_behaviour: CollisionBehaviour = CollisionBehaviour.AGENT_STOP
    reward_type: RewardType = RewardType.ON_GOAL_ACHIEVED
    dist_to_goal_threshold: float = 2.0
    observation_radius: float = 50.0
    road_obs_algorithm: RoadObsAlgorithm = RoadObsAlgorithm.KNEAREST
    enable_lidar: bool = False
    disable_classic_obs: bool = False
    max_num_controlled_agents: int = 10_000
    ignore_non_vehicles: bool = False
    init_only_valid_agents: bool = True
    is_static_agent_controlled: bool = False
    read_from_tracks_to_predict: bool = False
    polyline_reduction_threshold: float = 0.0
    # Accepted as an alias of exact top-K: the road selection and the
    # collision candidates always use torch.topk (the JAX package's
    # approx_max_k is a TPU hardware op and may drop a collision).
    approx_top_k: bool = False
    # Accepted for parity with the JAX Params; both values fetch the K road
    # winners with the same row gather.
    road_gather: str = "take"
    # Agent-road candidates: the K road entities of least (center distance
    # - half length) per agent; None, or K >= R, tests every road.
    collision_top_k: int | None = None
    # Agent-road candidates from the scene's CollisionGrid (Scene.grid).
    use_collision_grid: bool = False
    # Tile-skip agent-road narrow phase (kernel K1).  None = auto: used
    # whenever the scene compiler built Scene.rtiles (road buckets >=
    # scene/rtiles.py TILE_COLLISION_MIN_R); True forces the compiler to
    # build tiles regardless of bucket size; False disables.
    use_tile_collision: bool | None = None


class _TensorData:
    """Mixin for the tensor dataclasses: ``replace`` returns an updated
    copy."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True, eq=False)
class RoadGraph(_TensorData):
    """Road entities as oriented boxes, one row per segment
    (reference: src/level_gen.cpp:166-185)."""

    pos: torch.Tensor  # [W, R, 3] box center (z encodes lidar plane offsets)
    yaw: torch.Tensor  # [W, R]
    scale: torch.Tensor  # [W, R, 3] half-extents (d0=half-len, d1, d2)
    etype: torch.Tensor  # [W, R] int32 EntityType
    rid: torch.Tensor  # [W, R] int32 source road id
    map_type: torch.Tensor  # [W, R] int32 waymax MapElementId
    valid: torch.Tensor  # [W, R] bool — entity exists


@dataclasses.dataclass(frozen=True, eq=False)
class AgentsStatic(_TensorData):
    """Per-agent quantities fixed for the scene
    (reference: src/level_gen.cpp:131-164)."""

    valid: torch.Tensor  # [W, A] bool — agent was created
    etype: torch.Tensor  # [W, A] int32 EntityType
    size: torch.Tensor  # [W, A, 3] raw length/width/height (unscaled)
    goal: torch.Tensor  # [W, A, 2] demeaned goal position
    aid: torch.Tensor  # [W, A] int32 source object id (-1 padding)
    controlled: torch.Tensor  # [W, A] bool — policy-controlled
    static: torch.Tensor  # [W, A] bool — ResponseType::Static
    mark_as_expert: torch.Tensor  # [W, A] bool
    metadata: torch.Tensor  # [W, A, 4] int32 (isSdc, isOOI, isTTP, difficulty)
    traj_pos: torch.Tensor  # [W, A, T, 2] demeaned logged positions
    traj_vel: torch.Tensor  # [W, A, T, 2]
    traj_yaw: torch.Tensor  # [W, A, T]
    traj_valid: torch.Tensor  # [W, A, T] float (0/1)
    traj_inv_actions: torch.Tensor  # [W, A, T, 10] inverse expert actions


@dataclasses.dataclass(frozen=True, eq=False)
class CollisionGrid(_TensorData):
    """Scene-static spatial hash over road entities: per world, each coarse
    cell lists the road indices whose boxes (expanded by the largest agent
    radius) touch it, so an agent tests only the roads of its own cell
    (scene/grid.py builds it)."""

    origin: torch.Tensor  # [W, 2] f32 grid lower corner
    cell_size: torch.Tensor  # [W] f32
    dims: torch.Tensor  # [W, 2] i32 (gx, gy) used per world
    table: torch.Tensor  # [W, GY, GX, K] i32 road indices, -1 padding


@dataclasses.dataclass(frozen=True, eq=False)
class RoadTiles(_TensorData):
    """Scene-static, Morton-sorted road tiles for the tile-skip agent-road
    narrow phase (core/kernels.agent_road_hits_tiled, kernel K1)."""

    feat: torch.Tensor  # [W, T, 8, RT] f32 rows: px, py, cos, sin, h0, h1,
    #                     allow_vehicle, allow_other (0 for invalid segments)
    bounds: torch.Tensor  # [W, T, 6] f32: xmin, ymin, xmax, ymax (over valid
    #                       segment centers), reach (max segment half-diag),
    #                       valid (tile has any valid segment)
    world_min: torch.Tensor  # [W, 2] road AABB lower corner (agent Morton)
    world_inv_ext: torch.Tensor  # [W, 2] 1 / road AABB extent

    @property
    def tile_size(self) -> int:
        return self.feat.shape[3]


@dataclasses.dataclass(frozen=True, eq=False)
class Scene(_TensorData):
    """One batch of compiled worlds (reference: src/level_gen.cpp).

    ``grid`` is built when ``Params.use_collision_grid`` is set and
    ``rtiles`` at large road buckets (scene/compiler.build_scene)."""

    agents: AgentsStatic
    roads: RoadGraph
    num_agents: torch.Tensor  # [W] int32 — Shape.agentEntityCount
    num_roads: torch.Tensor  # [W] int32 — Shape.roadEntityCount
    means: torch.Tensor  # [W, 3] per-world mean subtracted from coords
    map_name: torch.Tensor  # [W, 32] int32 char codes
    scenario_id: torch.Tensor  # [W, 32] int32 char codes
    grid: CollisionGrid | None = None
    rtiles: RoadTiles | None = None

    @property
    def num_worlds(self) -> int:
        return self.num_agents.shape[0]

    @property
    def max_agents(self) -> int:
        return self.agents.valid.shape[1]

    @property
    def max_roads(self) -> int:
        return self.roads.valid.shape[1]

    @property
    def device(self) -> torch.device:
        return self.num_agents.device


def vec_norm(x: torch.Tensor) -> torch.Tensor:
    """sqrt(sum(x*x)) over the last axis — the exact operation order of
    ``jnp.linalg.norm(x, axis=-1)``."""
    return torch.sqrt((x * x).sum(-1))


@dataclasses.dataclass(frozen=True, eq=False)
class SimState(_TensorData):
    """Per-step state (reference: the dynamic ECS components)."""

    pos: torch.Tensor  # [W, A, 2]
    z: torch.Tensor  # [W, A] (1 for live agents, FLT_MAX when teleported away)
    yaw: torch.Tensor  # [W, A]
    vel: torch.Tensor  # [W, A, 2] linear velocity
    ang_vel: torch.Tensor  # [W, A] angular velocity about z
    collided: torch.Tensor  # [W, A] int32 CollisionDetectionEvent.hasCollided
    done: torch.Tensor  # [W, A] int32
    collided_road: torch.Tensor  # [W, A] int32
    collided_vehicle: torch.Tensor  # [W, A] int32
    collided_non_vehicle: torch.Tensor  # [W, A] int32
    reached_goal: torch.Tensor  # [W, A] int32
    steps_remaining: torch.Tensor  # [W, A] int32
    reward: torch.Tensor  # [W, A] float32

    @property
    def speed(self) -> torch.Tensor:
        return vec_norm(self.vel)


def zero_state(num_worlds: int, max_agents: int = C.MAX_AGENTS,
               device=None) -> SimState:
    """An all-zero SimState [num_worlds, max_agents] on ``device`` (CUDA
    unless another is named): float32 kinematics, int32 flags."""
    dev = resolve_device(device)
    wa = (num_worlds, max_agents)

    def f(*shape):
        return torch.zeros(wa + shape, dtype=torch.float32, device=dev)

    def i():
        return torch.zeros(wa, dtype=torch.int32, device=dev)

    return SimState(
        pos=f(2), z=f(), yaw=f(), vel=f(2), ang_vel=f(),
        collided=i(), done=i(), collided_road=i(), collided_vehicle=i(),
        collided_non_vehicle=i(), reached_goal=i(), steps_remaining=i(),
        reward=f(),
    )

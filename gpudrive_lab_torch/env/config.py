"""Environment configuration (port of ``gpudrive_lab_tpu/env/config.py``).

``EnvConfig`` holds every option of the JAX package's env config
(reference: gpudrive/env/config.py), with the same defaults.  A few are
stored and not read, as in the JAX package: the world count comes from the
scenes (``num_worlds``) and the road-graph and episode sizes from the
constants (each field's comment says so).  Action grids are numpy and
become lookup-table tensors inside the env.  ``SceneConfig`` and
``SelectionDiscipline`` drive ``env/dataset.select_scenes``;
``RenderConfig`` configures the env's visualizer (``visualize/core.py``).
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import List, Optional, Tuple

import numpy as np

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.types import (
    CollisionBehaviour,
    DynamicsModel,
    Params,
    RewardType,
    RoadObsAlgorithm,
)


def _grid(lo: float, hi: float, n: int) -> np.ndarray:
    """torch.round(torch.linspace(lo, hi, n), decimals=3)
    (reference: gpudrive/env/config.py:64-90)."""
    return np.round(np.linspace(lo, hi, n), 3).astype(np.float32)


@dataclasses.dataclass
class EnvConfig:
    """reference: gpudrive/env/config.py:12-147."""

    # Observation space
    ego_state: bool = True
    road_map_obs: bool = True
    partner_obs: bool = True
    bev_obs: bool = False
    lidar_obs: bool = False
    norm_obs: bool = True
    num_stack: int = 1
    disable_classic_obs: bool = False

    max_controlled_agents: int = C.MAX_AGENTS
    # Not read: the env's world count is len(scene_paths) or the data
    # loader's batch size, as in the JAX env.
    num_worlds: int = 1

    # Rays per lidar plane (reference: src/consts.hpp:37); read by
    # GPUDriveTorchEnv.get_lidar_obs.
    num_lidar_samples: int = C.NUM_LIDAR_SAMPLES

    # Reward weights: R = a*collided + b*goal_achieved + c*off_road
    collision_weight: float = 0.0
    goal_achieved_weight: float = 1.0
    off_road_weight: float = 0.0

    road_obs_algorithm: str = "linear"
    obs_radius: float = 50.0
    polyline_reduction_threshold: float = 0.1

    dynamics_model: str = "delta_local"  # classic|bicycle|delta_local|state

    # Discrete action grids
    steer_actions: np.ndarray = dataclasses.field(
        default_factory=lambda: _grid(-math.pi, math.pi, 13)
    )
    accel_actions: np.ndarray = dataclasses.field(
        default_factory=lambda: _grid(-4.0, 4.0, 7)
    )
    head_tilt_actions: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1, np.float32)
    )
    dx: np.ndarray = dataclasses.field(
        default_factory=lambda: _grid(-6.0, 6.0, 20)
    )
    dy: np.ndarray = dataclasses.field(
        default_factory=lambda: _grid(-6.0, 6.0, 20)
    )
    dyaw: np.ndarray = dataclasses.field(
        default_factory=lambda: _grid(-math.pi, math.pi, 20)
    )

    collision_behavior: str = "ignore"  # remove|stop|ignore
    remove_non_vehicles: bool = True
    init_steps: int = 0

    reward_type: str = "sparse_on_goal_achieved"
    # also: weighted_combination | distance_to_logs | reward_conditioned |
    # distance_to_vdb_trajs
    # reward_conditioned: per-agent (collision, goal, off_road) weights,
    # drawn at every reset within these bounds (condition_mode "random"),
    # scaled from them by a named profile ("preset") or given ("fixed"),
    # and appended to the ego observation.
    condition_mode: str = "random"
    collision_weight_lb: float = -1.0
    collision_weight_ub: float = 0.0
    goal_achieved_weight_lb: float = 1.0
    goal_achieved_weight_ub: float = 2.0
    off_road_weight_lb: float = -1.0
    off_road_weight_ub: float = 0.0

    dist_to_goal_threshold: float = 2.0

    # Not read (as in the JAX package): the agent rows are C.MAX_AGENTS or
    # the agent_bucket below.
    max_num_agents_in_scene: int = C.MAX_AGENTS
    # Agent-axis bucketing (not in the reference): None keeps the fixed
    # kMaxAgentCount=128 rows; "auto" (or an int cap) shrinks the sim's
    # agent axis to the scene batch's max created-agent count rounded to 16.
    # The 3368-float flat obs (127 partner slots) is kept by feature
    # padding; env getters then return [W, A_bucket, ...] tensors.
    agent_bucket: int | str | None = None
    # Not read (as in the JAX package): the road bucket comes from the
    # scenes or the env's max_roads, the K of the road observation from
    # C.MAX_AGENT_MAP_OBS, the episode length from C.EPISODE_LEN and the
    # agent box scale from C.VEHICLE_LENGTH_SCALE.
    max_num_rg_points: int = C.MAX_ROAD_ENTITIES
    roadgraph_top_k: int = C.MAX_AGENT_MAP_OBS
    episode_len: int = C.EPISODE_LEN
    agent_size_scale: float = C.VEHICLE_LENGTH_SCALE

    init_mode: str = "all_non_trivial"
    # all_non_trivial | all_objects | all_valid | womd_tracks_to_predict

    # VBD (diffusion sim agents, reference: gpudrive/env/config.py:142-147):
    # with use_vbd and vbd_in_obs the 455-float VBD block follows each
    # frame's observation; reward_type "distance_to_vdb_trajs" adds
    # vbd_trajectory_weight * exp(-distance to the predicted position).
    # vbd_model_path names a checkpoint for the caller to load
    # (vbd.integration.OfficialVBDSource.from_checkpoint); the env, like
    # the JAX env, does not read it.
    use_vbd: bool = False
    vbd_model_path: Optional[str] = None
    vbd_trajectory_weight: float = 0.01
    vbd_in_obs: bool = False

    # Collision and road-selection options of the JAX package.  The grid
    # and collision_top_k branches are not ported and raise; approx_top_k
    # and road_gather are accepted as aliases of the exact path.
    collision_top_k: Optional[int] = None
    approx_top_k: bool = False
    road_gather: str = "take"
    use_collision_grid: bool = False
    # None = auto: tile-skip narrow phase (kernel K1) when the road bucket
    # is large (scene/rtiles.py); True forces it, False disables.
    use_tile_collision: Optional[bool] = None
    # Seeds the env's host generator (reward conditioning, agent removal).
    seed: int = 0

    def sim_params(self) -> Params:
        """EnvConfig -> static step Params (the analogue of
        base_env._setup_environment_parameters, reference:
        gpudrive/env/base_env.py:96-159)."""
        dyn = {
            "classic": DynamicsModel.CLASSIC,
            "bicycle": DynamicsModel.INVERTIBLE_BICYCLE,
            "delta_local": DynamicsModel.DELTA_LOCAL,
            "state": DynamicsModel.STATE,
        }[self.dynamics_model]
        col = {
            "stop": CollisionBehaviour.AGENT_STOP,
            "remove": CollisionBehaviour.AGENT_REMOVED,
            "ignore": CollisionBehaviour.IGNORE,
        }[self.collision_behavior]
        # The C++ reward is OnGoalAchieved for every Python-shaped reward
        # type (base_env.py:53-74).
        reward = RewardType.ON_GOAL_ACHIEVED
        alg = {
            "linear": RoadObsAlgorithm.LINEAR,
            "k_nearest_roadpoints": RoadObsAlgorithm.KNEAREST,
        }[self.road_obs_algorithm]
        # init_mode -> (initOnlyValidAgentsAtFirstStep, readFromTracks)
        # (base_env.py init-mode translation)
        init_only_valid = self.init_mode in ("all_non_trivial", "all_valid")
        read_tracks = self.init_mode == "womd_tracks_to_predict"
        return Params(
            dynamics_model=dyn,
            collision_behaviour=col,
            reward_type=reward,
            dist_to_goal_threshold=self.dist_to_goal_threshold,
            observation_radius=self.obs_radius,
            road_obs_algorithm=alg,
            enable_lidar=self.lidar_obs,
            disable_classic_obs=self.disable_classic_obs,
            max_num_controlled_agents=self.max_controlled_agents,
            ignore_non_vehicles=self.remove_non_vehicles,
            init_only_valid_agents=init_only_valid,
            is_static_agent_controlled=False,
            read_from_tracks_to_predict=read_tracks,
            polyline_reduction_threshold=self.polyline_reduction_threshold,
            approx_top_k=self.approx_top_k,
            road_gather=self.road_gather,
            collision_top_k=self.collision_top_k,
            use_collision_grid=self.use_collision_grid,
            use_tile_collision=self.use_tile_collision,
        )



class SelectionDiscipline(enum.Enum):
    """reference: gpudrive/env/config.py:149-158."""

    FIRST_N = 0
    RANDOM_N = 1
    PAD_N = 2
    EXACT_N = 3
    K_UNIQUE_N = 4
    RANGE_N = 5
    CUSTOM_N = 6


@dataclasses.dataclass
class SceneConfig:
    """reference: gpudrive/env/config.py:160-181."""

    batch_size: int
    dataset_size: int
    path: Optional[str] = None
    num_scenes: Optional[int] = None
    discipline: SelectionDiscipline = SelectionDiscipline.PAD_N
    k_unique_scenes: Optional[int] = None
    seed: Optional[int] = None
    start_idx: int = 0
    custom_idx: Optional[List[int]] = None


class RenderMode(enum.Enum):
    MATPLOTLIB = "matplotlib"


@dataclasses.dataclass
class RenderConfig:
    """reference: gpudrive/env/config.py:199-221.  ``render_3d`` and
    ``vehicle_height`` are read by ``visualize/core.py``."""

    render_mode: RenderMode = RenderMode.MATPLOTLIB
    resolution: Tuple[int, int] = (1024, 1024)
    draw_expert_trajectories: bool = False
    draw_only_controllable_veh: bool = False
    obj_idx_font_size: int = 9
    render_3d: bool = False
    vehicle_height: float = 0.06

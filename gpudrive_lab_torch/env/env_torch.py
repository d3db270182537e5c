"""GPUDriveTorchEnv — the batched multi-world environment (port of
``gpudrive_lab_tpu/env/env_jax.py``; reference: gpudrive/env/env_torch.py).

The simulator is the step of gpudrive_lab_torch.core on tensors that stay on
the env's device; a per-world reset is a masked select.  The env keeps the
Scene, the SimState, the per-world clocks and the reward weights.

``init_steps`` > 0 warms every reset up with that many steps of expert log
playback (``expert_log_playback``), as the JAX env does.  ``num_stack`` > 1
stacks that many consecutive observations along the feature axis.  The
sensors come from ``get_lidar_obs``, ``get_bev_obs`` and ``get_camera_obs``
(core/lidar.py, core/bev.py, core/render.py).

The worlds come from ``scene_paths`` or from a ``data_loader``
(env/dataset.py), whose next batch ``swap_data_batch`` compiles in place of
the current one.  Reward conditioning (``reward_type="reward_conditioned"``)
draws the per-agent weights on the host from ``np.random.default_rng(
config.seed)``, the JAX env's generator, so both envs draw the same weights
(and the same agents for ``remove_agents_by_id``).  With ``use_vbd`` and
``vbd_in_obs`` each frame's observation ends with the 455-float VBD block
(vbd/integration.py) of the trajectories that ``set_vbd_trajectories``
installed, the logged ones until then; ``reward_type=
"distance_to_vdb_trajs"`` adds the VBD distance bonus to the weighted
combination.  ``render`` draws a world with matplotlib through ``vis``
(``visualize/core.py``), configured by ``render_config``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import observations as obsmod
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.core.bev import bev_observation
from gpudrive_lab_torch.core.lidar import lidar_observation
from gpudrive_lab_torch.core.render import CameraConfig, batch_render
from gpudrive_lab_torch.core.types import Params, Scene, SimState
from gpudrive_lab_torch.env.config import EnvConfig, RenderConfig
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.scene.compiler import build_scene
from gpudrive_lab_torch.utils.profiling import span
from gpudrive_lab_torch.vbd.integration import (
    VBD_OBS_DIM,
    egocentric_vbd_obs,
    log_replay_trajectories,
    vbd_distance_reward,
)


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Static observation-assembly options."""

    ego_state: bool = True
    road_map_obs: bool = True
    partner_obs: bool = True
    norm_obs: bool = True
    reward_conditioned: bool = False

    @property
    def obs_dim(self) -> int:
        d = 0
        if self.ego_state:
            d += C.EGO_FEAT_DIM + (3 if self.reward_conditioned else 0)
        if self.partner_obs:
            d += (C.MAX_AGENTS - 1) * C.PARTNER_FEAT_DIM
        if self.road_map_obs:
            d += C.MAX_AGENT_MAP_OBS * C.ROAD_GRAPH_FEAT_DIM
        return d


def _minmax(x, lo, hi):
    """normalize_min_max (reference: gpudrive/utils/geometry.py)."""
    return 2.0 * ((x - lo) / (hi - lo)) - 1.0


def flat_observation(
    scene: Scene,
    state: SimState,
    params: Params,
    spec: ObsSpec,
    reward_weights: torch.Tensor,
    ego_idx=None,
    split: bool = False,
):
    """Flattened per-agent policy observation and masks.

    Layout (reference: gpudrive/env/env_torch.py:1172-1216):
    [ego(6[+3]), partner(127*6), road(200*13)], normalised when norm_obs.
    Returns (obs [W, A, D], partner_mask [W, A, 127] int, road_mask
    [W, A, K] bool); a mask is None when its block is off.

    ego_idx restricts the ego axis to the selected agents: [W, C] slots
    per world (results [W, C, ...]) or a flat (w_idx [N], a_idx [N]) pair
    (results [N, ...]), the PPO learner's compaction.  ``split=True``
    returns the obs as the tuple (ego [.., E], partner [.., 127, 6],
    road [.., 200, 13]) that LateFusionPolicy also accepts, instead of the
    concatenated vector; it needs all three classic blocks."""
    if split and not (spec.ego_state and spec.partner_obs
                      and spec.road_map_obs):
        raise ValueError("split obs requires ego/partner/road all enabled")
    with span("obs"):
        parts = []
        partner_mask = road_mask = None
        dev = state.pos.device

        if spec.ego_state:
            with span("obs.ego"):
                so = obsmod.self_observation(scene, state, ego_idx)
                speed = so[..., 0]
                length = so[..., 1] * C.VEHICLE_LENGTH_SCALE
                width = so[..., 2] * C.VEHICLE_LENGTH_SCALE
                gx, gy = so[..., 4], so[..., 5]
                collided = so[..., 6]
                if spec.norm_obs:
                    speed = speed / C.MAX_SPEED
                    length = length / C.MAX_VEH_LEN
                    width = width / C.MAX_VEH_WIDTH
                    gx = _minmax(gx, C.MIN_REL_GOAL_COORD,
                                 C.MAX_REL_GOAL_COORD)
                    gy = _minmax(gy, C.MIN_REL_GOAL_COORD,
                                 C.MAX_REL_GOAL_COORD)
                ego = torch.stack([speed, length, width, gx, gy, collided],
                                  dim=-1)
                if spec.reward_conditioned:
                    ego = torch.cat(
                        [ego, obsmod._ego_take(reward_weights, ego_idx)],
                        dim=-1)
                parts.append(ego)

        if spec.partner_obs:
            with span("obs.partner"):
                partner, other_static = obsmod.partner_observations(
                    scene, state, params, ego_idx, with_static=True
                )
                # Fixed flat-feature layout: 127 partner slots even when
                # the agent axis is bucketed below 128.  Pad the raw rows
                # with "nonexistent" fillers (zero features, id=-2) before
                # normalisation.
                short = (C.MAX_AGENTS - 1) - partner.shape[-2]
                if short:
                    filler = torch.where(torch.arange(9, device=dev) == 8,
                                         -2.0, 0.0)
                    pad_rows = filler.expand(partner.shape[:-2] + (short, 9))
                    partner = torch.cat([partner, pad_rows], dim=-2)
                    other_static = torch.cat(
                        [other_static, other_static.new_zeros(
                            other_static.shape[:-1] + (short,))],
                        dim=-1,
                    )
                p_speed = partner[..., 0]
                p_x, p_y = partner[..., 1], partner[..., 2]
                p_head = partner[..., 3]
                p_len = partner[..., 4] * C.VEHICLE_LENGTH_SCALE
                p_wid = partner[..., 5] * C.VEHICLE_LENGTH_SCALE
                if spec.norm_obs:
                    p_speed = p_speed / C.MAX_SPEED
                    p_x = _minmax(p_x, C.MIN_REL_AGENT_POS,
                                  C.MAX_REL_AGENT_POS)
                    p_y = _minmax(p_y, C.MIN_REL_AGENT_POS,
                                  C.MAX_REL_AGENT_POS)
                    p_head = p_head / C.MAX_ORIENTATION_RAD
                    p_len = p_len / C.MAX_VEH_LEN
                    p_wid = p_wid / C.MAX_VEH_WIDTH
                pobs = torch.stack([p_speed, p_x, p_y, p_head, p_len, p_wid],
                                   dim=-1)
                parts.append(pobs if split else pobs.flatten(-2))

        if spec.road_map_obs:
            with span("obs.road"):
                mo = obsmod.agent_map_observations(scene, state, params,
                                                   ego_idx)
                x, y = mo[..., 0], mo[..., 1]
                d0, d1, d2 = mo[..., 2], mo[..., 3], mo[..., 4]
                heading = mo[..., 5]
                rtype = torch.clamp(mo[..., 6].to(torch.int32), 0, 6)
                if spec.norm_obs:
                    x = _minmax(x, C.MIN_RG_COORD, C.MAX_RG_COORD)
                    y = _minmax(y, C.MIN_RG_COORD, C.MAX_RG_COORD)
                    d0 = d0 / C.MAX_ROAD_LINE_SEGMENT_LEN
                    d1 = d1 / C.MAX_ROAD_SCALE
                    d2 = d2 / C.MAX_ROAD_SCALE
                    heading = heading / C.MAX_ORIENTATION_RAD
                one_hot = torch.nn.functional.one_hot(rtype.long(), 7).to(
                    torch.float32)
                robs = torch.cat(
                    [torch.stack([x, y, d0, d1, d2, heading], dim=-1),
                     one_hot], dim=-1
                )
                parts.append(robs if split else robs.flatten(-2))
                road_mask = mo[..., 7] == -1  # (env_torch.py:1258-1272)

        with span("obs.assemble"):
            if split:
                obs = tuple(parts)
            elif parts:
                obs = torch.cat(parts, dim=-1)
            else:
                lead = (obsmod._ego_take(scene.agents.valid, ego_idx).shape
                        if ego_idx is not None else scene.agents.valid.shape)
                obs = torch.zeros(lead + (0,), dtype=torch.float32,
                                  device=dev)

            if spec.partner_obs:
                # Partner mask: 0 partner / 1 static / 2 nonexistent
                # (reference: env_torch.py:1224-1253).
                ids = partner[..., 8]
                feat_sum = partner[..., :6].sum(-1)
                two = torch.full_like(ids, 2, dtype=torch.int32)
                partner_mask = torch.where(
                    other_static & (feat_sum != 0),
                    torch.ones_like(two),
                    torch.where(ids <= -1, two, torch.zeros_like(two)),
                )
        return obs, partner_mask, road_mask


def shaped_rewards(
    scene: Scene,
    state: SimState,
    reward_type: str,
    reward_weights: torch.Tensor,
    world_time_steps: torch.Tensor,
):
    """Python-side reward shaping (reference: env_torch.py:469-604)."""
    if reward_type == "sparse_on_goal_achieved":
        return state.reward
    off_road = state.collided_road.to(torch.float32)
    collided = (state.collided_vehicle + state.collided_non_vehicle).to(
        torch.float32
    )
    goal = state.reached_goal.to(torch.float32)
    w = reward_weights  # [W, A, 3] = (collision, goal_achieved, off_road)
    r = w[..., 0] * collided + w[..., 1] * goal + w[..., 2] * off_road
    if reward_type == "distance_to_logs":
        t = torch.clamp(world_time_steps, 0, C.TRAJECTORY_LEN - 1).long()
        traj = scene.agents.traj_pos  # [W, A, T, 2]
        idx = t[:, None, None, None].expand(traj.shape[0], traj.shape[1], 1, 2)
        log_pos = torch.gather(traj, 2, idx)[:, :, 0]
        dist = torch.sqrt(((log_pos - state.pos) ** 2).sum(-1))
        r = r + 0.01 * torch.exp(-dist)
    return r


def expert_actions(scene: Scene, model: str) -> torch.Tensor:
    """Inverse/log actions with per-model clamps as [W, A, T, 10]
    action-union rows (reference: env_torch.py:1445-1509)."""
    ag = scene.agents
    if model == "state":
        return torch.cat(
            [ag.traj_pos, torch.ones_like(ag.traj_pos[..., :1]),
             ag.traj_yaw[..., None], ag.traj_vel,
             torch.zeros(ag.traj_pos.shape[:-1] + (4,),
                         dtype=torch.float32, device=ag.traj_pos.device)],
            dim=-1,
        )
    inv = ag.traj_inv_actions[..., :3]
    if model == "delta_local":
        a3 = torch.stack([inv[..., 0].clamp(-6, 6), inv[..., 1].clamp(-6, 6),
                          inv[..., 2].clamp(-torch.pi, torch.pi)], dim=-1)
    else:  # classic | bicycle
        a3 = torch.stack([inv[..., 0].clamp(-6, 6),
                          inv[..., 1].clamp(-0.3, 0.3), inv[..., 2]], dim=-1)
    return torch.cat(
        [a3, a3.new_zeros(a3.shape[:-1] + (C.ACTION_DIM - 3,))], dim=-1)


def expert_log_playback(scene: Scene, state: SimState,
                        world_time_steps: torch.Tensor, params: Params,
                        model: str, k: int):
    """Advance ``state`` by ``k`` steps of expert log playback from
    absolute trajectory time 0 (reference: env_torch.py:1274-1293), with
    the world clock advancing as in ``step_dynamics``.  Shared by the env's
    reset warm-up and the PPO trainer's auto-reset target.  Returns
    (state, world_time_steps)."""
    acts = expert_actions(scene, model)
    for t in range(k):
        state = stepmod.step(scene, state, acts[:, :, t], params)
        any_done = ((state.done != 0) & scene.agents.valid).any(1)
        world_time_steps = torch.where(any_done, world_time_steps,
                                       world_time_steps + 1)
    return state, world_time_steps


class GPUDriveTorchEnv:
    """Batched multi-world driving env with the reference's API surface
    (reset / step_dynamics / get_obs / get_rewards / get_dones / get_infos),
    reference: gpudrive/env/env_torch.py:41-130.  Runs on ``device``: CUDA
    unless the caller passes another (the tests pass "cpu")."""

    def __init__(
        self,
        config: EnvConfig,
        scene_paths: Optional[List[str]] = None,
        max_roads: Optional[int] = None,
        device=None,
        data_loader: Optional[SceneDataLoader] = None,
        render_config: Optional[RenderConfig] = None,
    ):
        self.config = config
        self.render_config = render_config
        self._vis = None
        self.params = config.sim_params()
        self.data_loader = data_loader
        if scene_paths is None:
            if data_loader is None:
                raise ValueError("need data_loader or scene_paths")
            self.data_iterator = iter(data_loader)
            scene_paths = next(self.data_iterator)
        else:
            self.data_iterator = iter(data_loader) if data_loader else None
        self.scene_paths = list(scene_paths)
        self.num_worlds = len(self.scene_paths)
        self.episode_len = C.EPISODE_LEN
        self.scene: Scene = build_scene(
            self.scene_paths, self.params, max_roads,
            max_agents=config.agent_bucket, device=device,
        )
        self.device = self.scene.device
        self._max_roads = self.scene.max_roads
        self.max_agent_count = int(self.scene.agents.valid.shape[1])

        classic = not config.disable_classic_obs
        self.spec = ObsSpec(
            ego_state=config.ego_state and classic,
            road_map_obs=config.road_map_obs and classic,
            partner_obs=config.partner_obs and classic,
            norm_obs=config.norm_obs,
            reward_conditioned=config.reward_type == "reward_conditioned",
        )
        # VBD (env_jax.py:412-421): predicted global trajectories
        # [W, A, T, 5], installed by set_vbd_trajectories
        self.vbd_trajectories: Optional[torch.Tensor] = None
        self._vbd_obs_dim = (VBD_OBS_DIM if config.use_vbd
                             and config.vbd_in_obs else 0)
        self.observation_dim = ((self.spec.obs_dim + self._vbd_obs_dim)
                                * config.num_stack)
        self._build_action_table()
        self._build_spaces()

        self._rng = np.random.default_rng(config.seed)
        self.reward_weights = self._default_reward_weights()
        self.world_time_steps = torch.zeros(
            self.num_worlds, dtype=torch.int32, device=self.device
        )
        self.state: SimState = None
        self._fresh: SimState = None
        self._fresh_clock: torch.Tensor = None
        self.stacked_obs: torch.Tensor = None
        self.partner_mask = None
        self.road_mask = None
        self.reset()

    # ----- setup ---------------------------------------------------------

    def _build_action_table(self):
        """Discrete action grids as a [n_actions, 3] lookup table, the
        cartesian product in the reference's order (env_torch.py:666-724)."""
        cfg = self.config
        if cfg.dynamics_model in ("classic", "bicycle"):
            grids = (cfg.accel_actions, cfg.steer_actions,
                     cfg.head_tilt_actions)
        elif cfg.dynamics_model == "delta_local":
            grids = (cfg.dx, cfg.dy, cfg.dyaw)
        else:
            self.action_keys = None
            self.action_space_n = 1
            return
        a, b, c = np.meshgrid(*grids, indexing="ij")
        table = np.stack([a.ravel(), b.ravel(), c.ravel()], axis=-1)
        self.action_keys = torch.as_tensor(
            table, dtype=torch.float32, device=self.device
        )
        self.action_space_n = len(table)

    def _build_spaces(self):
        """gymnasium spaces over the single-agent view (reference:
        env_torch.py constructor and _set_discrete_action_space); None
        where gymnasium is not installed, which the env does not need."""
        try:
            import gymnasium
        except ImportError:
            self.observation_space = None
            self.action_space = None
            return
        self.observation_space = gymnasium.spaces.Box(
            low=-np.inf, high=np.inf, shape=(self.observation_dim,),
            dtype=np.float32,
        )
        if self.action_keys is not None:
            self.action_space = gymnasium.spaces.Discrete(self.action_space_n)
        else:  # state dynamics: continuous 10-float action rows
            self.action_space = gymnasium.spaces.Box(
                low=-np.inf, high=np.inf, shape=(C.ACTION_DIM,),
                dtype=np.float32,
            )

    def _default_reward_weights(self) -> torch.Tensor:
        """[W, A, 3] (collision, goal_achieved, off_road) weights; drawn by
        ``_sample_reward_weights`` when reward-conditioned."""
        cfg = self.config
        if cfg.reward_type == "reward_conditioned":
            return self._sample_reward_weights()
        w = torch.tensor(
            [cfg.collision_weight, cfg.goal_achieved_weight,
             cfg.off_road_weight], dtype=torch.float32, device=self.device,
        )
        return w.expand(self.num_worlds, self.max_agent_count, 3).contiguous()

    # Reward-conditioning presets (reference: env_torch.py:247-401).
    _PRESETS = {
        "cautious": (0.9, 0.7, 0.9),
        "aggressive": (0.5, 0.9, 0.6),
        "risk_taker": (0.3, 1.0, 0.4),
    }

    def _sample_reward_weights(self, condition_mode: Optional[str] = None,
                               agent_type=None) -> torch.Tensor:
        """Per-agent (collision, goal, off_road) weights [W, A, 3]
        (reference: env_torch.py:247-401): ``condition_mode`` "random"
        draws within the configured bounds from the env's host generator;
        "preset" scales the bounds by the profile ``agent_type`` names
        ("balanced" by default, or cautious, aggressive, risk_taker);
        "fixed" broadcasts the 3 weights ``agent_type`` gives."""
        cfg = self.config
        mode = condition_mode or cfg.condition_mode
        lo = np.array([cfg.collision_weight_lb, cfg.goal_achieved_weight_lb,
                       cfg.off_road_weight_lb])
        hi = np.array([cfg.collision_weight_ub, cfg.goal_achieved_weight_ub,
                       cfg.off_road_weight_ub])
        shape = (self.num_worlds, self.max_agent_count, 3)
        if mode == "fixed":
            if agent_type is None:
                raise ValueError(
                    "condition_mode='fixed' requires agent_type=[c, g, o] "
                    "weights (reference: env_torch.py:376-381)"
                )
            w = np.broadcast_to(np.asarray(agent_type, np.float32), shape)
        elif mode == "preset":
            name = agent_type if isinstance(agent_type, str) else "balanced"
            if name == "balanced":
                vec = (lo + hi) / 2.0
            else:
                s = self._PRESETS[name]
                vec = np.array([lo[0] * s[0], hi[1] * s[1], lo[2] * s[2]])
            w = np.broadcast_to(vec.astype(np.float32), shape)
        else:  # random
            w = self._rng.uniform(lo, hi, shape)
        return torch.as_tensor(np.ascontiguousarray(w, np.float32),
                               device=self.device)

    # ----- core API ------------------------------------------------------

    @property
    def cont_agent_mask(self) -> torch.Tensor:
        """[W, A] bool of the controlled agents, on the env's device."""
        return self.scene.agents.controlled

    def get_controlled_agents_mask(self) -> np.ndarray:
        return self.scene.agents.controlled.cpu().numpy()

    def reset(self, env_idx_list=None, condition_mode: Optional[str] = None,
              agent_type=None):
        """(Re)generate worlds and return the observation
        (reference: env_torch.py:403-451).  ``env_idx_list`` None resets
        every world; otherwise it lists the world indices to reset.  With
        ``init_steps`` the reset worlds come back warmed up by that many
        steps of expert log playback, their clocks at ``init_steps``.
        Reward-conditioned, the reset worlds get new weights
        (``_sample_reward_weights(condition_mode, agent_type)``, drawn for
        every world as the JAX env draws them)."""
        self._reset_state(env_idx_list)
        if self.config.reward_type == "reward_conditioned":
            fresh_w = self._sample_reward_weights(condition_mode, agent_type)
            if env_idx_list is None or self.reward_weights is None:
                self.reward_weights = fresh_w
            else:
                self.reward_weights = torch.where(
                    self._world_mask(env_idx_list)[:, None, None], fresh_w,
                    self.reward_weights)
        return self.get_obs(reset=True)

    def _reset_state(self, env_idx_list):
        if env_idx_list is None or self.state is None:
            self.world_time_steps.zero_()
            self._fresh = stepmod.reset(self.scene, None, self.params)
            if self.config.init_steps > 0:
                self._fresh, self.world_time_steps = expert_log_playback(
                    self.scene, self._fresh, self.world_time_steps,
                    self.params, self.config.dynamics_model,
                    self.config.init_steps,
                )
            self._fresh_clock = self.world_time_steps.clone()
            self.state = self._fresh
        else:
            self.reset_worlds(self._world_mask(env_idx_list))

    def _world_mask(self, env_idx_list) -> torch.Tensor:
        mask = torch.zeros(self.num_worlds, dtype=torch.bool,
                           device=self.device)
        mask[torch.as_tensor(env_idx_list, dtype=torch.long,
                             device=self.device)] = True
        return mask

    def reset_worlds(self, mask: torch.Tensor):
        """Reset the worlds where ``mask`` [W] bool is set, as a per-world
        select against the fresh post-reset state, with no host sync.

        This equals ``core.step.reset`` with the same mask: the Reset
        graph's tail is idempotent on the worlds it does not regenerate, so
        selecting from the state cached at the last full reset saves
        running the collision tail again on every world."""
        self.state = stepmod.select_worlds(mask, self._fresh, self.state)
        self.world_time_steps = torch.where(
            mask, self._fresh_clock, self.world_time_steps)

    def step_dynamics(self, actions):
        """reference: env_torch.py:606-613.  ``actions`` in any form that
        ``action_values`` takes."""
        self.state = stepmod.step(self.scene, self.state,
                                  self.action_values(actions), self.params)
        any_done = ((self.state.done != 0) & self.scene.agents.valid).any(1)
        self.world_time_steps = torch.where(
            any_done, self.world_time_steps, self.world_time_steps + 1
        )

    def action_values(self, actions) -> torch.Tensor:
        """[W, A, 10] action-union rows of what ``step_dynamics`` takes:
        [W, A] (or [W, A, 1]) discrete indices into the action table, or
        [W, A, <=10] raw action values; None gives zero actions."""
        W, A = self.num_worlds, self.max_agent_count
        if actions is None:
            return torch.zeros((W, A, C.ACTION_DIM), dtype=torch.float32,
                               device=self.device)
        actions = torch.as_tensor(actions, device=self.device)
        if actions.shape[1] > A:  # full-128 callers: rows >= A are pads
            actions = actions[:, :A]
        is_index = self.action_keys is not None and (
            actions.dim() == 2
            or (actions.dim() == 3 and actions.shape[-1] == 1)
        )
        if is_index:
            idx = actions.reshape(W, -1)
            if idx.is_floating_point():
                idx = torch.nan_to_num(idx)
            idx = torch.clamp(idx.long(), 0, self.action_keys.shape[0] - 1)
            act = torch.zeros((W, A, C.ACTION_DIM), dtype=torch.float32,
                              device=self.device)
            act[..., :3] = self.action_keys[idx]
            return act
        act = actions.to(torch.float32)
        pad = C.ACTION_DIM - act.shape[-1]
        if pad:
            act = torch.cat([act, act.new_zeros(act.shape[:-1] + (pad,))],
                            dim=-1)
        return act

    def set_vbd_trajectories(self, source_or_array):
        """Install predicted trajectories: a [W, A, T, 5] array, or a
        TrajectorySource called on the current scene and state (see
        gpudrive_lab_torch.vbd.integration; env_jax.py:621-627)."""
        if callable(source_or_array):
            self.vbd_trajectories = source_or_array(self.scene, self.state)
        else:
            self.vbd_trajectories = torch.as_tensor(
                source_or_array, dtype=torch.float32, device=self.device)

    def get_obs(self, reset: bool = False) -> torch.Tensor:
        """The flat observation [W, A, D], the VBD block last when it is
        on; with ``num_stack`` n > 1 the last n of them side by side
        [W, A, n * D], oldest first, the stack zeroed when ``reset``
        (env_jax.py:629-657)."""
        obs, self.partner_mask, self.road_mask = flat_observation(
            self.scene, self.state, self.params, self.spec,
            self.reward_weights,
        )
        if self._vbd_obs_dim:
            if self.vbd_trajectories is None:
                # the logged trajectories until a source is installed
                self.vbd_trajectories = log_replay_trajectories(
                    self.scene, self.state)
            with span("obs.vbd"):
                vbd = egocentric_vbd_obs(self.state, self.vbd_trajectories)
            obs = torch.cat([obs, vbd], dim=-1)
        n = self.config.num_stack
        if n > 1:
            if reset or self.stacked_obs is None:
                self.stacked_obs = obs.new_zeros(
                    obs.shape[:-1] + (obs.shape[-1] * n,))
            self.stacked_obs = torch.cat(
                [self.stacked_obs[..., obs.shape[-1]:], obs], dim=-1)
            return self.stacked_obs
        return obs

    def get_rewards(self) -> torch.Tensor:
        if self.config.reward_type == "distance_to_vdb_trajs":
            # weighted_combination plus the VBD bonus (env_jax.py:659-676)
            if self.vbd_trajectories is None:
                raise ValueError("distance_to_vdb_trajs requires "
                                 "set_vbd_trajectories()")
            base = shaped_rewards(
                self.scene, self.state, "weighted_combination",
                self.reward_weights, self.world_time_steps)
            with span("reward.vbd"):
                bonus = vbd_distance_reward(
                    self.state, self.vbd_trajectories, self.world_time_steps,
                    self.config.vbd_trajectory_weight)
            return base + bonus
        return shaped_rewards(
            self.scene, self.state, self.config.reward_type,
            self.reward_weights, self.world_time_steps,
        )

    def get_dones(self) -> torch.Tensor:
        return self.state.done.to(torch.float32)

    def get_infos(self):
        """Info columns as in the export layout: off_road, collided, goal,
        type (reference: gpudrive/datatypes/info.py)."""
        s = self.state
        return {
            "off_road": s.collided_road,
            "collided": s.collided_vehicle + s.collided_non_vehicle,
            "goal_achieved": s.reached_goal,
            "type": torch.where(self.scene.agents.valid,
                                self.scene.agents.etype,
                                torch.zeros_like(self.scene.agents.etype)),
        }

    def get_partner_mask(self):
        return self.partner_mask

    def get_road_mask(self):
        return self.road_mask

    def get_lidar_obs(self, actions=None) -> torch.Tensor:
        """[W, A, 3, S, 4] lidar samples (reference: env_torch.py:898-924).
        ``actions`` (any form ``step_dynamics`` takes) supply the head angle
        of controlled agents; None gives zeros, as the JAX env passes."""
        return lidar_observation(
            self.scene, self.state, self.params, self.action_values(actions),
            num_samples=self.config.num_lidar_samples,
        )

    def get_bev_obs(self) -> torch.Tensor:
        """[W, A, RES, RES, 1] entity-type grid (reference:
        env_torch.py:926-945)."""
        return bev_observation(self.scene, self.state, self.params)

    def get_camera_obs(self, camera_config: Optional[CameraConfig] = None):
        """Per-agent camera tensors (rgb [W, A, H, Wpx, 4] uint8, depth
        [W, A, H, Wpx, 1] float32), the batch renderer's exports
        (reference: mgr.cpp:922-948)."""
        return batch_render(self.scene, self.state,
                            camera_config or CameraConfig())

    def world_done(self) -> torch.Tensor:
        """[W] bool: every created agent of the world is done."""
        return ((self.state.done != 0) | ~self.scene.agents.valid).all(dim=1)

    # ----- log playback / experts ---------------------------------------

    def get_expert_actions(self):
        """Inverse actions with per-model clamps (reference:
        env_torch.py:1445-1509) over the full horizon: (actions
        [W, A, T, 10], pos [W, A, T, 2], vel [W, A, T, 2], yaw [W, A, T],
        valids [W, A, T])."""
        ag = self.scene.agents
        return (expert_actions(self.scene, self.config.dynamics_model),
                ag.traj_pos, ag.traj_vel, ag.traj_yaw, ag.traj_valid)

    def advance_sim_with_log_playback(self, init_steps: int):
        """Step every agent through its logged actions from trajectory time
        0 for ``init_steps`` steps (reference: env_torch.py:1274-1293)."""
        self.state, self.world_time_steps = expert_log_playback(
            self.scene, self.state, self.world_time_steps, self.params,
            self.config.dynamics_model, init_steps,
        )

    # ----- dataset churn -------------------------------------------------

    def swap_data_batch(self, data_batch: Optional[List[str]] = None):
        """The analogue of Manager::setMaps (reference:
        env_torch.py:1351-1384): compile ``data_batch`` (by default the
        loader's next batch, restarting the loader when it is spent) into
        the current padded shapes and reset every world.  A batch that
        needs a bigger road or agent bucket is compiled once more with
        buckets of its own (with ``agent_bucket="auto"`` the agent rows
        otherwise stay at the current count across swaps)."""
        if data_batch is None:
            if self.data_iterator is None:
                raise ValueError("swap_data_batch needs a data_loader or a "
                                 "data_batch")
            try:
                data_batch = next(self.data_iterator)
            except StopIteration:
                self.data_iterator = iter(self.data_loader)
                data_batch = next(self.data_iterator)
        if len(data_batch) != self.num_worlds:
            raise ValueError(f"swap needs {self.num_worlds} scenes, got "
                             f"{len(data_batch)}")
        self.scene_paths = list(data_batch)
        ab = self.config.agent_bucket
        if ab == "auto":
            ab = self.max_agent_count  # keep shapes stable across swaps
        try:
            scene = build_scene(self.scene_paths, self.params,
                                self._max_roads, max_agents=ab,
                                device=self.device)
        except ValueError:  # the batch needs a bigger bucket
            scene = build_scene(self.scene_paths, self.params,
                                max_agents=self.config.agent_bucket,
                                device=self.device)
            self._max_roads = scene.max_roads
        self._set_scene(scene)

    def remove_agents_by_id(self, perc_to_rmv_per_world: float,
                            remove_controlled_agents: bool = True):
        """Mark ``ceil(perc * n)`` agents of each world deleted, drawn from
        the env's host generator among its controlled agents (or, with
        ``remove_controlled_agents=False``, its uncontrolled valid ones),
        recompile the worlds without them and reset (reference:
        env_torch.py:1295-1349 -> Manager::deleteAgents)."""
        ag = self.scene.agents
        ctrl = ag.controlled.cpu().numpy()
        mask = ctrl if remove_controlled_agents else (
            ag.valid.cpu().numpy() & ~ctrl)
        aid = ag.aid.cpu().numpy()
        deleted: dict[int, frozenset] = {}
        for w in range(self.num_worlds):
            ids = aid[w][mask[w]]
            k = int(np.ceil(perc_to_rmv_per_world * len(ids)))
            if k:
                deleted[w] = frozenset(
                    self._rng.choice(ids, size=k, replace=False).tolist())
        self._set_scene(build_scene(
            self.scene_paths, self.params, self._max_roads, deleted,
            max_agents=self.config.agent_bucket, device=self.device))

    def _set_scene(self, scene: Scene):
        """Install a recompiled scene and reset every world.  Fixed reward
        weights follow a change of the agent rows; conditioned ones are
        drawn anew by the reset.  Installed VBD trajectories are kept, as
        the JAX env keeps them (env_jax.py:750; set them again after a
        swap); where the agent rows change they are cut to the new count
        or padded with zero rows (the rows a source leaves to agents it
        did not predict), where the JAX env fails to broadcast."""
        self.scene = scene
        self.max_agent_count = A = int(scene.agents.valid.shape[1])
        if (self.config.reward_type != "reward_conditioned"
                and self.reward_weights.shape[1] != A):
            self.reward_weights = self._default_reward_weights()
        traj = self.vbd_trajectories
        if traj is not None and traj.shape[1] != A:
            traj = traj[:, :A]
            self.vbd_trajectories = torch.cat(
                [traj, traj.new_zeros((traj.shape[0], A - traj.shape[1])
                                      + traj.shape[2:])], dim=1)
        self.state = None
        self.reset()

    # ----- rendering -----------------------------------------------------

    @property
    def vis(self):
        """The matplotlib visualizer, built at first use and again after a
        swap or agent removal replaced the scene (reference: env_torch.py
        constructor wiring of MatplotlibVisualizer)."""
        if self._vis is None or self._vis.scene is not self.scene:
            from gpudrive_lab_torch.visualize.core import MatplotlibVisualizer

            self._vis = MatplotlibVisualizer(self.scene, self.render_config)
        return self._vis

    def render(self, env_idx: int = 0,
               zoom_radius: float | None = None) -> np.ndarray:
        """World ``env_idx`` at the current state as one RGB uint8 array
        [H, W, 3]."""
        return self.vis.plot_simulator_state(
            self.state, [env_idx], zoom_radius=zoom_radius)[0]

    # ----- name exports --------------------------------------------------

    def get_env_filenames(self) -> dict:
        """{world: the scene's map name}."""
        return _decode_names(self.scene.map_name)

    def get_scenario_ids(self) -> dict:
        """{world: the scene's scenario id}."""
        return _decode_names(self.scene.scenario_id)


def _decode_names(codes: torch.Tensor) -> dict:
    """[W, L] character codes, 0-padded -> {world: string}."""
    return {i: "".join(chr(c) for c in row if c != 0)
            for i, row in enumerate(codes.cpu().tolist())}

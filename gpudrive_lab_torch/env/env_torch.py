"""GPUDriveTorchEnv — the batched multi-world environment (port of
``gpudrive_lab_tpu/env/env_jax.py``; reference: gpudrive/env/env_torch.py).

The simulator is the step of gpudrive_lab_torch.core on tensors that stay on
the env's device; a per-world reset is a masked select.  The env keeps the
Scene, the SimState, the per-world clocks and the reward weights.

``init_steps`` > 0 warms every reset up with that many steps of expert log
playback (``expert_log_playback``), as the JAX env does.

Not ported yet (they raise if a config asks for them): lidar, BEV and camera
observations, VBD, stacked observations, reward conditioning (its weights are
resampled on the host at every reset), ``swap_data_batch``,
``remove_agents_by_id`` and the dataset loader; the env takes
``scene_paths``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import observations as obsmod
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.core.types import Params, Scene, SimState
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.scene.compiler import build_scene


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
    parts = []
    partner_mask = road_mask = None
    dev = state.pos.device

    partner = other_static = None
    if spec.partner_obs:
        partner, other_static = obsmod.partner_observations(
            scene, state, params, ego_idx, with_static=True
        )
        # Fixed flat-feature layout: 127 partner slots even when the agent
        # axis is bucketed below 128.  Pad the raw rows with "nonexistent"
        # fillers (zero features, id=-2) before normalisation.
        short = (C.MAX_AGENTS - 1) - partner.shape[-2]
        if short:
            filler = torch.where(torch.arange(9, device=dev) == 8, -2.0, 0.0)
            pad_rows = filler.expand(partner.shape[:-2] + (short, 9))
            partner = torch.cat([partner, pad_rows], dim=-2)
            other_static = torch.cat(
                [other_static,
                 other_static.new_zeros(other_static.shape[:-1] + (short,))],
                dim=-1,
            )

    if spec.ego_state:
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
            gx = _minmax(gx, C.MIN_REL_GOAL_COORD, C.MAX_REL_GOAL_COORD)
            gy = _minmax(gy, C.MIN_REL_GOAL_COORD, C.MAX_REL_GOAL_COORD)
        ego = torch.stack([speed, length, width, gx, gy, collided], dim=-1)
        if spec.reward_conditioned:
            ego = torch.cat(
                [ego, obsmod._ego_take(reward_weights, ego_idx)], dim=-1)
        parts.append(ego)

    if spec.partner_obs:
        p_speed = partner[..., 0]
        p_x, p_y = partner[..., 1], partner[..., 2]
        p_head = partner[..., 3]
        p_len = partner[..., 4] * C.VEHICLE_LENGTH_SCALE
        p_wid = partner[..., 5] * C.VEHICLE_LENGTH_SCALE
        if spec.norm_obs:
            p_speed = p_speed / C.MAX_SPEED
            p_x = _minmax(p_x, C.MIN_REL_AGENT_POS, C.MAX_REL_AGENT_POS)
            p_y = _minmax(p_y, C.MIN_REL_AGENT_POS, C.MAX_REL_AGENT_POS)
            p_head = p_head / C.MAX_ORIENTATION_RAD
            p_len = p_len / C.MAX_VEH_LEN
            p_wid = p_wid / C.MAX_VEH_WIDTH
        pobs = torch.stack([p_speed, p_x, p_y, p_head, p_len, p_wid], dim=-1)
        parts.append(pobs if split else pobs.flatten(-2))

    if spec.road_map_obs:
        mo = obsmod.agent_map_observations(scene, state, params, ego_idx)
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
        one_hot = torch.nn.functional.one_hot(rtype.long(), 7).to(torch.float32)
        robs = torch.cat(
            [torch.stack([x, y, d0, d1, d2, heading], dim=-1), one_hot], dim=-1
        )
        parts.append(robs if split else robs.flatten(-2))
        road_mask = mo[..., 7] == -1  # road_mask (env_torch.py:1258-1272)

    if split:
        obs = tuple(parts)
    elif parts:
        obs = torch.cat(parts, dim=-1)
    else:
        lead = (obsmod._ego_take(scene.agents.valid, ego_idx).shape
                if ego_idx is not None else scene.agents.valid.shape)
        obs = torch.zeros(lead + (0,), dtype=torch.float32, device=dev)

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
        scene_paths: List[str],
        max_roads: Optional[int] = None,
        device=None,
    ):
        unsupported = [
            name for name, on in (
                ("lidar_obs", config.lidar_obs),
                ("bev_obs", config.bev_obs),
                ("use_vbd", config.use_vbd),
                ("num_stack > 1", config.num_stack > 1),
                ("distance_to_vdb_trajs",
                 config.reward_type == "distance_to_vdb_trajs"),
                ("reward_conditioned",
                 config.reward_type == "reward_conditioned"),
            ) if on
        ]
        if unsupported:
            raise NotImplementedError(
                f"not ported yet: {', '.join(unsupported)}"
            )
        self.config = config
        self.params = config.sim_params()
        self.scene_paths = list(scene_paths)
        self.num_worlds = len(self.scene_paths)
        self.episode_len = C.EPISODE_LEN
        self.scene: Scene = build_scene(
            self.scene_paths, self.params, max_roads,
            max_agents=config.agent_bucket, device=device,
        )
        self.device = self.scene.device
        self.max_agent_count = int(self.scene.agents.valid.shape[1])

        classic = not config.disable_classic_obs
        self.spec = ObsSpec(
            ego_state=config.ego_state and classic,
            road_map_obs=config.road_map_obs and classic,
            partner_obs=config.partner_obs and classic,
            norm_obs=config.norm_obs,
        )
        self.observation_dim = self.spec.obs_dim
        self._build_action_table()

        self.reward_weights = self._default_reward_weights()
        self.world_time_steps = torch.zeros(
            self.num_worlds, dtype=torch.int32, device=self.device
        )
        self.state: SimState = None
        self._fresh: SimState = None
        self._fresh_clock: torch.Tensor = None
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

    def _default_reward_weights(self) -> torch.Tensor:
        """[W, A, 3] (collision, goal_achieved, off_road) weights."""
        cfg = self.config
        w = torch.tensor(
            [cfg.collision_weight, cfg.goal_achieved_weight,
             cfg.off_road_weight], dtype=torch.float32, device=self.device,
        )
        return w.expand(self.num_worlds, self.max_agent_count, 3).contiguous()

    # ----- core API ------------------------------------------------------

    def reset(self, env_idx_list=None):
        """(Re)generate worlds and return the observation
        (reference: env_torch.py:403-451).  ``env_idx_list`` None resets
        every world; otherwise it lists the world indices to reset.  With
        ``init_steps`` the reset worlds come back warmed up by that many
        steps of expert log playback, their clocks at ``init_steps``."""
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
            mask = torch.zeros(self.num_worlds, dtype=torch.bool,
                               device=self.device)
            mask[torch.as_tensor(env_idx_list, dtype=torch.long,
                                 device=self.device)] = True
            self.reset_worlds(mask)
        return self.get_obs()

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
        """reference: env_torch.py:606-613.  ``actions`` is [W, A] (or
        [W, A, 1]) discrete indices into the action table, or
        [W, A, <=10] raw action values; None steps with zero actions."""
        W, A = self.num_worlds, self.max_agent_count
        if actions is None:
            actions = torch.zeros((W, A, C.ACTION_DIM), dtype=torch.float32,
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
        else:
            act = actions.to(torch.float32)
            pad = C.ACTION_DIM - act.shape[-1]
            if pad:
                act = torch.cat([act, act.new_zeros(act.shape[:-1] + (pad,))],
                                dim=-1)
        self.state = stepmod.step(self.scene, self.state, act, self.params)
        any_done = ((self.state.done != 0) & self.scene.agents.valid).any(1)
        self.world_time_steps = torch.where(
            any_done, self.world_time_steps, self.world_time_steps + 1
        )

    def get_obs(self) -> torch.Tensor:
        obs, self.partner_mask, self.road_mask = flat_observation(
            self.scene, self.state, self.params, self.spec,
            self.reward_weights,
        )
        return obs

    def get_rewards(self) -> torch.Tensor:
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

    def world_done(self) -> torch.Tensor:
        """[W] bool: every created agent of the world is done."""
        return ((self.state.done != 0) | ~self.scene.agents.valid).all(dim=1)

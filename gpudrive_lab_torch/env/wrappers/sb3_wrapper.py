"""Stable-Baselines3-style VecEnv adapter (port of
``gpudrive_lab_tpu/env/wrappers/sb3_wrapper.py``).

The reference's SB3 wrapper (reference: gpudrive/env/wrappers/
sb3_wrapper.py:23-407, SB3MultiAgentEnv): the multi-agent sim as a vector
env over the controlled agents, with NaN-padded rows for agents that are
already done, per-world auto-reset and the episode-end counters of
``info_dict``.  Duck-typed to SB3's VecEnv interface (reset / step_async /
step_wait / num_envs / observation_space / action_space) and driven by
``sb3_learner.IPPO``; SB3 itself is not needed, and gymnasium only for the
spaces (None without it).

Observations, rewards and dones are tensors on the env's device.  The
host reads the dead mask once per step (for ``infos``) and the finished
worlds' flags.  With ``render`` the first ``render_k_scenarios`` worlds are
drawn every step; a finished world's frames go to wandb when a run is
active, else to ``video_dir`` as a GIF.
"""

from __future__ import annotations

import numpy as np
import torch

from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv


class SB3MultiAgentEnv:
    def __init__(
        self,
        config: EnvConfig,
        data_loader: SceneDataLoader,
        max_cont_agents: int | None = None,
        render: bool = False,
        render_k_scenarios: int = 1,
        video_dir: str | None = None,
        device=None,
    ):
        self.env = GPUDriveTorchEnv(config, data_loader=data_loader,
                                    device=device)
        self.render = render
        self.render_k_scenarios = render_k_scenarios
        self.video_dir = video_dir
        self._frames: dict[int, list] = {}
        self.device = self.env.device
        self.num_worlds = self.env.num_worlds
        self.obs_dim = self.env.observation_dim
        self._refresh_mask()
        self.observation_space = None
        self.action_space = None
        try:
            import gymnasium
        except ImportError:
            pass
        else:
            self.observation_space = gymnasium.spaces.Box(
                -np.inf, np.inf, (self.obs_dim,), np.float32)
            self.action_space = gymnasium.spaces.Discrete(
                self.env.action_space_n)
        self.action_space_n = self.env.action_space_n
        self._actions = None
        self.num_episodes = 0
        self.info_dict: dict = {}

    def _refresh_mask(self):
        self.max_agent_count = self.env.max_agent_count
        self.controlled_mask = self.env.cont_agent_mask
        self.flat_ids = torch.nonzero(
            self.controlled_mask.reshape(-1))[:, 0]
        self.num_envs = int(self.flat_ids.numel())
        self.dead_agent_mask = torch.zeros(self.num_envs, dtype=torch.bool,
                                           device=self.device)

    def _obs(self) -> torch.Tensor:
        """[num_envs, obs_dim]: the controlled rows, with the rows of dead
        agents NaN so that nothing trains on stale observations
        (reference: sb3_wrapper.py:116-150)."""
        rows = self.env.get_obs().reshape(-1, self.obs_dim)[self.flat_ids]
        return rows.masked_fill(self.dead_agent_mask[:, None], float("nan"))

    def reset(self, seed=None) -> torch.Tensor:
        self.env.reset()
        self.dead_agent_mask.zero_()
        return self._obs()

    def step_async(self, actions):
        self._actions = torch.as_tensor(actions, device=self.device)

    def step_wait(self):
        W, A = self.num_worlds, self.max_agent_count
        full = torch.zeros(W * A, dtype=torch.int64, device=self.device)
        full[self.flat_ids] = self._actions.reshape(-1).long()
        self.env.step_dynamics(full.reshape(W, A))
        rewards = self.env.get_rewards().reshape(-1)[self.flat_ids]
        all_dones = self.env.get_dones() > 0
        dones = all_dones.reshape(-1)[self.flat_ids]
        # NaN rewards for agents already dead, so the rollout buffer drops
        # them (reference: MaskedRolloutBuffer, rollout_buffer.py:23-249)
        rewards = rewards.masked_fill(self.dead_agent_mask, float("nan"))
        infos = [{"dead": d} for d in self.dead_agent_mask.tolist()]
        prev_dead = self.dead_agent_mask.clone()
        self.dead_agent_mask |= dones

        if self.render:
            self.render_env()

        world_done = (all_dones | ~self.controlled_mask).all(dim=1)
        done_ids = torch.nonzero(world_done)[:, 0].tolist()
        if done_ids:
            if self.render:
                self._flush_videos(done_ids)
            self._update_info_dict(world_done, prev_dead)
            self.num_episodes += len(done_ids)
            self.env.reset(env_idx_list=done_ids)
            flat_done = world_done.repeat_interleave(A)[self.flat_ids]
            self.dead_agent_mask &= ~flat_done
        return self._obs(), rewards, dones, infos

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()

    def _update_info_dict(self, world_done: torch.Tensor,
                          prev_dead: torch.Tensor) -> None:
        """The episode-end counters over the finished worlds' controlled
        agents (reference: sb3_wrapper.py:288-318): off-road, vehicle and
        non-vehicle collision and goal sums, the controlled-agent count,
        and ``truncated``, the agents alive when their world's episode
        clock ran out (``steps_remaining == 0``; ``world_time_steps``
        stops at the first agent done, so it cannot say this)."""
        state = self.env.state
        mask = self.controlled_mask & world_done[:, None]
        in_done_world = world_done.repeat_interleave(
            self.max_agent_count)[self.flat_ids]
        at_limit = state.steps_remaining.reshape(-1)[self.flat_ids] == 0
        vals = torch.stack([
            (state.collided_road * mask).sum(),
            (state.collided_vehicle * mask).sum(),
            (state.collided_non_vehicle * mask).sum(),
            (state.reached_goal * mask).sum(),
            mask.sum(),
            (~prev_dead & in_done_world & at_limit).sum(),
        ]).long().tolist()
        self.info_dict = {
            "off_road": float(vals[0]),
            "veh_collisions": float(vals[1]),
            "non_veh_collision": float(vals[2]),
            "goal_achieved": float(vals[3]),
            "num_controlled_agents": vals[4],
            "truncated": vals[5],
        }

    def render_env(self) -> None:
        """Add this step's frame of each of the first k worlds (reference:
        sb3_wrapper.py render_env/log_video_to_wandb)."""
        for w in range(min(self.render_k_scenarios, self.num_worlds)):
            self._frames.setdefault(w, []).append(self.env.render(w))

    def _flush_videos(self, done_world_ids) -> None:
        """At an episode's end, each finished rendered world's frames go to
        wandb when a run is active, else into ``video_dir`` as a GIF."""
        from gpudrive_lab_torch.visualize.video import save_video

        for w in done_world_ids:
            frames = self._frames.pop(w, None)
            if not frames:
                continue
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None and wandb.run is not None:
                arr = np.stack(frames).transpose(0, 3, 1, 2)
                wandb.log({f"videos/world_{w}": wandb.Video(arr, fps=15)})
                continue
            if self.video_dir:
                from pathlib import Path

                Path(self.video_dir).mkdir(parents=True, exist_ok=True)
                save_video(
                    frames,
                    f"{self.video_dir}/world_{w}_ep{self.num_episodes}.gif",
                )

    def close(self):
        pass

    def resample_scenario_batch(self):
        self.env.swap_data_batch()
        self._refresh_mask()

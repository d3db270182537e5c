"""Vectorized flat-agent environment (port of
``gpudrive_lab_tpu/env/env_vec.py``).

The reference's PufferLib wrapper (reference: gpudrive/env/env_puffer.py:
29-514) without the pufferlib dependency: the multi-agent sim as a flat
vector env over the *controlled* agent slots (obs [N, D], actions [N]),
with per-world auto-reset, episode statistics (goal, collision, off-road
and truncation rates), scene resampling and data-coverage accounting.

Observations, rewards and terminals stay tensors on the env's device; the
flat ids are a device index tensor.  The host reads one [W] flag per step
(which worlds finished) and, on a step that finishes a world, the episode
statistics of every world at once.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv


class VecGPUDriveEnv:
    def __init__(
        self,
        config: EnvConfig,
        data_loader: SceneDataLoader,
        resample_interval: Optional[int] = None,
        device=None,
    ):
        self.env = GPUDriveTorchEnv(config, data_loader=data_loader,
                                    device=device)
        self.config = config
        self.device = self.env.device
        self.resample_interval = resample_interval
        self.global_step = 0
        self._steps_since_resample = 0
        self.num_worlds = self.env.num_worlds
        self.data_coverage: set = set()
        self._refresh_masks()
        self.episode_returns = torch.zeros(self.num_worlds,
                                           dtype=torch.float64,
                                           device=self.device)
        self.episode_lengths = torch.zeros(self.num_worlds,
                                           dtype=torch.int64,
                                           device=self.device)
        self.stats_buffer: List[dict] = []

    # -- mask bookkeeping -------------------------------------------------

    def _refresh_masks(self):
        self.max_agents = self.env.max_agent_count
        self.controlled_mask = self.env.cont_agent_mask
        self.flat_ids = torch.nonzero(
            self.controlled_mask.reshape(-1))[:, 0]
        self.num_agents = int(self.flat_ids.numel())
        self.data_coverage_add()

    def data_coverage_add(self):
        """Track the unique scenes seen (reference: env_puffer.py:485-514)."""
        self.data_coverage.update(self.env.scene_paths)

    # -- vec API ----------------------------------------------------------

    @property
    def single_observation_dim(self) -> int:
        return self.env.observation_dim

    @property
    def single_action_space_n(self) -> int:
        return self.env.action_space_n

    def _flat(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape((self.num_worlds * self.max_agents,)
                         + x.shape[2:])[self.flat_ids]

    def reset(self) -> torch.Tensor:
        obs = self.env.reset()
        self.episode_returns.zero_()
        self.episode_lengths.zero_()
        return self._flat(obs)

    def step(self, actions):
        """``actions`` [N] discrete indices for the controlled agents.
        Returns (obs [N, D], rewards [N], terminals [N] bool, truncations
        [N] bool, infos) (reference: env_puffer.py:235-403)."""
        W, A = self.num_worlds, self.max_agents
        full = torch.zeros(W * A, dtype=torch.int64, device=self.device)
        full[self.flat_ids] = torch.as_tensor(
            actions, device=self.device).reshape(-1).long()
        self.env.step_dynamics(full.reshape(W, A))

        rewards_full = self.env.get_rewards()
        dones_full = self.env.get_dones() > 0
        ctrl = self.controlled_mask
        n_ctrl = ctrl.sum(dim=1).clamp(min=1)
        self.episode_returns += ((rewards_full * ctrl).sum(dim=1).double()
                                 / n_ctrl)
        self.episode_lengths += 1

        # a world is finished when every controlled agent is done
        world_done = (dones_full | ~ctrl).all(dim=1)
        done_ids = torch.nonzero(world_done)[:, 0].tolist()
        episode_stats = []
        if done_ids:
            episode_stats = self._episode_stats(done_ids)
            self.env.reset(env_idx_list=done_ids)
            self.episode_returns.masked_fill_(world_done, 0)
            self.episode_lengths.masked_fill_(world_done, 0)
        self.stats_buffer.extend(episode_stats)

        self.global_step += self.num_agents
        self._steps_since_resample += self.num_agents

        # this step's outputs over the current scene's agent slots, taken
        # before a resample changes them
        rewards = self._flat(rewards_full)
        terminals = self._flat(dones_full)
        truncations = torch.zeros_like(terminals)

        if (self.resample_interval
                and self._steps_since_resample >= self.resample_interval):
            # the agent count (and so the obs rows) can change: callers
            # re-derive their buffers, as with the reference's resample
            self.resample_scenario_batch()

        obs = self._flat(self.env.get_obs())
        return obs, rewards, terminals, truncations, {
            "episode_stats": episode_stats}

    def _episode_stats(self, done_ids: List[int]) -> List[dict]:
        """The finished worlds' episode records, from one host read of
        every world's counts."""
        infos = self.env.get_infos()
        ctrl = self.controlled_mask
        goal = infos["goal_achieved"] * ctrl
        coll = infos["collided"].clamp(0, 1) * ctrl
        off = infos["off_road"].clamp(0, 1) * ctrl
        truncated = ((goal == 0) & (coll == 0) & (off == 0)) & ctrl
        counts = torch.stack([
            goal.sum(dim=1), coll.sum(dim=1), off.sum(dim=1),
            truncated.sum(dim=1), ctrl.sum(dim=1).clamp(min=1),
            self.episode_lengths,
        ]).long().cpu().tolist()
        returns = self.episode_returns.cpu().tolist()
        g, c, o, tr, n, length = counts
        return [
            dict(
                world=w,
                episode_return=returns[w],
                episode_length=length[w],
                perc_goal_achieved=g[w] / n[w],
                perc_veh_collisions=c[w] / n[w],
                perc_off_road=o[w] / n[w],
                perc_truncated=tr[w] / n[w],
            )
            for w in done_ids
        ]

    def resample_scenario_batch(self):
        """reference: env_puffer.py:438-454."""
        self.env.swap_data_batch()
        self._refresh_masks()
        self._steps_since_resample = 0
        self.episode_returns.zero_()
        self.episode_lengths.zero_()

    def pop_stats(self) -> List[dict]:
        out, self.stats_buffer = self.stats_buffer, []
        return out

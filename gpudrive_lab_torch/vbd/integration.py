"""The VBD integration surface (port of
``gpudrive_lab_tpu/vbd/integration.py``; reference:
gpudrive/integrations/vbd/ and env_torch.py:132-245, 947-1170, 1386-1443).

A diffusion sim-agent model's predicted trajectories feed (a) a reward
term for staying near them and (b) an egocentric 91 x 5 trajectory block
appended to the policy observation.  The trajectories come from a
*trajectory source*: anything that returns [W, A, T, 5] global-frame
(x, y, yaw, vel_x, vel_y) predictions for a scene and state.
``LogReplaySource`` (the logged trajectories) is the built-in source;
``VBDTrajectorySource`` (the TPU-first denoiser, vbd/model.py) and
``OfficialVBDSource`` (the released checkpoint's architecture,
vbd/model_official.py) sample them by reverse diffusion.
"""

from __future__ import annotations

from typing import Optional, Protocol

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.types import Scene, SimState
from gpudrive_lab_torch.utils.profiling import span
from gpudrive_lab_torch.vbd.data_utils import (
    VBDSampleConfig,
    official_inputs,
    process_scenario_data,
)
from gpudrive_lab_torch.vbd.model import DDPMScheduler, sample_denoiser
from gpudrive_lab_torch.vbd.model_official import sample_official

VBD_FEATURES = 5  # x, y, yaw, vel_x, vel_y
VBD_OBS_DIM = C.TRAJECTORY_LEN * VBD_FEATURES  # 455


class TrajectorySource(Protocol):
    def __call__(self, scene: Scene, state: SimState) -> torch.Tensor:
        """Returns [W, A, T, 5] predicted global trajectories."""


def log_replay_trajectories(scene: Scene, state: SimState) -> torch.Tensor:
    """The logged trajectories as (x, y, yaw, vx, vy): the reference's
    `distance_to_logs` trajectory source in the VBD layout."""
    ag = scene.agents
    return torch.cat([ag.traj_pos, ag.traj_yaw[..., None], ag.traj_vel],
                     dim=-1)


class LogReplaySource:
    def __call__(self, scene: Scene, state: SimState) -> torch.Tensor:
        return log_replay_trajectories(scene, state)


def scatter_trajectories(trajs: torch.Tensor, agent_ids: torch.Tensor,
                         num_agents: int) -> torch.Tensor:
    """Denoised trajectories [W, N, F, 5] of the sample batch's agents
    (``agent_ids`` [W, N], -1 padding) -> [W, num_agents, T, 5] on the
    sim's agent rows, the last frame held after F; zero rows for agents
    the batch left out (JAX integration.py:87-96, as one index scatter on
    the device: padding goes to a spare row that is dropped)."""
    W, N, F_len = trajs.shape[:3]
    T = C.TRAJECTORY_LEN
    F_len = min(F_len, T)
    held = torch.cat([trajs[:, :, :F_len],
                      trajs[:, :, F_len - 1:F_len].expand(W, N, T - F_len,
                                                          VBD_FEATURES)],
                     dim=2)
    spare = W * num_agents
    ids = agent_ids.long()
    rows = torch.where(
        ids >= 0, torch.arange(W, device=ids.device)[:, None] * num_agents
        + ids, spare)
    full = trajs.new_zeros((spare + 1, T, VBD_FEATURES))
    full.index_copy_(0, rows.flatten(), held.flatten(0, 1))
    return full[:spare].reshape(W, num_agents, T, VBD_FEATURES)


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


class VBDTrajectorySource:
    """The TrajectorySource protocol driven by the TPU-first denoiser
    (vbd/model.py): build the sample batch from the sim state, run reverse
    diffusion, scatter the denoised trajectories back to the sim's agent
    rows (reference: env_torch.py:1386-1443 _generate_vbd_trajectories).
    ``noise`` (a generator on the model's device seeded ``seed``) supplies
    the sampler's draws."""

    def __init__(self, model, scheduler: DDPMScheduler, config,
                 seed: int = 0):
        self.model = model
        self.scheduler = scheduler
        self.config = config
        self.noise = torch.Generator(_device_of(model)).manual_seed(seed)

    def __call__(self, scene: Scene, state: SimState) -> torch.Tensor:
        cfg = self.config
        batch = process_scenario_data(
            scene, state, current_step=0,
            config=VBDSampleConfig(max_agents=cfg.agents_len))
        out = sample_denoiser(self.model, self.scheduler, batch, cfg,
                              self.noise)
        return scatter_trajectories(out["denoised_trajs"],
                                    batch["agents_id"], state.pos.shape[1])


class OfficialVBDSource:
    """TrajectorySource backed by the released checkpoint's architecture:
    load one with ``from_checkpoint`` (vbd.convert.load_vbd_checkpoint),
    then hand it to ``env.set_vbd_trajectories`` (reference:
    sim_agent/sim_actor.py, the VBDTest actor pipeline).  ``noise`` as in
    ``VBDTrajectorySource``."""

    def __init__(self, model, config=None, seed: int = 0,
                 scheduler: Optional[DDPMScheduler] = None):
        self.model = model
        self.config = config or model.config
        self.scheduler = scheduler or DDPMScheduler(
            steps=self.config.diffusion_steps)
        self.noise = torch.Generator(_device_of(model)).manual_seed(seed)

    @classmethod
    def from_checkpoint(cls, path: str, seed: int = 0, device=None):
        from gpudrive_lab_torch.vbd.convert import load_vbd_checkpoint

        model, config = load_vbd_checkpoint(path, device)
        return cls(model, config, seed=seed)

    def __call__(self, scene: Scene, state: SimState) -> torch.Tensor:
        """The sample as span ``vbd.sample`` around ``vbd.prepare`` (the
        host's batch, ``vbd.batch``, and the inputs with the relations on
        the device, ``vbd.inputs``), the sampler's spans and
        ``vbd.scatter``."""
        cfg = self.config
        with span("vbd.sample"):
            with span("vbd.prepare"):
                with span("vbd.batch"):
                    batch = process_scenario_data(
                        scene, state, current_step=0,
                        config=VBDSampleConfig(max_agents=cfg.agents_len))
                with span("vbd.inputs"):
                    inputs = official_inputs(batch)
            out = sample_official(self.model, self.scheduler, inputs, cfg,
                                  self.noise)
            with span("vbd.scatter"):
                return scatter_trajectories(out["denoised_trajs"],
                                            batch["agents_id"],
                                            state.pos.shape[1])


def egocentric_vbd_obs(state: SimState,
                       vbd_trajectories: torch.Tensor) -> torch.Tensor:
    """Global [W, A, T, 5] predictions in each agent's frame, flattened to
    the 455-float obs block (reference: env_torch.py:947-1170
    _get_vbd_obs, batched)."""
    pos = state.pos[:, :, None, :]  # [W, A, 1, 2]
    yaw = state.yaw[:, :, None]
    c = torch.cos(yaw)
    s = torch.sin(yaw)
    rel = vbd_trajectories[..., 0:2] - pos
    x = c * rel[..., 0] + s * rel[..., 1]
    y = -s * rel[..., 0] + c * rel[..., 1]
    rel_yaw = vbd_trajectories[..., 2] - yaw
    rel_yaw = torch.atan2(torch.sin(rel_yaw), torch.cos(rel_yaw))
    vx = c * vbd_trajectories[..., 3] + s * vbd_trajectories[..., 4]
    vy = -s * vbd_trajectories[..., 3] + c * vbd_trajectories[..., 4]
    return torch.stack([x, y, rel_yaw, vx, vy], dim=-1).flatten(2)


def vbd_distance_reward(state: SimState, vbd_trajectories: torch.Tensor,
                        world_time_steps: torch.Tensor,
                        weight: float = 0.01) -> torch.Tensor:
    """weight * exp(-distance to the predicted position at the world's
    step) (reference: env_torch.py get_rewards, distance_to_vdb_trajs)."""
    t = torch.clamp(world_time_steps, 0, vbd_trajectories.shape[2] - 1).long()
    W, A = vbd_trajectories.shape[:2]
    idx = t[:, None, None, None].expand(W, A, 1, 2)
    traj_t = torch.gather(vbd_trajectories[..., 0:2], 2, idx)[:, :, 0]
    dist = torch.linalg.norm(traj_t - state.pos, dim=-1)
    return weight * torch.exp(-dist)

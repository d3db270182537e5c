"""Policy rollout: the serving path of the slice.

Each step: get the observation, run the policy, sample actions, step the
dynamics, compute rewards and dones, and reset the finished worlds as a
per-world select.  With ``sensors`` every step also collects the lidar
(with the step's actions), the BEV grid and the camera views of the stepped
state, as ``bench.py --lidar --bev --camera`` does, and reduces each whole
output into a checksum.  This is what the JAX package's
``examples/03_policy_rollout.py`` and ``agents/policy_actor.py`` do, with
every tensor staying on the env's device.

``slice_env`` and ``slice_policy`` build the slice's configuration (the
JAX package's ``bench.py`` headline one with the policy in the loop), so
that every driver of the main path runs the same one.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import torch

from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionPolicy,
    PolicyConfig,
    sample_logits,
)
from gpudrive_lab_torch.utils import profiling
from gpudrive_lab_torch.utils.profiling import span

# EnvConfig options of the slice: classic dynamics with the 91-action
# table, collisions ignored, KNN road observation (K = 200), and the
# weighted_combination reward.
SLICE_CONFIG = dict(
    dynamics_model="classic", collision_behavior="ignore",
    road_obs_algorithm="k_nearest_roadpoints",
    reward_type="weighted_combination", collision_weight=-0.75,
    off_road_weight=-0.75, goal_achieved_weight=1.0,
)


def pool_scene_paths(root: str) -> list[str]:
    """The slice's worlds: the scenes of ``data/pool_v3`` under the
    repository ``root``, sorted (512 in the repository)."""
    return sorted(glob.glob(os.path.join(root, "data", "pool_v3", "*.json")))


def slice_env(scene_paths, device=None, max_roads=None,
              **overrides) -> GPUDriveTorchEnv:
    """The slice's env over ``scene_paths`` (128 agent rows), with
    ``overrides`` of SLICE_CONFIG (e.g. ``use_tile_collision=True``)."""
    cfg = EnvConfig(**{**SLICE_CONFIG, **overrides})
    return GPUDriveTorchEnv(cfg, scene_paths, max_roads=max_roads,
                            device=device)


def slice_policy(device=None, seed: int = 0) -> LateFusionPolicy:
    """The slice's policy: default PolicyConfig widths with the partner and
    road blocks through the fused embed+pool kernel, weights drawn from
    ``seed``, in eval mode."""
    return LateFusionPolicy(
        PolicyConfig(fused_embed=True), device=device,
        generator=torch.Generator().manual_seed(seed),
    ).eval()


@dataclasses.dataclass
class RolloutResult:
    actions: torch.Tensor  # [S, W, A] int32 sampled action indices
    rewards: torch.Tensor  # [S, W, A] float32 shaped rewards
    dones: torch.Tensor  # [S, W, A] float32, before the worlds' reset
    sim_ms: float  # total time in observation, step, rewards and reset
    policy_ms: float  # total time in the policy forward and sampling
    # with sensors: total time in each sensor (lidar, bev, camera), its
    # output reduced included, and the sum of every sensor output
    sensor_ms: dict | None = None
    sensor_sum: torch.Tensor | None = None


# rollout()'s phases, each timed by its span "rollout.<phase>"
ROLLOUT_PHASES = ("obs", "policy", "step", "lidar", "bev", "camera", "reset")


def rollout(
    env: GPUDriveTorchEnv,
    policy: LateFusionPolicy,
    steps: int,
    generator: torch.Generator | None,
    deterministic: bool = False,
    sensors: bool = False,
) -> RolloutResult:
    """Run ``steps`` env steps from the env's current state with actions
    sampled from ``policy`` (argmax when ``deterministic``).  ``generator``
    draws the samples and lives on the env's device.  ``sensors`` also
    collects the lidar, BEV and camera observations on every step.  The
    phases' times are the ``rollout.*`` spans' (``utils/profiling.py``):
    only those record in this call, unless a profiler session or another
    ``recording()`` block records every span."""
    W, A = env.num_worlds, env.max_agent_count
    actions, rewards, dones = [], [], []
    acc = torch.zeros((), dtype=torch.float32, device=env.device)
    with torch.no_grad(), profiling.recording(
            "rollout." + k for k in ROLLOUT_PHASES) as first:
        for _ in range(steps):
            with span("rollout.obs"):
                obs = env.get_obs()
            with span("rollout.policy"):
                logits, _ = policy(obs.reshape(W * A, -1))
                action, _, _ = sample_logits(
                    generator, logits, deterministic=deterministic
                )
            with span("rollout.step"):
                act = env.action_values(action.reshape(W, A))
                env.step_dynamics(act)
                rewards.append(env.get_rewards())
                dones.append(env.get_dones())
            if sensors:
                with span("rollout.lidar"):
                    acc = acc + env.get_lidar_obs(act)[..., 0].sum()
                with span("rollout.bev"):
                    acc = acc + env.get_bev_obs().sum()
                with span("rollout.camera"):
                    rgb, depth = env.get_camera_obs()
                    acc = acc + depth.sum() + rgb[..., 0].sum(
                        dtype=torch.float32)
                    del rgb, depth
            with span("rollout.reset"):
                env.reset_worlds(env.world_done())
            actions.append(action.reshape(W, A))
        ms = {k: sum(profiling.span_ms("rollout." + k, start=first))
              for k in ROLLOUT_PHASES}
    return RolloutResult(
        actions=torch.stack(actions) if actions else None,
        rewards=torch.stack(rewards) if rewards else None,
        dones=torch.stack(dones) if dones else None,
        sim_ms=ms["obs"] + ms["step"] + ms["reset"],
        policy_ms=ms["policy"],
        sensor_ms={k: ms[k] for k in ("lidar", "bev", "camera")}
        if sensors else None,
        sensor_sum=acc if sensors else None,
    )

"""Imitation-learning data generation (port of
``gpudrive_lab_tpu/il/data_generation.py``; reference:
baselines/il/imitation_data_generation.py:41-278
generate_state_action_pairs).

Replays the logged experts through the simulator for a whole episode and
records the flat observations, the continuous expert actions and their
indices on the action grid, the alive, partner and road masks and the
world-frame positions and headings.  Every frame stays on the env's device
(written into tensors allocated once); ``save_path`` copies them to the
host once, into an ``.npz``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv


def map_to_closest_discrete_value(values, grid):
    """Snap continuous actions onto the action grid (reference:
    imitation_data_generation.py:27-38): (grid[idx], idx) with idx the
    first nearest entry, computed in the inputs' dtype as numpy would."""
    values = torch.as_tensor(values)
    grid = torch.as_tensor(np.asarray(grid), device=values.device)
    idx = torch.abs(values[..., None] - grid).argmin(dim=-1)
    return grid[idx], idx


def generate_state_action_pairs(env: GPUDriveTorchEnv,
                                save_path: str | None = None,
                                discretize: bool = True,
                                use_action_indices: bool = True) -> dict:
    """Roll out all-expert episodes and record, as tensors on the env's
    device (A is the env's agent rows):

      obs          [T, W, A, obs_dim]
      actions      [T, W, A, 3]   continuous expert actions
      action_idx   [T, W, A]      index on the action grid (discretize)
      dead_mask    [T, W, A]      the agent is done
      partner_mask [T, W, A, 127]
      road_mask    [T, W, A, K]
      positions    [T, W, A, 2], yaw [T, W, A]
      controlled_mask, valid_mask [W, A]

    ``use_action_indices`` is accepted, as in the JAX package, where it
    changes nothing."""
    expert = env.get_expert_actions()[0]  # [W, A, T, 10]
    obs = env.reset()
    T = C.EPISODE_LEN
    W, A, K = env.num_worlds, env.max_agent_count, C.MAX_AGENT_MAP_OBS
    dev = env.device
    out = {
        "obs": torch.empty((T,) + tuple(obs.shape), dtype=obs.dtype,
                           device=dev),
        "actions": torch.empty((T, W, A, 3), device=dev),
        "dead_mask": torch.empty((T, W, A), dtype=torch.bool, device=dev),
        # disabled modalities give no mask: zeros are stored
        "partner_mask": torch.zeros((T, W, A, C.MAX_AGENTS - 1),
                                    dtype=torch.int32, device=dev),
        "road_mask": torch.zeros((T, W, A, K), dtype=torch.bool, device=dev),
        "positions": torch.empty((T, W, A, 2), device=dev),
        "yaw": torch.empty((T, W, A), device=dev),
    }
    for t in range(T):
        out["obs"][t] = obs
        out["dead_mask"][t] = env.get_dones() > 0
        pm, rm = env.get_partner_mask(), env.get_road_mask()
        if pm is not None:
            out["partner_mask"][t] = pm
        if rm is not None:
            out["road_mask"][t] = rm
        out["positions"][t] = env.state.pos
        out["yaw"][t] = env.state.yaw
        act_t = expert[:, :, t]
        out["actions"][t] = act_t[..., :3]
        env.step_dynamics(act_t)
        obs = env.get_obs()
    # the world-frame history feeds the position probes and the
    # intervention analysis (il.analysis.probe_labels_from_positions)
    out["controlled_mask"] = env.cont_agent_mask.clone()
    out["valid_mask"] = env.scene.agents.valid.clone()

    if discretize and env.action_keys is not None:
        # snap each dimension onto its grid, then the index of the
        # cartesian product (reference: :27-38, :150-190)
        cfg = env.config
        if cfg.dynamics_model in ("classic", "bicycle"):
            grids = (cfg.accel_actions, cfg.steer_actions,
                     cfg.head_tilt_actions)
        else:
            grids = (cfg.dx, cfg.dy, cfg.dyaw)
        idx = [map_to_closest_discrete_value(out["actions"][..., d], g)[1]
               for d, g in enumerate(grids)]
        n1, n2 = len(grids[1]), len(grids[2])
        out["action_idx"] = (idx[0] * n1 + idx[1]) * n2 + idx[2]

    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        np.savez_compressed(save_path, **{k: v.cpu().numpy()
                                          for k, v in out.items()})
    return out

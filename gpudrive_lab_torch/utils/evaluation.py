"""Policy evaluation rollouts (port of ``gpudrive_lab_tpu/utils/
evaluation.py``; reference: examples/experimental/eval_utils.py rollout and
evaluate_policy): roll a policy, or the logged experts, over the env's
scene batches and report per-scene and mean goal, collision and off-road
rates.  The rollout stays on the env's device; the rates are read on the
host once, at the end of each episode."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionPolicy,
    sample_logits,
)


def rollout(
    env: GPUDriveTorchEnv,
    select_actions: Optional[Callable] = None,
    max_steps: Optional[int] = None,
) -> dict:
    """One episode on the current scene batch.

    ``select_actions(obs [W, A, D])`` -> [W, A] action indices; None
    replays the experts.  Returns per-world metrics."""
    obs = env.reset()
    expert_actions = None
    if select_actions is None:
        expert_actions = env.get_expert_actions()[0]
    with torch.no_grad():
        for t in range(max_steps or env.episode_len):
            if select_actions is None:
                env.step_dynamics(expert_actions[:, :, t])
            else:
                env.step_dynamics(select_actions(obs))
            obs = env.get_obs()
            if bool(env.get_dones().all()):
                break

    infos = {k: v.cpu().numpy() for k, v in env.get_infos().items()}
    ctrl = env.cont_agent_mask.cpu().numpy()
    valid = env.scene.agents.valid.cpu().numpy()
    mask = ctrl if ctrl.any() else valid
    n = np.maximum(mask.sum(axis=1), 1)
    goal = (infos["goal_achieved"] * mask).sum(axis=1) / n
    coll = (np.clip(infos["collided"], 0, 1) * mask).sum(axis=1) / n
    off = (np.clip(infos["off_road"], 0, 1) * mask).sum(axis=1) / n
    names = env.get_env_filenames()
    return {
        "per_scene": [
            dict(scene=names[w], goal_achieved=float(goal[w]),
                 collided=float(coll[w]), off_road=float(off[w]))
            for w in range(env.num_worlds)
        ],
        "goal_achieved": float(goal.mean()),
        "collided": float(coll.mean()),
        "off_road": float(off.mean()),
    }


def evaluate_policy(
    env: GPUDriveTorchEnv,
    policy: LateFusionPolicy,
    variables=None,
    num_batches: int = 1,
    deterministic: bool = True,
    seed: int = 0,
) -> dict:
    """Evaluate a late-fusion policy over ``num_batches`` scene batches,
    swapping in the loader's next batch between them (reference:
    eval_utils.evaluate_policy).  ``variables``, a state_dict, is loaded
    into ``policy`` first when given; samples (when not
    ``deterministic``) come from a generator on the policy's device seeded
    with ``seed``."""
    if variables is not None:
        policy.load_state_dict(variables)
    dev = next(policy.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    W = env.num_worlds

    def select(obs):
        logits, _ = policy(obs.reshape(W * obs.shape[1], -1))
        a, _, _ = sample_logits(gen, logits, deterministic=deterministic)
        return a.reshape(W, -1)

    results = []
    for b in range(num_batches):
        results.append(rollout(env, select))
        if b + 1 < num_batches:
            env.swap_data_batch()
    agg = {
        k: float(np.mean([r[k] for r in results]))
        for k in ("goal_achieved", "collided", "off_road")
    }
    agg["per_scene"] = [s for r in results for s in r["per_scene"]]
    return agg

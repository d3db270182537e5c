"""Multi-policy rollouts (port of ``gpudrive_lab_tpu/utils/
multi_policy_rollout.py``; reference: gpudrive/utils/multi_policy_rollout.py:
6-195): several policies drive disjoint agent masks of the same worlds,
and each gets its own goal, collision and off-road rates."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from gpudrive_lab_torch.agents.core import merge_actions


def multi_policy_rollout(
    env,
    policies: Dict[str, object],
    masks: Dict[str, torch.Tensor],
    deterministic: bool = False,
    render_sim_state: bool = False,
    zoom_radius: float = 50.0,
    max_steps: Optional[int] = None,
    render_worlds=(0,),
):
    """policies: {name: actor with .select_action(obs)};
    masks: {name: [W, A] bool}, disjoint subsets of the controlled mask.
    Returns {name: {goal_achieved, collided, off_road}} fractions, and with
    ``render_sim_state`` also the frames: per step, the list of
    ``render_worlds``' RGB arrays.  ``render_sim_state`` needs ``env.vis``
    and raises at once without it, rather than collecting a video of
    Nones."""
    if render_sim_state and not hasattr(env, "vis"):
        raise ValueError(
            "render_sim_state=True needs an env with a .vis visualizer "
            "(GPUDriveTorchEnv has one)")
    obs = env.reset()
    W, A = env.num_worlds, env.max_agent_count
    steps = max_steps or env.episode_len
    masks = {k: torch.as_tensor(m, device=env.device) for k, m in
             masks.items()}
    ids = {k: torch.nonzero(m.reshape(-1))[:, 0] for k, m in masks.items()}
    ref = torch.zeros((W, A), device=env.device)
    frames = []

    with torch.no_grad():
        for _ in range(steps):
            flat = obs.reshape(W * A, -1)
            actions = {name: policies[name].select_action(flat[ids[name]])
                       for name in policies}
            env.step_dynamics(merge_actions(actions, ids, ref))
            obs = env.get_obs()
            if render_sim_state:
                frames.append(env.vis.plot_simulator_state(
                    env.state, list(render_worlds), zoom_radius=zoom_radius))
            if bool(env.get_dones().all()):
                break

    infos = env.get_infos()
    metrics = {}
    for name, m in masks.items():
        n = max(int(m.sum()), 1)
        metrics[name] = {
            key: int((infos[col] * m).sum()) / n
            for key, col in (("goal_achieved", "goal_achieved"),
                             ("collided", "collided"),
                             ("off_road", "off_road"))
        }
    return (metrics, frames) if render_sim_state else metrics

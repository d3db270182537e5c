"""Linearised game dynamics for IBR / iLQ-style guidance (port of
``gpudrive_lab_tpu/vbd/ilq.py``; reference:
gpudrive/integrations/vbd/sim_agent/guidance_metrics/ilqgame.py): a
one-action-block unicycle rollout and its Jacobians (A, B), for the
iterative-best-response guidance mode (sim_actor.py ibr_guidance).

States are [..., 5] = (x, y, theta, v_x, v_y); actions [..., 2] =
(accel, yaw_rate).
"""

from __future__ import annotations

import math

import torch
from torch.func import jacfwd, vmap


def wrap_angle(angle):
    return (angle + math.pi) % (2 * math.pi) - math.pi


def dynamics(current_states, actions, dt: float = 0.1, action_len: int = 2):
    """Apply one action held for ``action_len`` substeps; returns the final
    state (reference: ilqgame.py dynamics).  The speed clamps at 0 and the
    yaw rate is zeroed below 0.1 m/s, as the sampler's roll_out."""
    x = current_states[..., 0:1]
    y = current_states[..., 1:2]
    theta = current_states[..., 2:3]
    v = torch.hypot(current_states[..., 3:4], current_states[..., 4:5])

    accel = actions[..., None, 0].repeat_interleave(action_len, dim=-1)
    yaw_rate = actions[..., None, 1].repeat_interleave(action_len, dim=-1)

    v = torch.clamp(v + torch.cumsum(accel * dt, dim=-1), min=0.0)
    yaw_rate = torch.where(v > 0.1, yaw_rate, 0.0)
    theta = wrap_angle(torch.cumsum(yaw_rate * dt, dim=-1) + theta)
    v_x = v * torch.cos(theta)
    v_y = v * torch.sin(theta)
    x = torch.cumsum(v_x * dt, dim=-1) + x
    y = torch.cumsum(v_y * dt, dim=-1) + y
    return torch.stack([x, y, theta, v_x, v_y], dim=-1)[..., -1, :]


def linearize(state_start, pred_action):
    """Per-element Jacobians of ``dynamics`` (A = df/dx [..., 5, 5],
    B = df/du [..., 5, 2]) by forward-mode differentiation (reference:
    ilqgame.py get_A_and_B)."""
    lead = state_start.shape[:-1]
    jac = vmap(jacfwd(dynamics, argnums=(0, 1)))
    A, B = jac(state_start.reshape(-1, 5), pred_action.reshape(-1, 2))
    return A.reshape(lead + (5, 5)), B.reshape(lead + (5, 2))

"""Vehicle dynamics models of the plain reference: a frozen copy of the
port's ``core/dynamics.py`` (reference: src/dynamics.hpp), dt = 0.1.
"""

import torch

from . import constants as C
from .geometry import angle_add, rotate_out_of_frame
from .types import vec_norm

DT = C.DYNAMICS_DT


def forward_classic(action, length, pos, yaw, vel):
    """Nocturne-style kinematic bicycle, average-speed variant
    (reference: src/dynamics.hpp:11-50)."""
    accel = action[..., 0]
    steer = action[..., 1]
    speed = vec_norm(vel)
    v = speed + 0.5 * accel * DT
    tan_delta = torch.tan(steer)
    beta = torch.atan(0.5 * tan_delta)
    d = torch.stack(
        [v * torch.cos(yaw + beta), v * torch.sin(yaw + beta)], dim=-1
    )
    w = v * torch.cos(beta) * tan_delta / length
    new_yaw = angle_add(yaw, w * DT)
    new_speed = speed + accel * DT
    new_pos = pos + d * DT
    new_vel = torch.stack(
        [new_speed * torch.cos(new_yaw), new_speed * torch.sin(new_yaw)],
        dim=-1,
    )
    return new_pos, new_yaw, new_vel, w


def forward_invertible_bicycle(action, pos, yaw, vel):
    """Waymax-style invertible bicycle; accel clipped to +-6, steering to
    +-3 (reference: src/dynamics.hpp:52-81)."""
    accel = torch.clamp(action[..., 0], -6.0, 6.0)
    steer = torch.clamp(action[..., 1], -3.0, 3.0)
    speed = vec_norm(vel)
    new_x = (pos[..., 0] + vel[..., 0] * DT
             + 0.5 * accel * torch.cos(yaw) * DT * DT)
    new_y = (pos[..., 1] + vel[..., 1] * DT
             + 0.5 * accel * torch.sin(yaw) * DT * DT)
    delta_yaw = steer * (speed * DT + 0.5 * accel * DT * DT)
    new_yaw = angle_add(yaw, delta_yaw)
    new_speed = speed + accel * DT
    new_vel = torch.stack(
        [new_speed * torch.cos(new_yaw), new_speed * torch.sin(new_yaw)],
        dim=-1,
    )
    return (torch.stack([new_x, new_y], dim=-1), new_yaw, new_vel,
            delta_yaw / DT)


def forward_delta_local(action, pos, yaw, vel):
    """Ego-frame displacement model (reference: src/dynamics.hpp:83-115)."""
    local = action[..., 0:2]
    dyaw = action[..., 2]
    d = rotate_out_of_frame(local, yaw)
    new_pos = pos + d
    new_vel = d / DT
    new_yaw = angle_add(yaw, dyaw)
    return new_pos, new_yaw, new_vel, dyaw / DT


def forward_state(action):
    """Teleport to an absolute state, no clipping
    (reference: src/dynamics.hpp:186-194)."""
    return action[..., 0:2], action[..., 3], action[..., 4:6], action[..., 9]

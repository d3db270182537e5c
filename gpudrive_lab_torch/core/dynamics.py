"""Vehicle dynamics models (port of ``gpudrive_lab_tpu/core/dynamics.py``;
reference: src/dynamics.hpp).

Four forward models and two inverse models over [W, A] batches, all with
the reference's hardcoded dt = 0.1.  Actions are rows of the 10-float action
union (reference: src/types.hpp:109-145): classic/bicycle read
[accel, steer, head_angle], delta reads [dx, dy, dyaw], state reads
[x, y, z, yaw, vx, vy, vz, wx, wy, wz].
"""

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.geometry import (
    angle_add,
    normalize_angle,
    rotate_out_of_frame,
)
from gpudrive_lab_torch.core.types import vec_norm

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


def inverse_bicycle(vel, yaw, target_vel, target_yaw):
    """Recover (accel, steer) mapping state_t -> state_{t+1}
    (reference: src/dynamics.hpp:117-149).  With USE_ESTIMATED_YAW the
    target yaw is the target velocity's direction."""
    speed = vec_norm(vel)
    target_speed = vec_norm(target_vel)
    accel = (target_speed - speed) / DT
    yaw_n = normalize_angle(yaw)
    if C.USE_ESTIMATED_YAW:
        tgt = torch.atan2(target_vel[..., 1], target_vel[..., 0])
    else:
        tgt = normalize_angle(target_yaw)
    denom = speed * DT + 0.5 * accel * DT * DT
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    steering = torch.where(
        denom != 0.0, (tgt - yaw_n) / safe, torch.zeros_like(denom)
    )
    return torch.stack([accel, steering, torch.zeros_like(accel)], dim=-1)


def inverse_delta(pos, yaw, target_pos, target_yaw):
    """Recover (dx, dy, dyaw) in the ego frame; the global delta is clipped
    to +-6 before rotation and the local delta again after, as the
    reference's double clip does (src/dynamics.hpp:151-184)."""
    d = torch.clamp(target_pos - pos, -6.0, 6.0)
    dyaw = target_yaw - yaw
    c = torch.cos(-yaw)
    s = torch.sin(-yaw)
    local_dx = d[..., 0] * c - d[..., 1] * s
    local_dy = d[..., 0] * s + d[..., 1] * c
    return torch.stack(
        [
            torch.clamp(local_dx, -6.0, 6.0),
            torch.clamp(local_dy, -6.0, 6.0),
            normalize_angle(dyaw),
        ],
        dim=-1,
    )

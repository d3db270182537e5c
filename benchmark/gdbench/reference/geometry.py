"""Angle and 2-D rigid-transform helpers of the plain reference: a frozen
copy of the port's ``core/geometry.py`` (reference: src/utils.hpp:11-65).
"""

import math

import torch

TWO_PI = 2.0 * math.pi


def normalize_angle(angle: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi] via C ``fmod`` (remainder with the sign of the
    dividend), as utils::NormalizeAngle does (reference: src/utils.hpp:11-14).
    ``torch.fmod`` is C fmod; ``torch.remainder`` would not be."""
    ret = torch.fmod(angle, TWO_PI)
    return torch.where(
        ret > math.pi, ret - TWO_PI,
        torch.where(ret < -math.pi, ret + TWO_PI, ret),
    )


def angle_add(lhs, rhs):
    """utils::AngleAdd (reference: src/utils.hpp:16-18)."""
    return normalize_angle(lhs + rhs)


def quat_yaw_diff(yaw_a, yaw_b):
    """Wrapped yaw difference b - a, as quatToYaw of quat(a)^-1 * quat(b)
    (reference: src/utils.hpp:20-25)."""
    d = yaw_b - yaw_a
    return torch.atan2(torch.sin(d), torch.cos(d))


def rotate_into_frame(rel_xy, frame_yaw):
    """World-frame offsets into an ego frame: R(-yaw) @ rel
    (reference: src/sim.cpp:180-181, 208-209)."""
    c = torch.cos(frame_yaw)
    s = torch.sin(frame_yaw)
    x = rel_xy[..., 0]
    y = rel_xy[..., 1]
    return torch.stack([c * x + s * y, -s * x + c * y], dim=-1)


def rotate_out_of_frame(local_xy, frame_yaw):
    """Ego-frame offsets into the world frame: R(yaw) @ local
    (reference: src/dynamics.hpp:89-97)."""
    c = torch.cos(frame_yaw)
    s = torch.sin(frame_yaw)
    x = local_xy[..., 0]
    y = local_xy[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)

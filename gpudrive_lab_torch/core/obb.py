"""2-D oriented-bounding-box overlap test (port of
``gpudrive_lab_tpu/core/obb.py``; reference: src/obb.hpp:11-92).

Each box projects the other box's corners onto its two edge axes,
normalised by squared edge length; overlap needs intersection on both axes
in both directions.  ``obb_overlap_sat`` is the closed-form separating-axis
equivalent used by the agent-agent collision lattice.
"""

import torch


def corners(center, yaw, half_extents):
    """Corners of an OBB in the reference's order (src/obb.hpp:22-28).
    center [..., 2]; yaw [...]; half_extents [..., 2] -> [..., 4, 2]."""
    c = torch.cos(yaw)
    s = torch.sin(yaw)
    X = torch.stack([c, s], dim=-1) * half_extents[..., 0:1]
    Y = torch.stack([-s, c], dim=-1) * half_extents[..., 1:2]
    return torch.stack(
        [center - X - Y, center + X - Y, center + X + Y, center - X + Y],
        dim=-2,
    )


def _overlaps_on_axes(own_corners, other_corners):
    """own.overlaps(other) (reference: src/obb.hpp:51-82)."""
    c0 = own_corners[..., 0, :]
    axes = torch.stack(
        [own_corners[..., 1, :] - c0, own_corners[..., 3, :] - c0], dim=-2
    )
    len2 = (axes * axes).sum(-1, keepdim=True)
    axes = axes / torch.where(len2 == 0.0, torch.ones_like(len2), len2)
    origin = (c0[..., None, :] * axes).sum(-1)
    t = torch.einsum("...ax,...cx->...ac", axes, other_corners)
    t_min = t.min(dim=-1).values
    t_max = t.max(dim=-1).values
    separated = (t_min > 1.0 + origin) | (t_max < origin)
    return ~separated.any(dim=-1)


def obb_overlap(corners_a, corners_b):
    """OrientedBoundingBox2D::hasCollided (reference: src/obb.hpp:34-37)."""
    return _overlaps_on_axes(corners_a, corners_b) & _overlaps_on_axes(
        corners_b, corners_a
    )


def obb_overlap_from_params(center_a, yaw_a, half_a, center_b, yaw_b, half_b):
    return obb_overlap(
        corners(center_a, yaw_a, half_a), corners(center_b, yaw_b, half_b)
    )


def obb_overlap_sat(center_a, yaw_a, half_a, center_b, yaw_b, half_b):
    """Closed-form separating-axis test, equivalent to the corner
    projection above (boundary-inclusive, src/obb.hpp:72).  Operands
    broadcast elementwise; returns bool[...]."""
    d = center_b - center_a
    rel = yaw_b - yaw_a
    ac = torch.abs(torch.cos(rel))
    asn = torch.abs(torch.sin(rel))

    ca = torch.cos(yaw_a)
    sa = torch.sin(yaw_a)
    dx = ca * d[..., 0] + sa * d[..., 1]
    dy = -sa * d[..., 0] + ca * d[..., 1]

    a0, a1 = half_a[..., 0], half_a[..., 1]
    b0, b1 = half_b[..., 0], half_b[..., 1]

    sep_a0 = torch.abs(dx) > a0 + b0 * ac + b1 * asn
    sep_a1 = torch.abs(dy) > a1 + b0 * asn + b1 * ac
    cb = torch.cos(yaw_b)
    sb = torch.sin(yaw_b)
    ex = cb * d[..., 0] + sb * d[..., 1]
    ey = -sb * d[..., 0] + cb * d[..., 1]
    sep_b0 = torch.abs(ex) > b0 + a0 * ac + a1 * asn
    sep_b1 = torch.abs(ey) > b1 + a0 * asn + a1 * ac

    return ~(sep_a0 | sep_a1 | sep_b0 | sep_b1)

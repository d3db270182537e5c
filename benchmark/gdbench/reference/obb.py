"""2-D oriented-bounding-box overlap of the plain reference: the
closed-form separating-axis test of the port's ``core/obb.py``
(reference: src/obb.hpp:11-92), boundary-inclusive."""

import torch


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

"""The plain agent-road SAT and the live-pair counts of kernels K2 and K1.

A frozen copy of the plain half of the port's ``core/kernels.py``: the
separating-axis test over (agent, road) pairs that K2 and K1 compute, and
the counts of the pairs and operations those kernels cannot skip, from
which the benchmark's roofline bounds are taken.

Feature rows (float32):
  agents [W, A, 8]  px, py, cos, sin, half0, half1, active, is_vehicle
  roads  [W, 8, R]  px, py, cos, sin, half0, half1, allow_veh, allow_other
"""

from __future__ import annotations

import torch


AGENT_F = 8
ROAD_F = 8
# Agents per block of the tile-skip kernel; A must be a multiple.
AGENT_BLOCK = 16
# fp32 operations per SAT pair test, counted from _sat_hits (adds,
# subtracts, multiplies and compares; abs, negation and selects not
# counted): 2 deltas, 6 for cos/sin of the relative yaw, 12 for the two
# frame rotations, 16 for the four separation bounds, 4 compares, 2 for the
# allow/active product, 1 for the running max.  The kernels build with
# --fmad=false, so each is one instruction: no FMA pairs them.
SAT_FLOPS = 43
# The same count for a pair that the first two axis tests separate, where
# sat_hit() in csrc/agent_road.cu stops: 2 deltas, 6 for cos/sin of the
# relative yaw, 6 for the rotation into the agent's frame, 8 for two
# separation bounds, 2 compares, 1 for the running max.
SAT_EARLY_FLOPS = 25


def _sat_hits(a: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """SAT over every (agent, road) pair.  a: [..., A, 8] agent rows;
    r: [..., 8, R] road rows.  Returns [..., A, R] float32, 1.0 where an
    allowed, active overlap exists.  Same expressions, same order, as the
    Pallas kernel's _sat_hits and as sat_hit() in csrc/agent_road.cu."""
    px, py = a[..., 0:1], a[..., 1:2]
    ca, sa = a[..., 2:3], a[..., 3:4]
    a0, a1 = a[..., 4:5], a[..., 5:6]
    active, is_veh = a[..., 6:7], a[..., 7:8]

    rx, ry = r[..., 0:1, :], r[..., 1:2, :]
    cb, sb = r[..., 2:3, :], r[..., 3:4, :]
    b0, b1 = r[..., 4:5, :], r[..., 5:6, :]
    allow_veh, allow_other = r[..., 6:7, :], r[..., 7:8, :]

    dx_w = rx - px
    dy_w = ry - py
    ac = torch.abs(cb * ca + sb * sa)
    asn = torch.abs(sb * ca - cb * sa)
    dxa = ca * dx_w + sa * dy_w
    dya = -sa * dx_w + ca * dy_w
    exb = cb * dx_w + sb * dy_w
    eyb = -sb * dx_w + cb * dy_w
    sep = (
        (torch.abs(dxa) > a0 + b0 * ac + b1 * asn)
        | (torch.abs(dya) > a1 + b0 * asn + b1 * ac)
        | (torch.abs(exb) > b0 + a0 * ac + a1 * asn)
        | (torch.abs(eyb) > b1 + a0 * asn + a1 * ac)
    )
    allowed = torch.where(is_veh > 0.5, allow_veh, allow_other)
    return torch.where(sep, 0.0, 1.0) * allowed * active


def agent_road_hits_dense_plain(agents: torch.Tensor, roads_t: torch.Tensor):
    """Plain version of K2: [W, A] float32 any-hit over all roads."""
    if roads_t.shape[-1] == 0:
        return agents.new_zeros(agents.shape[:2])
    return _sat_hits(agents, roads_t).amax(dim=-1)


def _live_counts(agents: torch.Tensor, roads: torch.Tensor) -> torch.Tensor:
    """[W, A, T] int64: for each agent, the roads of each tile of
    ``roads`` [W, T, 8, RT] whose pair with it can hit above +0.0, i.e.
    whose allow value for the agent's class has the sign of the agent's
    ``active`` (both > 0 or both < 0; the hit is allowed * active)."""
    act = agents[..., 6, None]  # [W, A, 1]
    veh = agents[..., 7, None] > 0.5
    veh_row, other_row = roads[:, None, :, 6], roads[:, None, :, 7]
    pos = torch.where(veh, (veh_row > 0).sum(-1), (other_row > 0).sum(-1))
    neg = torch.where(veh, (veh_row < 0).sum(-1), (other_row < 0).sum(-1))
    return torch.where(act > 0, pos, torch.where(act < 0, neg, 0))


def live_pairs(agents: torch.Tensor, roads_t: torch.Tensor) -> int:
    """Pairs of agents [W, A, 8] and roads_t [W, 8, R] that can raise an
    agent's hit above +0.0: the work K2 cannot skip."""
    return int(_live_counts(agents, roads_t[:, None]).sum())


def _pair_ops(a: torch.Tensor, r: torch.Tensor, where=None) -> int:
    """fp32 operations of the live pairs of a [..., A, 8] and r [..., 8, R]
    (inside ``where``, a bool broadcast to [..., A, R], if given):
    SAT_EARLY_FLOPS for a pair that the first two axis tests separate,
    SAT_FLOPS for the rest."""
    act = a[..., 6:7]
    allowed = torch.where(a[..., 7:8] > 0.5, r[..., 6:7, :], r[..., 7:8, :])
    live = ((act > 0) & (allowed > 0)) | ((act < 0) & (allowed < 0))
    if where is not None:
        live &= where
    px, py = a[..., 0:1], a[..., 1:2]
    ca, sa = a[..., 2:3], a[..., 3:4]
    a0, a1 = a[..., 4:5], a[..., 5:6]
    cb, sb = r[..., 2:3, :], r[..., 3:4, :]
    b0, b1 = r[..., 4:5, :], r[..., 5:6, :]
    dx_w = r[..., 0:1, :] - px
    dy_w = r[..., 1:2, :] - py
    ac = torch.abs(cb * ca + sb * sa)
    asn = torch.abs(sb * ca - cb * sa)
    early = ((torch.abs(ca * dx_w + sa * dy_w) > a0 + b0 * ac + b1 * asn)
             | (torch.abs(-sa * dx_w + ca * dy_w) > a1 + b0 * asn + b1 * ac))
    n_early = int((live & early).sum())
    return SAT_EARLY_FLOPS * n_early + SAT_FLOPS * (int(live.sum()) - n_early)


def live_pair_ops(agents: torch.Tensor, roads_t: torch.Tensor,
                  worlds: int = 16) -> int:
    """fp32 operations that K2's function needs on these inputs: the SAT of
    each pair of ``live_pairs``, stopped where the first two axis tests
    separate the boxes.  ``worlds`` worlds at a time bound the memory."""
    return sum(_pair_ops(agents[w:w + worlds], roads_t[w:w + worlds])
               for w in range(0, agents.shape[0], worlds))


def live_pair_ops_tiled(agents: torch.Tensor, tiles: torch.Tensor,
                        mask: torch.Tensor, worlds: int = 16) -> int:
    """The operations of ``live_pair_ops`` for the pairs of
    ``live_pairs_tiled``: the work K1 cannot skip."""
    live = mask.repeat_interleave(AGENT_BLOCK, dim=1).transpose(1, 2) > 0
    return sum(_pair_ops(agents[w:w + worlds, None], tiles[w:w + worlds],
                         live[w:w + worlds, ..., None])
               for w in range(0, agents.shape[0], worlds))

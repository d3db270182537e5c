"""Differentiable guidance rewards for VBD sampling (port of
``gpudrive_lab_tpu/vbd/guidance_metrics.py``; reference:
gpudrive/integrations/vbd/sim_agent/guidance_metrics/).

  * ``overlap_reward``: the OBB signed distance between every agent pair
    (overlap_metric.py:14-63 OverlapReward), closed-form: the penetration
    depth from the four separating-axis overlaps when the boxes intersect
    (the edge normals of the reference's Minkowski octagon are the four box
    axes), the least corner-to-edge distance when they are apart;
  * ``overlap_reward_simple``: the centre-distance variant
    (overlap_metric.py:66-121);
  * ``onroad_reward``: road-edge containment from each corner's signed
    distance to the nearest edge point (onroad_metric.py:11-250);
  * ``tracking_reward`` / ``goal_reward``: smooth-L1 trajectory and goal
    tracking (tracking_metric.py:6-107);
  * ``control_reward``: a quadratic action cost (control_metric.py).

Every factory returns ``reward_fn(traj_pred, action_pred, batch) ->
tensor``; the guided samplers (vbd/guidance.py) sum the rewards and ascend
them, with gradients from autograd.  Reductions over ties (``amin``,
``amax``) split the gradient evenly, as JAX's do.

Batch layout (vbd/data_utils.py): ``agents_history`` [B, N, H, 8] =
(x, y, yaw, vx, vy, length, width, height); ``agents_interested`` [B, N]
(> 0 marks a live agent); ``polylines`` [B, P, K, 5] = (x, y, heading,
traffic, etype).  Trajectories are [B, A, T, 5] = (x, y, yaw, vx, vy);
actions [B, A, T, 2] = (accel, yaw_rate).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from gpudrive_lab_torch import constants as C

RewardFn = Callable[[torch.Tensor, torch.Tensor, dict], torch.Tensor]

_EPS = 1e-9


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """torch.nn.functional.smooth_l1_loss, elementwise."""
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def obb_corners(box5: torch.Tensor) -> torch.Tensor:
    """[..., 5] (x, y, length, width, yaw) -> [..., 4, 2] corners
    (reference: onroad_metric.py corners_from_bboxes)."""
    c = torch.cos(box5[..., 4])
    s = torch.sin(box5[..., 4])
    lc = box5[..., 2] / 2 * c
    ls = box5[..., 2] / 2 * s
    wc = box5[..., 3] / 2 * c
    ws = box5[..., 3] / 2 * s
    dx = torch.stack([lc + ws, lc - ws, -lc - ws, -lc + ws], dim=-1)
    dy = torch.stack([ls - wc, ls + wc, -ls + wc, -ls - wc], dim=-1)
    return torch.stack([dx, dy], dim=-1) + box5[..., None, 0:2]


def _point_segment_dist(p, a, b):
    """Distance from points p to segments (a, b); all [..., 2]."""
    ab = b - a
    denom = torch.clamp((ab * ab).sum(-1), min=_EPS)
    t = torch.clamp(((p - a) * ab).sum(-1) / denom, 0.0, 1.0)
    d = p - (a + t[..., None] * ab)
    return torch.sqrt((d * d).sum(-1) + _EPS)


def signed_distance_obb(box_a: torch.Tensor,
                        box_b: torch.Tensor) -> torch.Tensor:
    """Signed distance between broadcast pairs of (x, y, length, width,
    yaw) boxes: minus the penetration depth when they overlap, else the
    gap (the reference's Minkowski-polygon signed distance for boxes,
    overlap_metric.py compute_overlap)."""
    d = box_b[..., 0:2] - box_a[..., 0:2]
    ya = box_a[..., 4]
    yb = box_b[..., 4]
    rel = yb - ya
    ac = torch.abs(torch.cos(rel))
    asn = torch.abs(torch.sin(rel))
    ca, sa = torch.cos(ya), torch.sin(ya)
    cb, sb = torch.cos(yb), torch.sin(yb)
    dxa = ca * d[..., 0] + sa * d[..., 1]
    dya = -sa * d[..., 0] + ca * d[..., 1]
    exb = cb * d[..., 0] + sb * d[..., 1]
    eyb = -sb * d[..., 0] + cb * d[..., 1]
    a0, a1 = box_a[..., 2] / 2, box_a[..., 3] / 2
    b0, b1 = box_b[..., 2] / 2, box_b[..., 3] / 2
    # the axis overlap margins: all four positive <=> the boxes intersect,
    # and the least is the penetration depth
    pen = torch.minimum(
        torch.minimum(a0 + b0 * ac + b1 * asn - torch.abs(dxa),
                      a1 + b0 * asn + b1 * ac - torch.abs(dya)),
        torch.minimum(b0 + a0 * ac + a1 * asn - torch.abs(exb),
                      b1 + a0 * asn + a1 * ac - torch.abs(eyb)),
    )
    ca_pts = obb_corners(box_a)  # [..., 4, 2]
    cb_pts = obb_corners(box_b)
    ca_nxt = torch.roll(ca_pts, -1, dims=-2)
    cb_nxt = torch.roll(cb_pts, -1, dims=-2)
    # corners of A against the edges of B: [..., 4 (corner), 4 (edge)]
    d_ab = _point_segment_dist(ca_pts[..., :, None, :],
                               cb_pts[..., None, :, :],
                               cb_nxt[..., None, :, :])
    d_ba = _point_segment_dist(cb_pts[..., :, None, :],
                               ca_pts[..., None, :, :],
                               ca_nxt[..., None, :, :])
    gap = torch.minimum(d_ab.amin(dim=(-2, -1)), d_ba.amin(dim=(-2, -1)))
    return torch.where(pen > 0.0, -pen, gap)


def _traj_5dof(traj_pred: torch.Tensor, batch: dict) -> torch.Tensor:
    """(x, y, length, width, yaw) boxes from the trajectories and the box
    dims of the last history step (reference: overlap_metric.py:31-39)."""
    A = traj_pred.shape[1]
    dims = batch["agents_history"][:, :A, -1, 5:7]  # [B, A, 2]
    dims = dims[:, :, None, :].expand(traj_pred.shape[:3] + (2,))
    return torch.cat([traj_pred[..., 0:2], dims, traj_pred[..., 2:3]],
                     dim=-1)


def _agent_mask(batch: dict, A: int) -> torch.Tensor:
    return (batch["agents_interested"][:, :A] > 0).to(torch.float32)


def _pick(box, m, aoi):
    if aoi is None:
        return box, m
    idx = torch.as_tensor(list(aoi), dtype=torch.long, device=box.device)
    return box[:, idx], m[:, idx]


def overlap_reward(
    clip: float = 5.0,
    weight: float = 1.0,
    aoi: Optional[Sequence[int]] = None,
    offset: float = 0.0,
    saturate: bool = False,
) -> RewardFn:
    """reference: overlap_metric.py OverlapReward.  [B, A, T, A] signed
    distances, the clipped ones removed; ascending the sum pushes close or
    overlapping pairs apart.  ``aoi`` restricts the pairs to the listed
    agents (overlap_metric.py:42-45); ``offset`` shifts the distance;
    ``saturate`` caps at ``clip`` instead of zeroing (far pairs stay at
    the ceiling, which the min over pairs of ibr guidance needs,
    sim_actor.py:440-447)."""

    def fn(traj_pred, action_pred, batch):
        box, m = _pick(_traj_5dof(traj_pred, batch),
                       _agent_mask(batch, traj_pred.shape[1]), aoi)
        A = box.shape[1]
        # box_i [B, A, T, 1, 5] against box_j [B, 1, T, A, 5]
        sd = signed_distance_obb(box[:, :, :, None],
                                 box[:, None, :, :].transpose(2, 3))
        sd = sd + offset
        valid = (m[:, :, None, None] * m[:, None, None, :]) > 0.5
        eye = torch.eye(A, dtype=torch.bool, device=box.device)[:, None, :]
        sd = torch.where(valid & ~eye[None], sd, clip)
        if saturate:
            return torch.clamp(sd, max=clip) * weight
        return sd * (sd < clip) * weight

    return fn


def overlap_reward_simple(clip: float = 5.0, weight: float = 1.0) -> RewardFn:
    """reference: overlap_metric.py OverlapRewardSimple (centre distances;
    the partner positions detached, as the reference detaches the
    transposed trajectory)."""

    def fn(traj_pred, action_pred, batch):
        A = traj_pred.shape[1]
        p = traj_pred[..., 0:2]  # [B, A, T, 2]
        d = p[:, :, :, None, :] - p.transpose(1, 2)[:, None].detach()
        dist = torch.sqrt((d * d).sum(-1) + _EPS)  # [B, A, T, A]
        m = _agent_mask(batch, A)
        valid = (m[:, :, None, None] * m[:, None, None, :]) > 0.5
        eye = torch.eye(A, dtype=torch.bool, device=p.device)[:, None, :]
        dist = torch.where(valid & ~eye[None], dist, clip)
        return dist * (dist < clip) * weight

    return fn


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _signed_dist_to_road_edge(query, polylines):
    """Per-query signed distance to the nearest road-edge point, positive
    off the road (reference: onroad_metric.py
    compute_signed_distance_to_nearest_road_edge_point); query [B, Q, 2],
    polylines [B, P, K, 5]."""
    B, P, K, _ = polylines.shape
    flat = polylines.reshape(B, P * K, 5)
    xy = flat[..., 0:2]
    heading = flat[..., 2]
    direction = torch.stack([torch.cos(heading), torch.sin(heading)], -1)
    pid = torch.arange(P, device=flat.device).repeat_interleave(K)
    valid = flat[..., 4] == float(C.ET_ROAD_EDGE)
    with torch.no_grad():  # the nearest point is a choice, not a gradient
        diff = xy[:, None] - query[:, :, None]  # [B, Q, N, 2]
        d2 = torch.where(valid[:, None], (diff * diff).sum(-1), torch.inf)
        nearest = torch.argmin(d2, dim=-1)  # [B, Q]
        del diff, d2
    prior = torch.clamp(nearest - 1, min=0)

    def at(x, i):  # x [B, N, ...] at i [B, Q]
        return x[torch.arange(B, device=x.device)[:, None], i]

    to_edge = query - at(xy, nearest)
    cross = _cross2(to_edge, at(direction, nearest))
    cross_prior = _cross2(to_edge, at(direction, prior))
    same_curve = (pid[nearest] == pid[prior]) & at(valid, prior)
    sign = torch.sign(torch.where(same_curve & (cross_prior < cross),
                                  cross_prior, cross))
    sign = torch.where(sign == 0, 1.0, sign)
    return torch.sqrt((to_edge * to_edge).sum(-1) + _EPS) * sign


def onroad_reward(weight: float = 0.1,
                  aoi: Optional[Sequence[int]] = None) -> RewardFn:
    """reference: onroad_metric.py OnroadReward: each corner's signed
    distance to the nearest road edge, the max over the corners; agents
    already off the road at t = 0 are not penalised; ascending pushes
    straddling corners back in.  ``aoi`` restricts it to the listed agents
    (onroad_metric.py:41-44)."""

    def fn(traj_pred, action_pred, batch):
        box, m = _pick(_traj_5dof(traj_pred, batch),
                       _agent_mask(batch, traj_pred.shape[1]), aoi)
        B, A, T = box.shape[:3]
        corners = obb_corners(box).reshape(B, A * T * 4, 2)
        sd = _signed_dist_to_road_edge(corners, batch["polylines"])
        sd = sd.reshape(B, A, T, 4).amax(dim=-1)  # [B, A, T]
        sd = sd * (sd[:, :, 0:1] < 0)  # only agents on the road at t = 0
        return -(torch.relu(sd) * m[:, :, None] * weight)

    return fn


def tracking_reward(traj_ref: torch.Tensor,
                    weight: Optional[torch.Tensor] = None,
                    beta: float = 1.0) -> RewardFn:
    """reference: tracking_metric.py TrackingReward (smooth-L1 to a
    reference trajectory [B, A, T, D])."""

    def fn(traj_pred, action_pred, batch):
        d = traj_ref.shape[-1]
        w = torch.ones_like(traj_ref) if weight is None else weight
        if w.dim() == traj_ref.dim() - 1:
            w = w[..., None]
        return -smooth_l1(traj_pred[..., :d] - traj_ref, beta) * w

    return fn


def goal_reward(goal: torch.Tensor, goal_mask: Optional[torch.Tensor] = None,
                look_ahead: int = -1, beta: float = 1.0) -> RewardFn:
    """reference: tracking_metric.py GoalReward (smooth-L1 of the
    ``look_ahead`` step to per-agent goals [B, A, D])."""

    def fn(traj_pred, action_pred, batch):
        d = goal.shape[-1]
        m = torch.ones_like(goal) if goal_mask is None else goal_mask
        return -smooth_l1(traj_pred[..., look_ahead, :d] - goal, beta) * m

    return fn


def control_reward(weight_a: float = 1.0,
                   weight_yaw: float = 1.0) -> RewardFn:
    """reference: control_metric.py ControlReward (quadratic action
    cost)."""

    def fn(traj_pred, action_pred, batch):
        A = action_pred.shape[1]
        cost = (action_pred[..., 0] ** 2 * weight_a
                + action_pred[..., 1] ** 2 * weight_yaw)
        return -cost * _agent_mask(batch, A)[:, :, None]

    return fn

"""Sim state -> the VBD sample batch (port of
``gpudrive_lab_tpu/vbd/data_utils.py``; reference:
gpudrive/integrations/vbd/data_utils.py:148-406 process_scenario_data).

Per-agent state history, the nearest agents around the self-driving car
(slot 0), and road polylines, in the layout the VBD denoisers take; built
from the port's Scene and SimState tensors.  The agent selection and the
polylines run on the host in numpy, as the JAX module runs them (a few
dozen agents and polylines a world); the pairwise relations of the
official encoder are computed on the batch's device.  Defaults follow the
checkpoint: 32 agents, 11 history steps, 256 polylines x 30 points.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.types import Scene, SimState


@dataclasses.dataclass(frozen=True)
class VBDSampleConfig:
    max_agents: int = 32
    history_len: int = 11
    max_polylines: int = 256
    points_per_polyline: int = 30


def process_scenario_data(
    scene: Scene,
    state: SimState,
    current_step: int,
    config: VBDSampleConfig = VBDSampleConfig(),
) -> dict:
    """The sample batch of the world batch at ``current_step``, as tensors
    on the scene's device:

      agents_history [W, N, H, 8]  (x, y, yaw, vx, vy, len, wid, hei)
      agents_id      [W, N] int32  (slot index into the sim, -1 padding)
      agents_type    [W, N] int32
      agents_interested [W, N] int32  (1 controlled / 0)
      polylines      [W, P, K, 5]  (x, y, heading, traffic-ctrl=0, lane type)
    """
    cfg = config
    W = scene.num_worlds
    ag = scene.agents
    traj_pos = ag.traj_pos.cpu().numpy()
    traj_vel = ag.traj_vel.cpu().numpy()
    traj_yaw = ag.traj_yaw.cpu().numpy()
    valid = ag.valid.cpu().numpy()
    size = ag.size.cpu().numpy()
    controlled = ag.controlled.cpu().numpy()
    etype = ag.etype.cpu().numpy()
    pos_now = state.pos.cpu().numpy()

    t0 = max(0, current_step - cfg.history_len + 1)
    hist_idx = np.arange(t0, current_step + 1)
    pad = cfg.history_len - len(hist_idx)

    N = cfg.max_agents
    out_hist = np.zeros((W, N, cfg.history_len, 8), np.float32)
    out_id = np.full((W, N), -1, np.int32)
    out_type = np.zeros((W, N), np.int32)
    out_interested = np.zeros((W, N), np.int32)

    for w in range(W):
        # the agents nearest the SDC (slot 0, SDC-first ordering)
        cand = np.nonzero(valid[w])[0]
        d = np.linalg.norm(pos_now[w, cand] - pos_now[w, 0], axis=-1)
        order = cand[np.argsort(d)][:N]
        for k, a in enumerate(order):
            out_hist[w, k, pad:] = np.concatenate(
                [traj_pos[w, a, hist_idx], traj_yaw[w, a, hist_idx, None],
                 traj_vel[w, a, hist_idx],
                 np.broadcast_to(size[w, a], (len(hist_idx), 3))],
                axis=-1)
            out_id[w, k] = a
            out_type[w, k] = etype[w, a]
            out_interested[w, k] = int(controlled[w, a])

    dev = scene.device
    return {
        "agents_history": torch.from_numpy(out_hist).to(dev),
        "agents_id": torch.from_numpy(out_id).to(dev),
        "agents_type": torch.from_numpy(out_type).to(dev),
        "agents_interested": torch.from_numpy(out_interested).to(dev),
        "polylines": torch.from_numpy(_build_polylines(scene, cfg)).to(dev),
    }


def _build_polylines(scene: Scene, cfg: VBDSampleConfig) -> np.ndarray:
    """Road segments grouped by source road id into resampled polylines
    (reference: data_utils.py polyline construction; a segment's start is
    its midpoint less half its length along its heading, as
    GlobalRoadGraphPoints.restore_xy restores it)."""
    W = scene.num_worlds
    roads = scene.roads
    pos = roads.pos[..., :2].cpu().numpy()
    yaw = roads.yaw.cpu().numpy()
    scale = roads.scale.cpu().numpy()
    rid = roads.rid.cpu().numpy()
    etype = roads.etype.cpu().numpy()
    valid = roads.valid.cpu().numpy()

    out = np.zeros((W, cfg.max_polylines, cfg.points_per_polyline, 5),
                   np.float32)
    for w in range(W):
        seg_ok = valid[w] & (etype[w] <= C.ET_ROAD_LANE) & (etype[w] > 0)
        for p, road_id in enumerate(np.unique(rid[w][seg_ok])[
                :cfg.max_polylines]):
            m = seg_ok & (rid[w] == road_id)
            sx = pos[w, m, 0] - scale[w, m, 0] * np.cos(yaw[w, m])
            sy = pos[w, m, 1] - scale[w, m, 0] * np.sin(yaw[w, m])
            n = min(len(sx), cfg.points_per_polyline)
            sel = np.linspace(0, len(sx) - 1, n).astype(int)
            out[w, p, :n, 0] = sx[sel]
            out[w, p, :n, 1] = sy[sel]
            out[w, p, :n, 2] = yaw[w, m][sel]
            out[w, p, :n, 4] = etype[w, m][sel]
    return out


def batched_relations(agents_history: torch.Tensor, polylines: torch.Tensor,
                      traffic_light_points: torch.Tensor) -> torch.Tensor:
    """[W, S, S, 3] pairwise token relations for the official encoder
    (reference: integrations/vbd/data_utils.py:74-146 calculate_relations,
    batched over the worlds), on the inputs' device.

    Token order = [agents (last history frame), polylines (first point),
    traffic lights]; each relation is the target's position in the source
    token's local frame and the wrapped heading difference."""
    W = agents_history.shape[0]
    n_tl = traffic_light_points.shape[1]
    tl = torch.cat([traffic_light_points[..., :2],
                    traffic_light_points.new_zeros((W, n_tl, 1))], dim=-1)
    elements = torch.cat([agents_history[:, :, -1, :3],
                          polylines[:, :, 0, :3], tl], dim=1)  # [W, S, 3]
    S = elements.shape[1]
    xy = elements[..., :2]
    theta = elements[..., 2]
    # source minus target, rotated into the SOURCE frame (the reference's
    # convention: pos_diff[i, j] = pos[i] - pos[j])
    diff = xy[:, :, None, :] - xy[:, None, :, :]  # [W, src, tgt, 2]
    c = torch.cos(theta)[:, :, None]
    s = torch.sin(theta)[:, :, None]
    local_x = diff[..., 0] * c + diff[..., 1] * s
    local_y = -diff[..., 0] * s + diff[..., 1] * c
    dtheta = theta[:, :, None] - theta[:, None, :]
    dtheta = (dtheta + math.pi) % (2 * math.pi) - math.pi
    # traffic-light headings count as 0 (JAX data_utils.py:176-177)
    is_tl = torch.arange(S, device=elements.device) >= S - n_tl
    dtheta = torch.where(is_tl[None, :, None] | is_tl[None, None, :], 0.0,
                         dtheta)
    # the diagonal is eps = 0.01 in all three (JAX :179-183)
    eye = torch.eye(S, dtype=torch.bool, device=elements.device)[None]
    eps = 0.01
    local_x = torch.where(eye, eps, local_x)
    local_y = torch.where(eye, eps, local_y)
    dtheta = torch.where(eye, eps, dtheta)
    # a pair touching a token with x == 0 (padding) is zeroed (JAX :185-188)
    pad = elements[..., 0] == 0
    zero = pad[:, :, None] | pad[:, None, :]
    rel = torch.stack([local_x, local_y, dtheta], dim=-1).to(torch.float32)
    return torch.where(zero[..., None], 0.0, rel)


def official_inputs(batch: dict, num_traffic_lights: int = 16,
                    num_anchors: int = 64) -> dict:
    """The OfficialVBD input dict from ``process_scenario_data``'s batch,
    on its device.  The sim has no live traffic-light state, so the TL
    tokens are zero (fully masked, as the reference feeds scenes without
    lights); the anchors are the zero placeholder the reference uses at
    sim time (integrations/vbd/data_utils.py:403)."""
    hist = batch["agents_history"]
    W, N = hist.shape[:2]
    poly = batch["polylines"]
    tl = hist.new_zeros((W, num_traffic_lights, 3))
    return {
        "agents_history": hist,
        "agents_type": batch["agents_type"].long(),
        "agents_interested": batch["agents_interested"],
        "polylines": poly,
        "polylines_valid": poly.abs().sum(dim=(2, 3)) > 0,
        "traffic_light_points": tl,
        "relations": batched_relations(hist, poly, tl),
        "anchors": hist.new_zeros((W, N, num_anchors, 2)),
    }

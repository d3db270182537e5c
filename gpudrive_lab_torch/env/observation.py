"""The flat policy observation in PyTorch ops: ``ObsSpec`` and
``flat_observation_plain``, the plain version of kernel K6.

``env_torch.flat_observation`` dispatches between K6
(``env/flat_obs_kernel.py``) and this code; both modules import it from
here.
"""

from __future__ import annotations

import dataclasses

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import observations as obsmod
from gpudrive_lab_torch.core.types import Params, Scene, SimState
from gpudrive_lab_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Static observation-assembly options."""

    ego_state: bool = True
    road_map_obs: bool = True
    partner_obs: bool = True
    norm_obs: bool = True
    reward_conditioned: bool = False

    @property
    def obs_dim(self) -> int:
        d = 0
        if self.ego_state:
            d += C.EGO_FEAT_DIM + (3 if self.reward_conditioned else 0)
        if self.partner_obs:
            d += (C.MAX_AGENTS - 1) * C.PARTNER_FEAT_DIM
        if self.road_map_obs:
            d += C.MAX_AGENT_MAP_OBS * C.ROAD_GRAPH_FEAT_DIM
        return d


def _minmax(x, lo, hi):
    """normalize_min_max (reference: gpudrive/utils/geometry.py)."""
    return 2.0 * ((x - lo) / (hi - lo)) - 1.0


def flat_observation_plain(
    scene: Scene,
    state: SimState,
    params: Params,
    spec: ObsSpec,
    reward_weights: torch.Tensor,
    ego_idx=None,
    split: bool = False,
):
    """Flattened per-agent policy observation and masks, in PyTorch ops
    (K6's plain version).

    Layout (reference: gpudrive/env/env_torch.py:1172-1216):
    [ego(6[+3]), partner(127*6), road(200*13)], normalised when norm_obs.
    Returns (obs [W, A, D], partner_mask [W, A, 127] int, road_mask
    [W, A, K] bool); a mask is None when its block is off.

    ego_idx restricts the ego axis to the selected agents: [W, C] slots
    per world (results [W, C, ...]) or a flat (w_idx [N], a_idx [N]) pair
    (results [N, ...]), the PPO learner's compaction.  ``split=True``
    returns the obs as the tuple (ego [.., E], partner [.., 127, 6],
    road [.., 200, 13]) that LateFusionPolicy also accepts, instead of the
    concatenated vector; it needs all three classic blocks."""
    if split and not (spec.ego_state and spec.partner_obs
                      and spec.road_map_obs):
        raise ValueError("split obs requires ego/partner/road all enabled")
    with span("obs"):
        parts = []
        partner_mask = road_mask = None
        dev = state.pos.device

        if spec.ego_state:
            with span("obs.ego"):
                so = obsmod.self_observation(scene, state, ego_idx)
                speed = so[..., 0]
                length = so[..., 1] * C.VEHICLE_LENGTH_SCALE
                width = so[..., 2] * C.VEHICLE_LENGTH_SCALE
                gx, gy = so[..., 4], so[..., 5]
                collided = so[..., 6]
                if spec.norm_obs:
                    speed = speed / C.MAX_SPEED
                    length = length / C.MAX_VEH_LEN
                    width = width / C.MAX_VEH_WIDTH
                    gx = _minmax(gx, C.MIN_REL_GOAL_COORD,
                                 C.MAX_REL_GOAL_COORD)
                    gy = _minmax(gy, C.MIN_REL_GOAL_COORD,
                                 C.MAX_REL_GOAL_COORD)
                ego = torch.stack([speed, length, width, gx, gy, collided],
                                  dim=-1)
                if spec.reward_conditioned:
                    ego = torch.cat(
                        [ego, obsmod._ego_take(reward_weights, ego_idx)],
                        dim=-1)
                parts.append(ego)

        if spec.partner_obs:
            with span("obs.partner"):
                partner, other_static = obsmod.partner_observations(
                    scene, state, params, ego_idx, with_static=True
                )
                # Fixed flat-feature layout: 127 partner slots even when
                # the agent axis is bucketed below 128.  Pad the raw rows
                # with "nonexistent" fillers (zero features, id=-2) before
                # normalisation.
                short = (C.MAX_AGENTS - 1) - partner.shape[-2]
                if short:
                    filler = torch.where(torch.arange(9, device=dev) == 8,
                                         -2.0, 0.0)
                    pad_rows = filler.expand(partner.shape[:-2] + (short, 9))
                    partner = torch.cat([partner, pad_rows], dim=-2)
                    other_static = torch.cat(
                        [other_static, other_static.new_zeros(
                            other_static.shape[:-1] + (short,))],
                        dim=-1,
                    )
                p_speed = partner[..., 0]
                p_x, p_y = partner[..., 1], partner[..., 2]
                p_head = partner[..., 3]
                p_len = partner[..., 4] * C.VEHICLE_LENGTH_SCALE
                p_wid = partner[..., 5] * C.VEHICLE_LENGTH_SCALE
                if spec.norm_obs:
                    p_speed = p_speed / C.MAX_SPEED
                    p_x = _minmax(p_x, C.MIN_REL_AGENT_POS,
                                  C.MAX_REL_AGENT_POS)
                    p_y = _minmax(p_y, C.MIN_REL_AGENT_POS,
                                  C.MAX_REL_AGENT_POS)
                    p_head = p_head / C.MAX_ORIENTATION_RAD
                    p_len = p_len / C.MAX_VEH_LEN
                    p_wid = p_wid / C.MAX_VEH_WIDTH
                pobs = torch.stack([p_speed, p_x, p_y, p_head, p_len, p_wid],
                                   dim=-1)
                parts.append(pobs if split else pobs.flatten(-2))

        if spec.road_map_obs:
            with span("obs.road"):
                mo = obsmod.agent_map_observations(scene, state, params,
                                                   ego_idx)
                x, y = mo[..., 0], mo[..., 1]
                d0, d1, d2 = mo[..., 2], mo[..., 3], mo[..., 4]
                heading = mo[..., 5]
                rtype = torch.clamp(mo[..., 6].to(torch.int32), 0, 6)
                if spec.norm_obs:
                    x = _minmax(x, C.MIN_RG_COORD, C.MAX_RG_COORD)
                    y = _minmax(y, C.MIN_RG_COORD, C.MAX_RG_COORD)
                    d0 = d0 / C.MAX_ROAD_LINE_SEGMENT_LEN
                    d1 = d1 / C.MAX_ROAD_SCALE
                    d2 = d2 / C.MAX_ROAD_SCALE
                    heading = heading / C.MAX_ORIENTATION_RAD
                one_hot = torch.nn.functional.one_hot(rtype.long(), 7).to(
                    torch.float32)
                robs = torch.cat(
                    [torch.stack([x, y, d0, d1, d2, heading], dim=-1),
                     one_hot], dim=-1
                )
                parts.append(robs if split else robs.flatten(-2))
                road_mask = mo[..., 7] == -1  # (env_torch.py:1258-1272)

        with span("obs.assemble"):
            if split:
                obs = tuple(parts)
            elif parts:
                obs = torch.cat(parts, dim=-1)
            else:
                lead = (obsmod._ego_take(scene.agents.valid, ego_idx).shape
                        if ego_idx is not None else scene.agents.valid.shape)
                obs = torch.zeros(lead + (0,), dtype=torch.float32,
                                  device=dev)

            if spec.partner_obs:
                # Partner mask: 0 partner / 1 static / 2 nonexistent
                # (reference: env_torch.py:1224-1253).
                ids = partner[..., 8]
                feat_sum = partner[..., :6].sum(-1)
                two = torch.full_like(ids, 2, dtype=torch.int32)
                partner_mask = torch.where(
                    other_static & (feat_sum != 0),
                    torch.ones_like(two),
                    torch.where(ids <= -1, two, torch.zeros_like(two)),
                )
        return obs, partner_mask, road_mask

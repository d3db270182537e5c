"""Camera renderer: per-agent RGB and depth (port of
``gpudrive_lab_tpu/core/render.py``; reference: src/mgr.cpp:922-948,
rgbTensor [W, A, H, Wpx, 4] uint8 and depthTensor [W, A, H, Wpx, 1] float32).

Every pixel ray is tested against every scene box (roads, then agents) with
the lidar's oriented-slab test extended to 3-D (xy OBB slab and z slab) and
keeps its nearest hit.  Cameras sit at each agent's position, EYE_HEIGHT
above it, looking along its heading through a pinhole.  Flat shading: the
entity type's albedo times 1 / (1 + 0.01 t), sky above the horizon and
ground below where nothing is hit.

Only created agents are rendered (the other views are zero, as in the JAX
function), in groups of rows whose [rows, pixels, boxes] lattice holds at
most ``GROUP_ELEMS`` elements (2**26; about 40 float32 tensors of that size
pass through memory per group, a few of them alive at once).  A group's
box axis stops at the last valid road and agent of its worlds.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.rows import Rows
from gpudrive_lab_torch.core.types import Scene, SimState

EYE_HEIGHT = 1.5  # camera z offset above the agent origin
AGENT_HALF_HEIGHT = 0.7  # matches the lidar's agent z-extent

GROUP_ELEMS = 2**26

# entity type -> RGB albedo (uint8), index = EntityType value
_TYPE_ALBEDO = np.zeros((16, 3), np.uint8)
_TYPE_ALBEDO[C.ET_ROAD_LANE] = (180, 180, 180)
_TYPE_ALBEDO[C.ET_ROAD_LINE] = (230, 230, 230)
_TYPE_ALBEDO[C.ET_ROAD_EDGE] = (90, 90, 90)
_TYPE_ALBEDO[C.ET_CROSSWALK] = (200, 200, 120)
_TYPE_ALBEDO[C.ET_SPEED_BUMP] = (200, 150, 60)
_TYPE_ALBEDO[C.ET_STOP_SIGN] = (220, 40, 40)
_TYPE_ALBEDO[C.ET_VEHICLE] = (60, 120, 220)
_TYPE_ALBEDO[C.ET_PEDESTRIAN] = (240, 120, 40)
_TYPE_ALBEDO[C.ET_CYCLIST] = (120, 220, 120)
_SKY = np.array((153, 204, 255), np.uint8)
_GROUND = np.array((70, 80, 70), np.uint8)

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """reference: mgr.hpp batchRenderViewWidth/Height.  ``agent_chunk``:
    rows rendered per group; None sizes the groups to ``GROUP_ELEMS``."""

    height: int = 64
    width: int = 64
    hfov_deg: float = 90.0
    max_depth: float = 200.0
    agent_chunk: int | None = None


def _pixel_dirs(cfg: CameraConfig) -> np.ndarray:
    """[H, Wpx, 3] unit ray directions in the camera frame (x forward,
    y left, z up); pinhole projection."""
    tan_h = np.tan(np.radians(cfg.hfov_deg) / 2)
    tan_v = tan_h * cfg.height / cfg.width
    # pixel centres, image row 0 = top of frame
    ys = (1.0 - 2.0 * (np.arange(cfg.width) + 0.5) / cfg.width) * tan_h
    zs = (1.0 - 2.0 * (np.arange(cfg.height) + 0.5) / cfg.height) * tan_v
    d = np.stack(
        [
            np.ones((cfg.height, cfg.width)),
            np.broadcast_to(ys[None, :], (cfg.height, cfg.width)),
            np.broadcast_to(zs[:, None], (cfg.height, cfg.width)),
        ],
        axis=-1,
    )
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def _ray_box_t3(origin, dir3, box_pos, box_yaw, box_half):
    """First positive hit parameter of 3-D rays against z-aligned OBBs
    (xy oriented slab + z slab); inf on miss.  Broadcasting shapes:
    origin/dir3 [..., 3], box_pos/box_half [..., 3], box_yaw [...]."""
    c = torch.cos(box_yaw)
    s = torch.sin(box_yaw)
    rel = origin - box_pos
    ox = c * rel[..., 0] + s * rel[..., 1]
    oy = -s * rel[..., 0] + c * rel[..., 1]
    oz = rel[..., 2]
    dx = c * dir3[..., 0] + s * dir3[..., 1]
    dy = -s * dir3[..., 0] + c * dir3[..., 1]
    dz = dir3[..., 2]

    eps = 1e-9
    dx = torch.where(dx.abs() < eps, eps, dx)
    dy = torch.where(dy.abs() < eps, eps, dy)
    dz = torch.where(dz.abs() < eps, eps, dz)

    tx1 = (-box_half[..., 0] - ox) / dx
    tx2 = (box_half[..., 0] - ox) / dx
    ty1 = (-box_half[..., 1] - oy) / dy
    ty2 = (box_half[..., 1] - oy) / dy
    tz1 = (-box_half[..., 2] - oz) / dz
    tz2 = (box_half[..., 2] - oz) / dz

    tmin = torch.maximum(
        torch.maximum(torch.minimum(tx1, tx2), torch.minimum(ty1, ty2)),
        torch.minimum(tz1, tz2),
    )
    tmax = torch.minimum(
        torch.minimum(torch.maximum(tx1, tx2), torch.maximum(ty1, ty2)),
        torch.maximum(tz1, tz2),
    )
    hit = (tmax >= tmin) & (tmax > 0.0) & (tmin > 0.0)
    return torch.where(hit, tmin, _INF)


def _shade_hits(t_all, etypes, dz, cfg: CameraConfig):
    """Nearest hit over the box axis -> (rgba float32 [..., 4], depth
    float32).  t_all [..., E] hit parameters, etypes [..., E] (or [E]),
    dz [...] the world-frame ray z component (horizon split for the
    background).  The first box wins a tie, as ``jnp.argmin``."""
    dev = t_all.device
    albedo = torch.as_tensor(_TYPE_ALBEDO, dtype=torch.float32, device=dev)
    sky = torch.as_tensor(_SKY, dtype=torch.float32, device=dev)
    ground = torch.as_tensor(_GROUND, dtype=torch.float32, device=dev)
    best, best_idx = t_all.min(dim=-1)
    hit = best <= cfg.max_depth
    if etypes.dim() == 1:
        hit_type = etypes[best_idx]
    else:
        hit_type = torch.gather(etypes, -1, best_idx.flatten(1)).view_as(
            best_idx)
    shade = 1.0 / (1.0 + 0.01 * best)
    color = albedo[hit_type.clamp(0, 15).long()] * shade[..., None]
    background = torch.where((dz < 0.0)[..., None], ground, sky)
    rgb = torch.where(hit[..., None], color, background)
    rgb = torch.cat([rgb, torch.full_like(rgb[..., :1], 255.0)], dim=-1)
    depth = torch.where(hit, best, 0.0)
    return rgb, depth


def free_camera_render(
    scene: Scene,
    state: SimState,
    cam_pos: torch.Tensor,
    cam_yaw,
    cam_pitch,
    config: CameraConfig,
    world: int = 0,
    exclude_agent: int = -1,
):
    """Render one free camera (the fly-camera viewer, reference:
    src/viewer.cpp:16-210).  cam_pos [3] world-frame eye; cam_yaw and
    cam_pitch scalars in radians (pitch > 0 looks up); exclude_agent >= 0
    hides that agent's box.  Returns (rgb [H, Wpx, 4] uint8, depth
    [H, Wpx] float32).  At an agent's eye pose (pitch 0, that agent
    excluded) it gives that agent's ``batch_render`` view."""
    cfg = config
    dev = state.pos.device
    A = state.pos.shape[1]
    P = cfg.height * cfg.width
    agents, roads = scene.agents, scene.roads
    f32 = dict(dtype=torch.float32, device=dev)
    cam_pos = torch.as_tensor(cam_pos, **f32)
    cam_yaw = torch.as_tensor(cam_yaw, **f32)
    cam_pitch = torch.as_tensor(cam_pitch, **f32)

    d_cam = torch.as_tensor(_pixel_dirs(cfg).reshape(P, 3), device=dev)
    # pitch about the camera's left (y) axis: forward -> (cos p, 0, sin p)
    cp, sp = torch.cos(cam_pitch), torch.sin(cam_pitch)
    px = d_cam[:, 0] * cp - d_cam[:, 2] * sp
    pz = d_cam[:, 0] * sp + d_cam[:, 2] * cp
    # yaw about world z
    cy, sy = torch.cos(cam_yaw), torch.sin(cam_yaw)
    d3 = torch.stack(
        [px * cy - d_cam[:, 1] * sy, px * sy + d_cam[:, 1] * cy, pz], dim=-1
    )  # [P, 3]
    o3 = cam_pos[None, None, :]  # [1, 1, 3]
    dirs = d3[:, None, :]  # [P, 1, 3]

    t_road = _ray_box_t3(o3, dirs, roads.pos[world][None],
                         roads.yaw[world][None], roads.scale[world][None])
    t_road = torch.where(roads.valid[world][None], t_road, _INF)  # [P, R]

    apos3 = torch.cat([state.pos[world], state.z[world][:, None]], dim=-1)
    ahalf = torch.cat(
        [agents.size[world, :, 0:2] * (0.5 * C.VEHICLE_LENGTH_SCALE),
         torch.full((A, 1), AGENT_HALF_HEIGHT, **f32)],
        dim=-1,
    )
    t_agent = _ray_box_t3(o3, dirs, apos3[None], state.yaw[world][None],
                          ahalf[None])  # [P, A]
    visible = agents.valid[world] & (torch.arange(A, device=dev)
                                     != exclude_agent)
    t_agent = torch.where(visible[None], t_agent, _INF)

    t_all = torch.cat([t_road, t_agent], dim=-1)  # [P, E]
    etypes = torch.cat([roads.etype[world], agents.etype[world]])
    rgb, depth = _shade_hits(t_all, etypes, d3[:, 2], cfg)
    return (
        rgb.reshape(cfg.height, cfg.width, 4).to(torch.uint8),
        depth.reshape(cfg.height, cfg.width),
    )


def _render_rows(w, a, scene, state, dirs_cam, n_roads, n_agents, cfg):
    """(rgb [n, P, 4] uint8, depth [n, P]) of the cameras of rows (w, a)
    against the first n_roads roads and n_agents agents of their worlds."""
    roads, agents = scene.roads, scene.agents
    Rn, An = n_roads, n_agents
    dev = dirs_cam.device
    cam_pos = torch.cat(
        [state.pos[w, a], state.z[w, a][:, None] + EYE_HEIGHT], dim=-1
    )  # [n, 3]
    yaw = state.yaw[w, a]
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    # camera frame -> world: rotate xy by yaw
    dx = dirs_cam[None, :, 0] * c - dirs_cam[None, :, 1] * s
    dy = dirs_cam[None, :, 0] * s + dirs_cam[None, :, 1] * c
    dz = dirs_cam[None, :, 2].expand_as(dx)
    d3 = torch.stack([dx, dy, dz], dim=-1)[:, :, None, :]  # [n, P, 1, 3]
    o3 = cam_pos[:, None, None, :]  # [n, 1, 1, 3]

    t_road = _ray_box_t3(o3, d3, roads.pos[w, :Rn][:, None],
                         roads.yaw[w, :Rn][:, None],
                         roads.scale[w, :Rn][:, None])  # [n, P, Rn]
    t_road = torch.where(roads.valid[w, :Rn][:, None], t_road, _INF)

    apos3 = torch.cat([state.pos[w, :An], state.z[w, :An][..., None]], dim=-1)
    ahalf = torch.cat(
        [agents.size[w, :An, 0:2] * (0.5 * C.VEHICLE_LENGTH_SCALE),
         torch.full(agents.size[w, :An, :1].shape, AGENT_HALF_HEIGHT,
                    dtype=torch.float32, device=dev)],
        dim=-1,
    )
    t_agent = _ray_box_t3(o3, d3, apos3[:, None], state.yaw[w, :An][:, None],
                          ahalf[:, None])  # [n, P, An]
    not_self = torch.arange(An, device=dev)[None, :] != a[:, None]
    visible = agents.valid[w, :An] & not_self
    t_agent = torch.where(visible[:, None], t_agent, _INF)

    t_all = torch.cat([t_road, t_agent], dim=-1)  # [n, P, E]
    del t_road, t_agent
    etypes = torch.cat([roads.etype[w, :Rn], agents.etype[w, :An]], dim=-1)
    rgb, depth = _shade_hits(t_all, etypes, dz, cfg)
    return rgb.to(torch.uint8), depth


def batch_render(scene: Scene, state: SimState, config: CameraConfig):
    """Render every agent's camera.  Returns (rgb [W, A, H, Wpx, 4] uint8,
    depth [W, A, H, Wpx, 1] float32; depth 0 where nothing is hit, and
    agents that were not created render as empty views)."""
    cfg = config
    W, A = state.pos.shape[:2]
    H, Wp = cfg.height, cfg.width
    P = H * Wp
    dev = state.pos.device
    dirs_cam = torch.as_tensor(_pixel_dirs(cfg).reshape(P, 3), device=dev)
    rgb = torch.zeros((W * A, P, 4), dtype=torch.uint8, device=dev)
    depth = torch.zeros((W * A, P), dtype=torch.float32, device=dev)
    rows = Rows(scene)
    if len(rows):
        width = max(rows.road_ext) + max(rows.agent_ext)
        per = cfg.agent_chunk or max(1, GROUP_ELEMS // (P * width))
        for g in rows.groups(per):
            r, w, a = rows.split(g)
            rgb[r], depth[r] = _render_rows(w, a, scene, state, dirs_cam,
                                            *rows.extents(g), cfg)
    return rgb.view(W, A, H, Wp, 4), depth.view(W, A, H, Wp, 1)

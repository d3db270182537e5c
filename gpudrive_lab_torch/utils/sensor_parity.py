"""Tell a boundary case from a fault when two sensor outputs disagree.

Two correct implementations of the lidar, BEV or camera can disagree where
a ray grazes a box, where two boxes are hit at the same distance, or where
a cell centre lies on a box edge: their sines and cosines differ in the
last bit.  For every sample, cell or pixel where two outputs differ, these
functions evaluate the same geometry again in float64, from the same
float32 inputs, and list every result that a decision within ``tol``
metres of a box edge (or of the range or radius limit) allows.  A
difference is explained when both outputs are among those results;
anything else is a fault.  A depth (or hit position) agrees when it lies
within ``depth_tol`` of the other, relative beyond 1 m: at a grazing
incidence the last bit of a ray's direction moves a hit 100 m away by more
than 1e-4 m.  Inputs are CPU tensors of the worlds compared.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core.bev import cell_coords
from gpudrive_lab_torch.core.lidar import PLANE_OFFSETS
from gpudrive_lab_torch.core.render import (
    AGENT_HALF_HEIGHT,
    EYE_HEIGHT,
    _GROUND,
    _SKY,
    _TYPE_ALBEDO,
    _pixel_dirs,
)

TOL = 1e-5  # metres from a box edge, the range or the radius


def _f64(x):
    return x.detach().cpu().to(torch.float64)


def _slab(origin, d, pos, yaw, half):
    """float64 slab test of rays [m, 3] against boxes [m, E]: (tmin, tmax)
    [m, E], with the same direction clamp as the float32 versions.  2-D
    when the last axis is 2."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    rel = origin[:, None, :] - pos
    ox = c * rel[..., 0] + s * rel[..., 1]
    oy = -s * rel[..., 0] + c * rel[..., 1]
    dx = c * d[:, None, 0] + s * d[:, None, 1]
    dy = -s * d[:, None, 0] + c * d[:, None, 1]
    o, dd = [ox, oy], [dx, dy]
    if origin.shape[-1] == 3:
        o.append(rel[..., 2])
        dd.append(d[:, None, 2].expand_as(dx))
    lo, hi = [], []
    for k in range(len(o)):
        dk = torch.where(dd[k].abs() < 1e-9, 1e-9, dd[k])
        t1 = (-half[..., k] - o[k]) / dk
        t2 = (half[..., k] - o[k]) / dk
        lo.append(torch.minimum(t1, t2))
        hi.append(torch.maximum(t1, t2))
    return (torch.stack(lo).amax(0), torch.stack(hi).amin(0))


def _outcomes(tmin, tmax, admitted, limit, tol):
    """Per ray, the (entity index or -1 for a miss, t) results that
    decisions within ``tol`` allow.  tmin/tmax/admitted [m, E]."""
    hit = (tmax >= tmin) & (tmax > 0) & (tmin > 0) & admitted
    near = admitted & ((tmax - tmin).abs() <= tol) | admitted & (
        (tmin.abs() <= tol) | (tmax.abs() <= tol)) & (tmax >= tmin - tol)
    sure = hit & ~near
    t_sure = torch.where(sure, tmin, math.inf).amin(dim=1)
    out = []
    for i in range(tmin.shape[0]):
        cand = ((sure[i] | near[i]) & (tmin[i] <= t_sure[i] + tol)
                & (tmin[i] <= limit + tol)).nonzero().flatten().tolist()
        res = [(e, float(tmin[i, e])) for e in cand]
        if t_sure[i] >= limit - tol:
            res.append((-1, 0.0))
        out.append(res)
    return out


def _far(a, b, tol):
    """|a - b| > tol * max(1, |b|), elementwise."""
    return (a - b).abs() > tol * b.abs().clamp(min=1.0)


def _near(a: float, b: float, tol: float) -> bool:
    return abs(a - b) <= tol * max(1.0, abs(b))


def _report(n, unexplained):
    return {"mismatches": n, "unexplained": unexplained}


def lidar_diff(scene, state, actions, got, want, depth_tol=1e-3,
               tol=TOL):
    """Compare two [W, A, 3, S, 4] lidar outputs: samples whose types
    differ, or whose depth or hit position differ by more than
    ``depth_tol`` (relative beyond 1 m).  Returns {"mismatches": n,
    "unexplained": [...]}."""
    got, want = got.cpu(), want.cpu()
    bad = (got[..., 1] != want[..., 1]) | _far(
        got[..., [0, 2, 3]], want[..., [0, 2, 3]], depth_tol).any(-1)
    where = bad.nonzero()
    if not len(where):
        return _report(0, [])
    w, a, p, s = where.unbind(1)
    S = got.shape[3]
    roads, agents = scene.roads, scene.agents
    # the ray's yaw in float32, as both sides form it; then float64
    head = torch.where(agents.controlled[w, a], actions[w, a, 2].cpu(), 0.0)
    theta = C.LIDAR_ANGLE * (2.0 * s.to(torch.float32) / S - 1.0) + head
    ray_yaw = _f64(state.yaw[w, a] + theta)
    d = torch.stack([torch.cos(ray_yaw), torch.sin(ray_yaw)], -1)
    origin = _f64(state.pos[w, a])
    plane_z = state.z[w, a] + torch.tensor(PLANE_OFFSETS)[p]
    # roads, then agents (index R + k), admitted by the plane's z-extent
    rz, rs = roads.pos[w, :, 2], roads.scale[w, :, 2]
    r_ok = (plane_z[:, None] >= rz - rs) & (plane_z[:, None] <= rz + rs) \
        & roads.valid[w]
    az = state.z[w]
    A = az.shape[1]
    a_ok = (plane_z[:, None] >= az - 0.7) & (plane_z[:, None] <= az + 0.7) \
        & agents.valid[w] & (torch.arange(A)[None] != a[:, None])
    half_a = agents.size[w, :, 0:2] * (0.5 * C.VEHICLE_LENGTH_SCALE)
    lo_r, hi_r = _slab(origin, d, _f64(roads.pos[w, :, 0:2]),
                       _f64(roads.yaw[w]), _f64(roads.scale[w, :, 0:2]))
    lo_a, hi_a = _slab(origin, d, _f64(state.pos[w]), _f64(state.yaw[w]),
                       _f64(half_a))
    outs = _outcomes(torch.cat([lo_r, lo_a], 1), torch.cat([hi_r, hi_a], 1),
                     torch.cat([r_ok, a_ok], 1), C.LIDAR_DISTANCE, tol)
    types = torch.cat([roads.etype[w], agents.etype[w]], 1)
    unexplained = []
    for i, res in enumerate(outs):
        allowed = [(0.0, 0.0) if e < 0 else (float(types[i, e]), t)
                   for e, t in res]
        for side in (got, want):
            dep, ty = (float(v) for v in side[w[i], a[i], p[i], s[i], :2])
            if not any(ty == at and _near(dep, t, depth_tol)
                       for at, t in allowed):
                unexplained.append(
                    (tuple(int(x) for x in where[i]), ty, dep, allowed))
                break
    return _report(len(where), unexplained)


def bev_diff(scene, state, params, got, want, tol=TOL):
    """Compare two [W, A, RES, RES, 1] BEV grids cell by cell.  Returns
    {"mismatches": n, "unexplained": [...]}."""
    got, want = got.cpu()[..., 0], want.cpu()[..., 0]
    where = (got != want).nonzero()
    if not len(where):
        return _report(0, [])
    w, a, i, j = where.unbind(1)
    res = C.BEV_RESOLUTION
    radius = params.observation_radius
    coords = cell_coords(res, radius, "cpu")
    cell = _f64(torch.stack([coords[j], coords[i]], -1))  # [m, 2] (x, y)
    roads, agents = scene.roads, scene.agents
    R = roads.valid.shape[1]
    K = min(C.MAX_AGENT_MAP_OBS, R)
    apos, ayaw = _f64(state.pos[w, a]), _f64(state.yaw[w, a])
    c, s = torch.cos(ayaw)[:, None], torch.sin(ayaw)[:, None]

    def frame(pos):
        rel = pos - apos[:, None, :]
        return torch.stack([c * rel[..., 0] + s * rel[..., 1],
                            -s * rel[..., 0] + c * rel[..., 1]], -1)

    def margin(rel, yaw, hl, hw):
        d = cell[:, None, :] - rel
        ry = -(yaw - ayaw[:, None])
        cc, ss = torch.cos(ry), torch.sin(ry)
        lx = d[..., 0] * cc - d[..., 1] * ss
        ly = d[..., 0] * ss + d[..., 1] * cc
        return torch.minimum(hl + 1e-3 - lx.abs(), hw + 1e-3 - ly.abs())

    rel_r = frame(_f64(roads.pos[w, :, 0:2]))
    dist_r = rel_r.norm(dim=-1)
    within = roads.valid[w] & (dist_r <= radius + tol)
    sure_in = roads.valid[w] & (dist_r < radius - tol)
    painted = within & (torch.cumsum(within, 1) - 1 < K)
    sure_p = sure_in & (torch.cumsum(within, 1) - 1 < K)
    min_w = 2.0 * radius / res
    m_r = margin(rel_r, _f64(roads.yaw[w]), _f64(roads.scale[w, :, 0]) / 2,
                 _f64(roads.scale[w, :, 1].clamp(min=min_w)) / 2)
    rel_a = frame(_f64(state.pos[w]))
    dist_a = rel_a.norm(dim=-1)
    A = dist_a.shape[1]
    other = agents.valid[w] & (torch.arange(A)[None] != a[:, None])
    m_a = margin(rel_a, _f64(state.yaw[w]), _f64(agents.size[w, :, 0]) / 2,
                 _f64(agents.size[w, :, 1]) / 2)
    may = torch.cat([painted & (m_r >= -tol),
                     other & (dist_a <= radius + tol) & (m_a >= -tol)], 1)
    sure = torch.cat([sure_p & (m_r > tol),
                      other & (dist_a < radius - tol) & (m_a > tol)], 1)
    types = torch.cat([roads.etype[w], agents.etype[w]], 1).float()
    unexplained = []
    for k in range(len(where)):
        top = int(sure[k].nonzero().max()) if sure[k].any() else -1
        allowed = {0.0 if top < 0 else float(types[k, top])}
        allowed |= {float(types[k, e]) for e in
                    (may[k] & ~sure[k]).nonzero().flatten().tolist()
                    if e > top}
        g, h = float(got[tuple(where[k])]), float(want[tuple(where[k])])
        if g not in allowed or h not in allowed:
            unexplained.append((tuple(int(x) for x in where[k]), g, h,
                                sorted(allowed)))
    return _report(len(where), unexplained)


def camera_diff(scene, state, cfg, got, want, depth_tol=1e-3, tol=TOL):
    """Compare two (rgb [W, A, H, Wpx, 4] uint8, depth [W, A, H, Wpx, 1])
    camera outputs: pixels whose depth differs by more than ``depth_tol``
    (relative beyond 1 m) or whose colour differs by more than one step.
    A pixel is explained
    when both sides' depth and colour (within one step) are those of a
    result the boundary allows.  Returns {"mismatches": n,
    "unexplained": [...]}."""
    g_rgb, g_dep = got[0].cpu().int(), got[1].cpu()[..., 0]
    w_rgb, w_dep = want[0].cpu().int(), want[1].cpu()[..., 0]
    bad = ((g_rgb - w_rgb).abs().amax(-1) > 1) | _far(g_dep, w_dep,
                                                       depth_tol)
    where = bad.nonzero()
    if not len(where):
        return _report(0, [])
    w, a, py, px = where.unbind(1)
    dirs = torch.from_numpy(_pixel_dirs(cfg))[py, px]  # [m, 3] float32
    yaw = _f64(state.yaw[w, a])
    c, s = torch.cos(yaw), torch.sin(yaw)
    dirs64 = _f64(dirs)
    d = torch.stack([dirs64[:, 0] * c - dirs64[:, 1] * s,
                     dirs64[:, 0] * s + dirs64[:, 1] * c, dirs64[:, 2]], -1)
    origin = torch.cat([_f64(state.pos[w, a]),
                        _f64(state.z[w, a] + EYE_HEIGHT)[:, None]], -1)
    roads, agents = scene.roads, scene.agents
    A = agents.valid.shape[1]
    half_a = torch.cat(
        [agents.size[w, :, 0:2] * (0.5 * C.VEHICLE_LENGTH_SCALE),
         torch.full(agents.size[w, :, :1].shape, AGENT_HALF_HEIGHT)], -1)
    apos = torch.cat([state.pos[w], state.z[w][..., None]], -1)
    lo_r, hi_r = _slab(origin, d, _f64(roads.pos[w]), _f64(roads.yaw[w]),
                       _f64(roads.scale[w]))
    lo_a, hi_a = _slab(origin, d, _f64(apos), _f64(state.yaw[w]),
                       _f64(half_a))
    ok = torch.cat([roads.valid[w], agents.valid[w]
                    & (torch.arange(A)[None] != a[:, None])], 1)
    outs = _outcomes(torch.cat([lo_r, lo_a], 1), torch.cat([hi_r, hi_a], 1),
                     ok, cfg.max_depth, tol)
    types = torch.cat([roads.etype[w], agents.etype[w]], 1)
    albedo = _TYPE_ALBEDO.astype(np.float64)
    unexplained = []
    for k, res in enumerate(outs):
        bg = _GROUND if float(dirs[k, 2]) < 0.0 else _SKY
        allowed = []
        for e, t in res:
            if e < 0:
                allowed.append((0.0, np.append(bg, 255.0)))
            else:
                rgb = albedo[min(max(int(types[k, e]), 0), 15)] / (
                    1.0 + 0.01 * t)
                allowed.append((t, np.append(rgb, 255.0)))
        for rgb_s, dep_s in ((g_rgb, g_dep), (w_rgb, w_dep)):
            col = rgb_s[tuple(where[k])].numpy()
            dep = float(dep_s[tuple(where[k])])
            if not any(_near(dep, t, depth_tol)
                       and np.abs(col - np.floor(ref)).max() <= 1
                       for t, ref in allowed):
                unexplained.append((tuple(int(x) for x in where[k]), dep,
                                    col.tolist(), allowed))
                break
    return _report(len(where), unexplained)

"""Road collision tiles of the plain reference: a frozen copy of the port's
``scene/rtiles.py``.  Segments are Morton-ordered once per scene so that
each tile of ``RT`` consecutive segments covers a compact spatial patch
with a precomputed AABB and reach bound; kernel K1 skips every
[agent-block, road-tile] pair whose bound proves separation.  The tiles
here serve only the count of K1's live work (``sat.live_pair_ops_tiled``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from .types import RoadTiles

# Road tile size (segments per tile).
ROAD_TILE = 256
# build_scene builds RoadTiles at or above this road bucket.
TILE_COLLISION_MIN_R = 2048
# Morton-quantisation grid shared by the host tile build and the per-step
# agent sort (core/collision.py): both must quantise on the same lattice for
# the tile-skip mask's locality to hold.
MORTON_CELLS = 1024


def morton_interleave(n):
    """Spread the low 16 bits of ``n`` into even bit positions.

    Works on numpy uint32 arrays (the tile build) and on torch int32
    tensors (the per-step agent sort), so the two sort keys are bitwise the
    same.  Intermediates stay within 31 bits, so int32 is safe."""
    n = n & 0xFFFF
    n = (n | (n << 8)) & 0x00FF00FF
    n = (n | (n << 4)) & 0x0F0F0F0F
    n = (n | (n << 2)) & 0x33333333
    n = (n | (n << 1)) & 0x55555555
    return n


def build_road_tiles(
    pos: np.ndarray,  # [W, R, 3]
    yaw: np.ndarray,  # [W, R]
    scale: np.ndarray,  # [W, R, 3] (d0/d1 = half extents)
    etype: np.ndarray,  # [W, R] int
    valid: np.ndarray,  # [W, R] bool
    tile: int = ROAD_TILE,
    device=None,
) -> RoadTiles:
    """Morton-sort segments per world and pack the per-tile kernel inputs."""
    W, R = yaw.shape
    if R % tile:
        raise ValueError(f"road count {R} is not a multiple of tile {tile}")
    T = R // tile

    feat = np.zeros((W, T, 8, tile), np.float32)
    bounds = np.zeros((W, T, 6), np.float32)
    world_min = np.zeros((W, 2), np.float32)
    world_inv_ext = np.ones((W, 2), np.float32)

    for w in range(W):
        v = valid[w]
        centers = pos[w, :, 0:2]
        if v.any():
            lo = centers[v].min(axis=0)
            hi = centers[v].max(axis=0)
        else:
            lo = np.zeros(2, np.float32)
            hi = np.ones(2, np.float32)
        ext = np.maximum(hi - lo, 1e-3)
        world_min[w] = lo
        world_inv_ext[w] = 1.0 / ext

        q = np.clip(
            ((centers - lo) / ext * MORTON_CELLS).astype(np.int64),
            0, MORTON_CELLS - 1,
        ).astype(np.uint32)
        key = morton_interleave(q[:, 0]) | (morton_interleave(q[:, 1]) << 1)
        # invalid segments sort last, so pure-padding tiles form at the end
        key = np.where(v, key.astype(np.int64), np.int64(1) << 40)
        order = np.argsort(key, kind="stable")

        p = centers[order]
        cy = np.cos(yaw[w][order])
        sy = np.sin(yaw[w][order])
        h = scale[w, :, 0:2][order]
        et = etype[w][order]
        va = v[order]
        # collision-pair whitelist (reference: src/sim.hpp:88-102), masked
        # to valid entries so padding never hits
        allow_veh = ((et == C.ET_ROAD_EDGE) | (et == C.ET_STOP_SIGN)) & va
        allow_other = (et == C.ET_STOP_SIGN) & va

        fw = np.stack(
            [
                p[:, 0], p[:, 1], cy, sy, h[:, 0], h[:, 1],
                allow_veh.astype(np.float32), allow_other.astype(np.float32),
            ],
            axis=0,
        ).astype(np.float32)  # [8, R]
        feat[w] = fw.reshape(8, T, tile).transpose(1, 0, 2)

        va_t = va.reshape(T, tile)
        p_t = p.reshape(T, tile, 2)
        reach = np.hypot(h[:, 0], h[:, 1]).reshape(T, tile)
        big = np.float32(3.0e38)
        px = np.where(va_t, p_t[..., 0], big)
        py = np.where(va_t, p_t[..., 1], big)
        bounds[w, :, 0] = px.min(axis=1)
        bounds[w, :, 1] = py.min(axis=1)
        bounds[w, :, 2] = np.where(va_t, p_t[..., 0], -big).max(axis=1)
        bounds[w, :, 3] = np.where(va_t, p_t[..., 1], -big).max(axis=1)
        bounds[w, :, 4] = np.where(va_t, reach, 0.0).max(axis=1)
        bounds[w, :, 5] = va_t.any(axis=1)

    return RoadTiles(
        feat=torch.from_numpy(feat).to(device),
        bounds=torch.from_numpy(bounds).to(device),
        world_min=torch.from_numpy(world_min).to(device),
        world_inv_ext=torch.from_numpy(world_inv_ext).to(device),
    )

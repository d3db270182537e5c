"""Agent-road narrow-phase kernels K2 (dense) and K1 (tile-skip).

Port of ``gpudrive_lab_tpu/core/pallas_kernels.py``.  Each kernel is
hand-written CUDA (``csrc/agent_road.cu``) behind a wrapper that allocates
the output, checks its inputs and counts its launches
(``<wrapper>.launches``).  Beside each wrapper is its plain PyTorch version,
which the wrapper uses for CPU tensors only; a CUDA tensor launches the
kernel or raises.

Feature rows (float32):
  agents [W, A, 8]  px, py, cos, sin, half0, half1, active, is_vehicle
  roads  [W, 8, R]  px, py, cos, sin, half0, half1, allow_veh, allow_other

K2 ``agent_road_hits_dense`` replaces ``agent_road_hits_pallas`` /
``_ar_kernel`` (pallas_kernels.py:30-80, 176-199).  In the port it carries
the dense branch of collision_system at the default road buckets, where
eager PyTorch would write the whole [W, A, R] lattice to memory.  Bound on
the H100 at the slice's shapes (W=512, A=128, R=256): 16.8 M pair tests of
SAT_FLOPS fp32 operations each over ~6 MB of input, so operations, not
bytes, bound it.  Design: one block per world and one thread per agent; the
world's roads go through shared memory in chunks of 256 and every thread of
the block reads the same segment at once, so each road byte is read from
device memory once per world.

K1 ``agent_road_hits_tiled`` replaces ``agent_road_hits_tiled`` /
``_ar_tiled_kernel`` / ``_sat_hits`` (pallas_kernels.py:89-173).  It runs
when the scene has Morton-sorted road tiles (road buckets >= 2048, or
``use_tile_collision=True``).  Bound: the pair tests of the live
[agent-block, tile] pairs (data dependent: counted from the mask), at
SAT_FLOPS each; the skipped tiles are neither read nor tested.  Design: one
block per (world, 16-agent block), 16 threads per agent; the block reads its
mask row itself and skips dead tiles together, stages each live tile in
shared memory and ORs the hits with warp shuffles.

Both give bitwise the same hits as their plain versions: the CUDA file
builds with --fmad=false and keeps the plain version's operation order.
"""

from __future__ import annotations

import ctypes

import torch

from gpudrive_lab_torch import cuda_build

AGENT_F = 8
ROAD_F = 8
# Agents per block of the tile-skip kernel; A must be a multiple.
AGENT_BLOCK = 16
# fp32 operations per SAT pair test, counted from _sat_hits (adds,
# subtracts, multiplies and compares; abs, negation and selects not
# counted): 2 deltas, 6 for cos/sin of the relative yaw, 12 for the two
# frame rotations, 16 for the four separation bounds, 4 compares, 2 for the
# allow/active product, 1 for the running max.
SAT_FLOPS = 43


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


def agent_road_hits_tiled_plain(agents: torch.Tensor, tiles: torch.Tensor,
                                mask: torch.Tensor):
    """Plain version of K1: [W, A] float32 any-hit over the road tiles that
    ``mask`` marks reachable from each agent's 16-agent block."""
    if tiles.shape[1] == 0:
        return agents.new_zeros(agents.shape[:2])
    hit = _sat_hits(agents[:, None], tiles)  # [W, T, A, RT]
    live = mask.repeat_interleave(AGENT_BLOCK, dim=1).transpose(1, 2) > 0
    return torch.where(live[..., None], hit, 0.0).amax(dim=(1, 3))


def _check(t: torch.Tensor, name: str, dtype, ndim: int):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _lib():
    lib = cuda_build.load("agent_road")
    if not getattr(lib, "_argtypes_set", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.agent_road_hits_dense.argtypes = [p, p, p, i, i, i, p]
        lib.agent_road_hits_dense.restype = i
        lib.agent_road_hits_tiled.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.agent_road_hits_tiled.restype = i
        lib._argtypes_set = True
    return lib


def agent_road_hits_dense(agents: torch.Tensor, roads_t: torch.Tensor):
    """K2.  agents [W, A, 8] float32; roads_t [W, 8, R] float32 (any R).
    Returns [W, A] float32 (1.0 = some allowed road box overlaps)."""
    _check(agents, "agents", torch.float32, 3)
    _check(roads_t, "roads_t", torch.float32, 3)
    W, A, fa = agents.shape
    if fa != AGENT_F or roads_t.shape[:2] != (W, ROAD_F):
        raise ValueError(
            f"shapes {tuple(agents.shape)} and {tuple(roads_t.shape)}: "
            f"expected [W, A, {AGENT_F}] and [W, {ROAD_F}, R]"
        )
    if agents.device.type == "cpu" and roads_t.device.type == "cpu":
        return agent_road_hits_dense_plain(agents, roads_t)
    if agents.device.type != "cuda" or roads_t.device != agents.device:
        raise ValueError(
            f"agents on {agents.device}, roads on {roads_t.device}: both "
            "must be on one CUDA device (or both on the CPU)"
        )
    R = roads_t.shape[2]
    out = torch.empty((W, A), dtype=torch.float32, device=agents.device)
    if W == 0 or A == 0:
        return out
    if R == 0:
        return out.zero_()
    status = _lib().agent_road_hits_dense(
        agents.data_ptr(), roads_t.data_ptr(), out.data_ptr(), W, A, R,
        torch.cuda.current_stream(agents.device).cuda_stream,
    )
    cuda_build.check(status, "agent_road_hits_dense")
    agent_road_hits_dense.launches += 1
    return out


agent_road_hits_dense.launches = 0


def agent_road_hits_tiled(agents: torch.Tensor, tiles: torch.Tensor,
                          mask: torch.Tensor):
    """K1.  agents [W, A, 8] float32 (Morton-sorted by the caller, A a
    multiple of 16); tiles [W, T, 8, RT] float32 (Scene.rtiles.feat);
    mask [W, A/16, T] int32.  Returns [W, A] float32 any-hit flags in the
    caller's (sorted) agent order."""
    _check(agents, "agents", torch.float32, 3)
    _check(tiles, "tiles", torch.float32, 4)
    _check(mask, "mask", torch.int32, 3)
    W, A, fa = agents.shape
    T, RT = tiles.shape[1], tiles.shape[3]
    if (fa != AGENT_F or A % AGENT_BLOCK or tiles.shape[:3] != (W, T, ROAD_F)
            or mask.shape != (W, A // AGENT_BLOCK, T)):
        raise ValueError(
            f"shapes agents {tuple(agents.shape)}, tiles "
            f"{tuple(tiles.shape)}, mask {tuple(mask.shape)}: expected "
            f"[W, A, {AGENT_F}] (A % {AGENT_BLOCK} == 0), "
            f"[W, T, {ROAD_F}, RT], [W, A/{AGENT_BLOCK}, T]"
        )
    devs = {agents.device, tiles.device, mask.device}
    if devs == {torch.device("cpu")}:
        return agent_road_hits_tiled_plain(agents, tiles, mask)
    if len(devs) != 1 or agents.device.type != "cuda":
        raise ValueError(f"inputs on {devs}: must share one CUDA device")
    if ROAD_F * RT * 4 > 48 * 1024:
        raise ValueError(f"tile size {RT} exceeds the kernel's shared memory")
    out = torch.zeros((W, A), dtype=torch.float32, device=agents.device)
    if W == 0 or A == 0 or T == 0:
        return out
    status = _lib().agent_road_hits_tiled(
        agents.data_ptr(), tiles.data_ptr(), mask.data_ptr(), out.data_ptr(),
        W, A, T, RT, torch.cuda.current_stream(agents.device).cuda_stream,
    )
    cuda_build.check(status, "agent_road_hits_tiled")
    agent_road_hits_tiled.launches += 1
    return out


agent_road_hits_tiled.launches = 0

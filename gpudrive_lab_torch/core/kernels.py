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
eager PyTorch would write the whole [W, A, R] lattice to memory.  Only the
pairs of an active agent and a road its class may hit can raise an agent's
hit above +0.0 (``live_pairs``): at the slice's reset state (W=512, A=128,
R=256) 188,679 of the 16.8 M lattice pairs, so ~6.5 MB of input, not the
SAT, bound it on the H100.  Design: one block per world; the block compacts
its live agents and its collidable roads (in chunks of 256) into shared
memory and spreads their pairs over all its threads; a pair that the SAT's
first two axis tests separate stops there.

K1 ``agent_road_hits_tiled`` replaces ``agent_road_hits_tiled`` /
``_ar_tiled_kernel`` / ``_sat_hits`` (pallas_kernels.py:89-173).  It runs
when the scene has Morton-sorted road tiles (road buckets >= 2048, or
``use_tile_collision=True``).  Bound: the bytes of the tiles live for some
agent block, or the SAT operations of the live pairs inside the live
[agent-block, tile] pairs (``live_pair_ops_tiled``), whichever is larger.
Design: one block per world, so a tile live for several agent blocks is
staged once; the block walks its live tiles with cp.async double buffering
and tests each tile's collidable roads against the live agents whose block
marks the tile.

Both write every output row and take each agent's max with atomicMax on
the bits of a non-negative float, so every launch gives the same bits.
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


def agent_road_hits_tiled_plain(agents: torch.Tensor, tiles: torch.Tensor,
                                mask: torch.Tensor):
    """Plain version of K1: [W, A] float32 any-hit over the road tiles that
    ``mask`` marks reachable from each agent's 16-agent block."""
    if tiles.shape[1] == 0:
        return agents.new_zeros(agents.shape[:2])
    hit = _sat_hits(agents[:, None], tiles)  # [W, T, A, RT]
    live = mask.repeat_interleave(AGENT_BLOCK, dim=1).transpose(1, 2) > 0
    return torch.where(live[..., None], hit, 0.0).amax(dim=(1, 3))


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


def live_pairs_tiled(agents: torch.Tensor, tiles: torch.Tensor,
                     mask: torch.Tensor) -> int:
    """The pairs of ``live_pairs`` inside the [agent-block, tile] pairs that
    ``mask`` marks live: the work K1 cannot skip."""
    live = mask.repeat_interleave(AGENT_BLOCK, dim=1) > 0  # [W, A, T]
    return int(torch.where(live, _live_counts(agents, tiles), 0).sum())


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
    out = torch.empty((W, A), dtype=torch.float32, device=agents.device)
    if W == 0 or A == 0:
        return out
    if T == 0:
        return out.zero_()
    status = _lib().agent_road_hits_tiled(
        agents.data_ptr(), tiles.data_ptr(), mask.data_ptr(), out.data_ptr(),
        W, A, T, RT, torch.cuda.current_stream(agents.device).cuda_stream,
    )
    cuda_build.check(status, "agent_road_hits_tiled")
    agent_road_hits_tiled.launches += 1
    return out


agent_road_hits_tiled.launches = 0

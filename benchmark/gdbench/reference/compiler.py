"""Scene compiler of the plain reference: parsed maps -> padded world tensors.

A frozen copy of the Python path of the port's ``scene/compiler.py``
(reference: src/level_gen.cpp:396-465 createPersistentEntities and
helpers).  Each world compiles to struct-of-arrays numpy blocks padded to
A = 128 agents and a bucketed road count; ``build_scene`` stacks them into
a ``Scene`` of torch tensors on the requested device.  The port compiles
with its native C++ compiler, which agrees with this path to 2e-4.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses

import numpy as np
import torch

from . import constants as C
from .types import (
    AgentsStatic,
    DynamicsModel,
    Params,
    RoadGraph,
    Scene,
)
from .loader import load_map
from .rtiles import (
    TILE_COLLISION_MIN_R,
    build_road_tiles,
)

DT = C.DYNAMICS_DT


def _libm_atan2f():
    try:
        libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    except OSError:
        return None
    fn = libm.atan2f
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    return np.frompyfunc(fn, 2, 1)


_ATAN2F = _libm_atan2f()


def atan2f(y, x) -> np.ndarray:
    """atan2 of float32 operands as the C library's ``atan2f`` rounds it
    (the simulator's compiler calls std::atan2 on floats); numpy's float32
    arctan2 differs from it in the last bit now and then."""
    y = np.asarray(y, np.float32)
    x = np.asarray(x, np.float32)
    if _ATAN2F is None:
        return np.arctan2(y, x)
    return np.asarray(_ATAN2F(y, x), dtype=np.float32)


def _normalize_angle(a: np.ndarray) -> np.ndarray:
    ret = np.fmod(a, 2 * np.pi)
    return np.where(
        ret > np.pi, ret - 2 * np.pi,
        np.where(ret < -np.pi, ret + 2 * np.pi, ret),
    )


def _inverse_bicycle_np(pos, vel, heading):
    """Vectorized inverseBicycleModel over the trajectory
    (reference: src/dynamics.hpp:117-149 via src/level_gen.cpp:70-99).
    Matches the reference's behavior of computing inverse actions from the
    raw (possibly invalid) log states for every step."""
    speed = np.linalg.norm(vel, axis=-1)
    accel = np.zeros(C.TRAJECTORY_LEN, np.float32)
    steer = np.zeros(C.TRAJECTORY_LEN, np.float32)
    accel[:-1] = (speed[1:] - speed[:-1]) / DT
    yaw = _normalize_angle(heading)
    if C.USE_ESTIMATED_YAW:
        target_yaw = np.arctan2(vel[1:, 1], vel[1:, 0])
    else:
        target_yaw = yaw[1:]
    denom = speed[:-1] * DT + 0.5 * accel[:-1] * DT * DT
    steer[:-1] = np.where(
        denom != 0.0,
        (target_yaw - yaw[:-1]) / np.where(denom == 0.0, 1.0, denom),
        0.0,
    )
    out = np.zeros((C.TRAJECTORY_LEN, C.ACTION_DIM), np.float32)
    out[:, 0] = accel
    out[:, 1] = steer
    return out


def _inverse_delta_np(pos, heading):
    """Vectorized inverseDeltaModel (reference: src/dynamics.hpp:151-184)."""
    d = np.clip(pos[1:] - pos[:-1], -6.0, 6.0)
    yaw = heading[:-1]
    c, s = np.cos(-yaw), np.sin(-yaw)
    local_dx = np.clip(d[:, 0] * c - d[:, 1] * s, -6.0, 6.0)
    local_dy = np.clip(d[:, 0] * s + d[:, 1] * c, -6.0, 6.0)
    dyaw = _normalize_angle(heading[1:] - heading[:-1])
    out = np.zeros((C.TRAJECTORY_LEN, C.ACTION_DIM), np.float32)
    out[:-1, 0] = local_dx
    out[:-1, 1] = local_dy
    out[:-1, 2] = dyaw
    return out


def _zero_action(model: DynamicsModel) -> np.ndarray:
    """getZeroAction (reference: src/level_gen.hpp:16-38)."""
    a = np.zeros(C.ACTION_DIM, np.float32)
    if model == DynamicsModel.STATE:
        a[2] = 1.0  # StateAction zero has position z=1
    return a


@dataclasses.dataclass
class CompiledWorld:
    """Arrays for one world, agents padded to A, roads unpadded."""

    agent: dict
    road: dict
    num_agents: int
    num_roads: int
    mean: np.ndarray
    map_name: np.ndarray
    scenario_id: np.ndarray


def _should_create(obj, params: Params, deleted: frozenset) -> bool:
    """shouldAgentBeCreated (reference: src/level_gen.cpp:353-394)."""
    if params.read_from_tracks_to_predict:
        return obj["oid"] not in deleted
    if params.ignore_non_vehicles and obj["etype"] in (
        C.ET_PEDESTRIAN, C.ET_CYCLIST
    ):
        return False
    if obj["etype"] == C.ET_NONE:
        # The reference would assert on these (src/level_gen.cpp:132); the
        # dataset contains none, we drop them defensively.
        return False
    if params.init_only_valid_agents and not obj["valid"][0]:
        return False
    return obj["oid"] not in deleted


def compile_world(
    path: str, params: Params, deleted: frozenset = frozenset()
) -> CompiledWorld:
    m = load_map(path, params.polyline_reduction_threshold)
    mean = m["mean"]
    A, T = C.MAX_AGENTS, C.TRAJECTORY_LEN

    ag = dict(
        valid=np.zeros(A, bool),
        etype=np.zeros(A, np.int32),
        size=np.zeros((A, 3), np.float32),
        goal=np.zeros((A, 2), np.float32),
        aid=np.full(A, -1, np.int32),
        controlled=np.zeros(A, bool),
        static=np.zeros(A, bool),
        mark_as_expert=np.zeros(A, bool),
        metadata=np.full((A, 4), -1, np.int32),
        traj_pos=np.zeros((A, T, 2), np.float32),
        traj_vel=np.zeros((A, T, 2), np.float32),
        traj_yaw=np.zeros((A, T), np.float32),
        traj_valid=np.zeros((A, T), np.float32),
        traj_inv_actions=np.zeros((A, T, C.ACTION_DIM), np.float32),
    )

    num_controlled = 0
    idx = 0
    for obj in m["objects"]:
        if idx >= A:
            break
        if not _should_create(obj, params, deleted):
            continue
        # createAgent (src/level_gen.cpp:131-164)
        ag["valid"][idx] = True
        ag["etype"][idx] = obj["etype"]
        ag["size"][idx] = obj["size"]
        ag["goal"][idx] = obj["goal"] - mean
        ag["aid"][idx] = obj["oid"]
        ag["metadata"][idx] = obj["metadata"]
        ag["mark_as_expert"][idx] = obj["mark_as_expert"]
        # populateExpertTrajectory (src/level_gen.cpp:56-100)
        ag["traj_pos"][idx] = obj["pos"] - mean
        ag["traj_vel"][idx] = obj["vel"]
        ag["traj_yaw"][idx] = obj["heading"]
        ag["traj_valid"][idx] = obj["valid"]
        if params.dynamics_model == DynamicsModel.INVERTIBLE_BICYCLE:
            ag["traj_inv_actions"][idx] = _inverse_bicycle_np(
                ag["traj_pos"][idx], obj["vel"], obj["heading"]
            )
        elif params.dynamics_model == DynamicsModel.DELTA_LOCAL:
            ag["traj_inv_actions"][idx] = _inverse_delta_np(
                ag["traj_pos"][idx], obj["heading"]
            )
        else:
            ag["traj_inv_actions"][idx] = _zero_action(params.dynamics_model)

        # isAgentStatic (src/level_gen.cpp:102-113)
        if params.read_from_tracks_to_predict and obj["metadata"][2] != -1:
            static = False
        else:
            dist = np.linalg.norm(ag["goal"][idx] - ag["traj_pos"][idx, 0])
            static = (not params.is_static_agent_controlled) and (
                dist < C.STATIC_THRESHOLD
            )
        ag["static"][idx] = static

        # isAgentControllable (src/level_gen.cpp:115-129)
        if params.read_from_tracks_to_predict:
            controllable = (
                num_controlled < params.max_num_controlled_agents
                and obj["metadata"][2] != -1
            )
        else:
            controllable = (
                num_controlled < params.max_num_controlled_agents
                and bool(obj["valid"][0])
                and not static
                and not obj["mark_as_expert"]
            )
        ag["controlled"][idx] = controllable
        num_controlled += int(controllable)
        idx += 1
    num_agents = idx

    # createRoadEntities (src/level_gen.cpp:166-296)
    r_pos, r_yaw, r_scale, r_type, r_id, r_map = [], [], [], [], [], []

    def emit(pos3, yaw, scale3, etype, rid, map_type):
        r_pos.append(pos3)
        r_yaw.append(yaw)
        r_scale.append(scale3)
        r_type.append(etype)
        r_id.append(rid)
        r_map.append(map_type)

    for road in m["roads"]:
        if len(r_pos) >= C.MAX_ROAD_ENTITIES:
            break
        et = road["etype"]
        g = road["geometry"]
        if et in (C.ET_ROAD_EDGE, C.ET_ROAD_LINE, C.ET_ROAD_LANE):
            # makeRoadEdge per consecutive pair (src/level_gen.cpp:166-185)
            z = 1.0 + (
                C.LIDAR_ROAD_EDGE_OFFSET
                if et == C.ET_ROAD_EDGE
                else C.LIDAR_ROAD_LINE_OFFSET
            )
            p1 = g[:-1] - mean
            p2 = g[1:] - mean
            mid = (p1 + p2) / 2.0
            d = p2 - p1
            yaws = atan2f(d[:, 1], d[:, 0])
            half = np.linalg.norm(d, axis=-1) / 2.0
            for k in range(len(mid)):
                if len(r_pos) >= C.MAX_ROAD_ENTITIES:
                    break
                emit(
                    np.array([mid[k, 0], mid[k, 1], z], np.float32),
                    yaws[k],
                    np.array([half[k], 0.1, 0.1], np.float32),
                    et, road["rid"], road["map_type"],
                )
        elif et in (C.ET_CROSSWALK, C.ET_SPEED_BUMP):
            # makeCube from the first 4 points (src/level_gen.cpp:191-241)
            pts = g[:4]
            lengths = np.linalg.norm(np.roll(pts, -1, axis=0) - pts, axis=-1)
            i_max = int(np.argmax(lengths))
            i_min = int(np.argmin(lengths))
            start, end = pts[i_max], pts[(i_max + 1) % 4]
            angle = atan2f(np.float32(end[1] - start[1]),
                           np.float32(end[0] - start[0]))
            center = pts.mean(axis=0) - mean
            emit(
                np.array(
                    [center[0], center[1], 1.0 + C.LIDAR_ROAD_LINE_OFFSET],
                    np.float32,
                ),
                angle,
                np.array(
                    [lengths[i_max] / 2, lengths[i_min] / 2, 0.1], np.float32
                ),
                et, road["rid"], road["map_type"],
            )
        elif et == C.ET_STOP_SIGN:
            # makeStopSign (src/level_gen.cpp:243-256)
            p = g[0] - mean
            emit(
                np.array([p[0], p[1], 1.0], np.float32),
                0.0,
                np.array([0.2, 0.2, 1.0], np.float32),
                et, road["rid"], road["map_type"],
            )
        # EntityType::None (e.g. driveways): no entity created
        # (src/level_gen.cpp:293-294).

    num_roads = len(r_pos)
    road = dict(
        pos=np.asarray(r_pos, np.float32).reshape(num_roads, 3),
        yaw=np.asarray(r_yaw, np.float32),
        scale=np.asarray(r_scale, np.float32).reshape(num_roads, 3),
        etype=np.asarray(r_type, np.int32),
        rid=np.asarray(r_id, np.int32),
        map_type=np.asarray(r_map, np.int32),
    )

    mean3 = np.array([mean[0], mean[1], 0.0], np.float32)
    return CompiledWorld(
        agent=ag, road=road, num_agents=num_agents, num_roads=num_roads,
        mean=mean3, map_name=m["map_name_codes"],
        scenario_id=m["scenario_id_codes"],
    )


def _bucket(n: int, bucket: int = 256) -> int:
    """Round the road capacity up to a multiple of ``bucket`` (256), as the
    JAX package does, so both packages give the same road axis."""
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def build_scene(
    paths: list[str],
    params: Params,
    deleted: dict[int, frozenset] | None = None,
    max_agents: int | str | None = None,
    device=None,
) -> Scene:
    """Compile a batch of scenario JSONs into one stacked Scene.

    Road capacity is the batch's largest road count bucketed to a multiple
    of 256.  ``max_agents`` buckets the agent axis: None keeps
    the reference's fixed 128 rows; "auto" (or an explicit cap) shrinks it
    to the batch maximum rounded up to a multiple of 16.  At
    road buckets of ``TILE_COLLISION_MIN_R`` or more the scene carries its
    road tiles.  Tensors land on ``device``.
    """
    worlds = [
        compile_world(p, params, (deleted or {}).get(i, frozenset()))
        for i, p in enumerate(paths)
    ]
    return stack_worlds(worlds, params, max_agents, device)


def stack_worlds(worlds: list, params: Params,
                 max_agents: int | str | None = None, device="cpu") -> Scene:
    """Stack compiled worlds into one Scene (``build_scene``'s second half)."""
    device = torch.device(device)
    R = _bucket(max(w.num_roads for w in worlds))

    def pad_road(x, fill=0):
        pad = [(0, R - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, pad, constant_values=fill)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    if max_agents is None:
        A_b = C.MAX_AGENTS
    else:
        need = max(w.num_agents for w in worlds)
        cap = need if max_agents == "auto" else int(max_agents)
        if cap < need:
            raise ValueError(
                f"max_agents={cap} below batch requirement {need}"
            )
        A_b = min(C.MAX_AGENTS, _bucket(cap, 16))
    agents = AgentsStatic(
        **{
            k: t(np.stack([w.agent[k][:A_b] for w in worlds]))
            for k in worlds[0].agent
        }
    )
    r_pos = np.stack([pad_road(w.road["pos"]) for w in worlds])
    r_yaw = np.stack([pad_road(w.road["yaw"]) for w in worlds])
    r_scale = np.stack([pad_road(w.road["scale"]) for w in worlds])
    r_etype = np.stack([pad_road(w.road["etype"]) for w in worlds])
    r_valid = np.stack([np.arange(R) < w.num_roads for w in worlds])
    roads = RoadGraph(
        pos=t(r_pos),
        yaw=t(r_yaw),
        scale=t(r_scale),
        etype=t(r_etype),
        rid=t(np.stack([pad_road(w.road["rid"], -1) for w in worlds])),
        map_type=t(
            np.stack([pad_road(w.road["map_type"], -1) for w in worlds])
        ),
        valid=t(r_valid),
    )
    rtiles = None
    if params.use_tile_collision is True or (
        params.use_tile_collision is None and R >= TILE_COLLISION_MIN_R
    ):
        rtiles = build_road_tiles(
            r_pos, r_yaw, r_scale, r_etype, r_valid, device=device
        )
    return Scene(
        agents=agents,
        roads=roads,
        num_agents=t(np.asarray([w.num_agents for w in worlds], np.int32)),
        num_roads=t(np.asarray([w.num_roads for w in worlds], np.int32)),
        means=t(np.stack([w.mean for w in worlds])),
        map_name=t(np.stack([w.map_name for w in worlds])),
        scenario_id=t(np.stack([w.scenario_id for w in worlds])),
        rtiles=rtiles,
    )

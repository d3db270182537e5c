"""Seeded synthetic large maps in the simulator's scene JSON schema.

The road network is a frozen copy of the generator of the port's
``scene/large_map.py`` (``_generate``): per world, polylines of
``SEGMENTS_PER_POLYLINE`` segments of ``SEGMENT_LENGTH`` metres from a
random start and heading, the heading drifting per step, wrapped into a
square of ``side`` metres; about 40 % road edges, the rest lanes and lines,
and a few stop signs.  ``n_active`` vehicles stand on random segments
within ``AGENT_RADIUS`` of a random centre, as a scenario's agents gather
around its ego vehicle.

Written out as scene JSON, each wrapped polyline is split where it
crosses an edge of the square, so that no segment spans the square.  What
the network generator does not give is filled simply, and the traffic
file lists each fill under ``assumed``: every vehicle is logged at one
constant speed along its heading for the 91 steps, all valid, its goal
``GOAL_AHEAD`` metres ahead, 1.5 m tall; a stop sign is a one-point road
at its segment's centre, beside the segment, and comes first among the
roads.
"""

from __future__ import annotations

import hashlib
import json
import math
from pathlib import Path

import numpy as np

ET_ROAD_EDGE, ET_ROAD_LINE, ET_ROAD_LANE, ET_STOP_SIGN = 1, 2, 3, 6
ROAD_TYPE = {ET_ROAD_EDGE: "road_edge", ET_ROAD_LINE: "road_line",
             ET_ROAD_LANE: "lane"}
VEHICLE_LENGTH_SCALE = 0.7
SEGMENT_LENGTH = 4.0  # metres
EDGE_SHARE = 0.4  # of the polylines
STOP_SIGN_SHARE = 0.001  # of the segments
AGENT_RADIUS = 80.0  # metres around a world's centre of traffic
VEHICLE_HALF = (4.5 * 0.5 * VEHICLE_LENGTH_SCALE,
                2.0 * 0.5 * VEHICLE_LENGTH_SCALE)
STEPS = 91
DT = 0.1
GOAL_AHEAD = 40.0  # metres
HEIGHT = 1.5


def generate(W: int, A: int, R: int, n_active: int, side: float, seed: int,
             segments_per_polyline: int = 64) -> dict:
    """The map's host arrays from ``seed``: the segment centres mid
    [W, R, 2], their yaw, the polylines' start and heading, the segment
    types, the stop-sign mask and the agent rows [W, A, 8] (px, py, cos,
    sin, half0, half1, active, is_vehicle) with their yaw."""
    if R % segments_per_polyline or A % 16 or n_active > A:
        raise ValueError(f"W={W} A={A} R={R} n_active={n_active}")
    rng = np.random.default_rng(seed)
    n_poly = R // segments_per_polyline
    start = rng.uniform(0.0, side, (W, n_poly, 1, 2))
    heading = (rng.uniform(-np.pi, np.pi, (W, n_poly, 1))
               + np.cumsum(rng.normal(0.0, 0.08,
                                      (W, n_poly, segments_per_polyline)),
                           -1))
    step = SEGMENT_LENGTH * np.stack([np.cos(heading), np.sin(heading)], -1)
    ends = start + np.cumsum(step, axis=2)
    mid = np.mod(ends - 0.5 * step, side).reshape(W, R, 2)
    yaw = np.arctan2(np.sin(heading), np.cos(heading)).reshape(W, R)
    kind = rng.choice([ET_ROAD_EDGE, ET_ROAD_LANE, ET_ROAD_LINE],
                      (W, n_poly, 1), p=[EDGE_SHARE, 0.35, 0.25])
    etype = np.broadcast_to(kind, (W, n_poly, segments_per_polyline))
    etype = etype.reshape(W, R).copy()
    stop = rng.random((W, R)) < STOP_SIGN_SHARE
    etype[stop] = ET_STOP_SIGN

    centre = rng.uniform(AGENT_RADIUS, side - AGENT_RADIUS, (W, 1, 2))
    near = np.hypot(*np.moveaxis(mid - centre, -1, 0)) <= AGENT_RADIUS
    seg = np.stack([rng.choice(np.flatnonzero(n), n_active) for n in near])
    side_off = rng.normal(0.0, 1.5, (W, n_active))
    a_yaw = (np.take_along_axis(yaw, seg, 1)
             + rng.normal(0.0, 0.1, (W, n_active)))
    normal = np.stack([-np.sin(a_yaw), np.cos(a_yaw)], -1)
    a_pos = (np.take_along_axis(mid, seg[..., None], 1)
             + side_off[..., None] * normal)
    agents = np.zeros((W, A, 8), np.float32)
    agents[:, :n_active, 0:2] = a_pos
    agents[:, :n_active, 2] = np.cos(a_yaw)
    agents[:, :n_active, 3] = np.sin(a_yaw)
    agents[:, :n_active, 4] = VEHICLE_HALF[0] * rng.uniform(0.8, 1.2,
                                                            (W, n_active))
    agents[:, :n_active, 5] = VEHICLE_HALF[1] * rng.uniform(0.9, 1.1,
                                                            (W, n_active))
    agents[:, :n_active, 6] = 1.0
    agents[:, :, 7] = 1.0
    return dict(mid=mid, yaw=yaw, start=start, heading=heading,
                kind=kind[..., 0], etype=etype, stop=stop, agents=agents, a_yaw=a_yaw,
                speed=rng.uniform(0.0, 10.0, (W, n_active)))


def _xy(p) -> dict:
    return {"x": float(p[0]), "y": float(p[1]), "z": 0.0}


def world_json(g: dict, w: int, side: float, n_active: int,
               segments_per_polyline: int) -> dict:
    """World ``w`` of ``generate``'s arrays as scene JSON."""
    n_poly = g["start"].shape[1]
    step = SEGMENT_LENGTH * np.stack(
        [np.cos(g["heading"][w]), np.sin(g["heading"][w])], -1)
    points = np.concatenate(
        [g["start"][w], g["start"][w] + np.cumsum(step, axis=1)], axis=1)
    points = np.mod(points, side)  # [n_poly, S + 1, 2]
    # stop signs first: the compiler keeps the first 10,000 road entities
    roads = [{"geometry": [_xy(g["mid"][w, i])], "type": "stop_sign",
              "map_element_id": 17, "id": n}
             for n, i in enumerate(np.flatnonzero(g["stop"][w]))]
    for k in range(n_poly):
        pts = points[k]
        jump = np.flatnonzero(np.abs(np.diff(pts, axis=0)).max(-1)
                              > 0.5 * side)
        for part in np.split(pts, jump + 1):
            if len(part) >= 2:
                roads.append({"geometry": [_xy(p) for p in part],
                              "type": ROAD_TYPE[int(g["kind"][w, k])],
                              "map_element_id": 15, "id": len(roads)})
    objects = []
    ag = g["agents"][w]
    for i in range(n_active):
        yaw = float(g["a_yaw"][w, i])
        v = float(g["speed"][w, i])
        d = np.array([math.cos(yaw), math.sin(yaw)])
        pos = [ag[i, 0:2] + d * v * DT * t for t in range(STEPS)]
        objects.append({
            "position": [_xy(p) for p in pos],
            "width": float(2.0 * ag[i, 5] / VEHICLE_LENGTH_SCALE),
            "length": float(2.0 * ag[i, 4] / VEHICLE_LENGTH_SCALE),
            "height": HEIGHT,
            "heading": [yaw] * STEPS,
            "velocity": [{"x": v * d[0], "y": v * d[1]}] * STEPS,
            "valid": [True] * STEPS,
            "goalPosition": _xy(ag[i, 0:2] + d * GOAL_AHEAD),
            "type": "vehicle", "id": i, "mark_as_expert": False,
        })
    name = f"large_map_{w:04d}.json"
    return {"name": name, "scenario_id": f"largemap{w:04d}",
            "objects": objects, "roads": roads, "tl_states": {},
            "metadata": {"sdc_track_index": 0, "objects_of_interest": [],
                         "tracks_to_predict": []}}


def scene_paths(spec: dict, cache_root: Path) -> list:
    """The scene JSON files of the large map ``spec`` (the traffic file's
    ``scenes`` entry), written once into a directory of ``cache_root``
    named by a digest of the spec; later runs find them there."""
    keys = ("W", "A", "R", "n_active", "side", "map_seed",
            "segments_per_polyline")
    params = {k: spec[k] for k in keys}
    digest = hashlib.sha256(json.dumps(params, sort_keys=True).encode()
                            ).hexdigest()[:16]
    out = cache_root / f"large_map-{digest}"
    names = [f"large_map_{w:04d}.json" for w in range(spec["W"])]
    if (out / "complete").exists():
        return [str(out / n) for n in names]
    out.mkdir(parents=True, exist_ok=True)
    g = generate(spec["W"], spec["A"], spec["R"], spec["n_active"],
                 spec["side"], spec["map_seed"],
                 spec["segments_per_polyline"])
    for w, n in enumerate(names):
        tmp = out / (n + ".tmp")
        with open(tmp, "w") as f:
            json.dump(world_json(g, w, spec["side"], spec["n_active"],
                                 spec["segments_per_polyline"]), f)
        tmp.replace(out / n)
    (out / "complete").write_text(json.dumps(params))
    return [str(out / n) for n in names]

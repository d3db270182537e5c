"""Seeded synthetic WOMD scenarios for the ingest chain (no counterpart in
the JAX package; its tests build such scenarios by hand,
tests/test_data_utils.py).

``synthetic_scenarios`` describes each scenario once, from
``numpy.random.default_rng(seed)``, and gives it either as plain Python
objects with the Scenario proto's attribute surface (what
``waymo_converter.scenario_to_dict`` reads; no protobuf needed) or as
messages of a Scenario ``pb2`` module (the vendored subset or the official
one), which a TFRecord shard can carry.  The proto's float fields
(length, width, height, heading, velocity) are rounded to float32 in both
forms, so both convert to the same JSON.

Each scenario has ``num_tracks`` tracks of 91 states (vehicles driving
straight, making a U-turn or reversing for 30 steps, parked vehicles,
pedestrians and cyclists; some tracks start invalid) on a road of
``num_lanes`` lanes between two road edges with road lines, a stop sign,
a crosswalk, a speed bump and a driveway.  Scenario ``i`` with
``i % 8 == 7`` carries a traffic-light state, which the converter
filters out.
"""

from __future__ import annotations

import types

import numpy as np

STEPS = 91
DT = 0.1
LANE_WIDTH = 4.0
ROAD_LENGTH = 200.0


def _f32(x) -> float:
    return float(np.float32(x))


def _track(rng, tid: int, lanes: int) -> dict:
    """One track: id, object_type and its 91 states as dicts."""
    kind = rng.choice(["straight", "uturn", "reverse", "parked",
                       "pedestrian", "cyclist"],
                      p=[0.45, 0.1, 0.1, 0.15, 0.1, 0.1])
    otype = {"pedestrian": 2, "cyclist": 3}.get(kind, 1)
    length, width, height = {
        1: (4.5, 2.0, 1.6), 2: (0.8, 0.8, 1.8), 3: (1.8, 0.7, 1.7)}[otype]
    lane = int(rng.integers(0, lanes))
    x = float(rng.uniform(10.0, ROAD_LENGTH - 60.0))
    y = (lane + 0.5) * LANE_WIDTH + float(rng.normal(0, 0.2))
    heading = 0.0 if rng.random() < 0.7 else np.pi
    speed = {"parked": 0.0, "pedestrian": 1.4,
             "cyclist": 5.0}.get(kind, float(rng.uniform(4.0, 14.0)))
    first_valid = int(rng.integers(1, 10)) if rng.random() < 0.2 else 0
    states = []
    for t in range(STEPS):
        h = heading
        v = speed
        if kind == "uturn" and t >= 20:
            h = heading + np.pi * min(t - 20, 40) / 40.0
            v = speed * 0.5
        if kind == "reverse" and 30 <= t < 60:
            v = -2.0
        vx, vy = v * np.cos(h), v * np.sin(h)
        x += vx * DT
        y += vy * DT
        states.append(dict(
            center_x=x, center_y=y, center_z=0.0, length=_f32(length),
            width=_f32(width), height=_f32(height),
            heading=_f32(np.arctan2(np.sin(h), np.cos(h))),
            velocity_x=_f32(vx), velocity_y=_f32(vy),
            valid=t >= first_valid,
        ))
    return dict(id=tid, object_type=otype, states=states)


def _polyline(x0, x1, y, n):
    """``n`` points from x0 to x1 around the line at ``y``, with a gentle
    sway, so that polyline reduction keeps most of them."""
    return [(float(x), float(y + 0.5 * np.sin(x / 7.0)), 0.0)
            for x in np.linspace(x0, x1, n)]


def _map(lanes: int, points: int) -> list:
    """(id, kind, sub_type, points, extra) of the map features."""
    top = lanes * LANE_WIDTH
    feats = [(1, "road_edge", 1, _polyline(0, ROAD_LENGTH, -0.5, points)),
             (2, "road_edge", 1, _polyline(0, ROAD_LENGTH, top + 0.5,
                                           points))]
    fid = 10
    for k in range(lanes):
        feats.append((fid, "lane", 2, _polyline(
            0, ROAD_LENGTH, (k + 0.5) * LANE_WIDTH, points)))
        fid += 1
        if k:
            feats.append((fid, "road_line", 1 + k % 3, _polyline(
                0, ROAD_LENGTH, k * LANE_WIDTH, points)))
            fid += 1
    feats += [
        (fid, "stop_sign", 0, [(ROAD_LENGTH - 5.0, -1.0, 0.0)]),
        (fid + 1, "crosswalk", 0, [(150.0, 0.0, 0.0), (154.0, 0.0, 0.0),
                                   (154.0, top, 0.0), (150.0, top, 0.0)]),
        (fid + 2, "speed_bump", 0, [(60.0, 0.0, 0.0), (61.0, 0.0, 0.0),
                                    (61.0, top, 0.0), (60.0, top, 0.0)]),
        (fid + 3, "driveway", 0, [(90.0, top, 0.0), (96.0, top, 0.0),
                                  (96.0, top + 8.0, 0.0),
                                  (90.0, top + 8.0, 0.0)]),
    ]
    return feats


def describe(index: int, seed: int, num_tracks: int, num_lanes: int,
             points: int) -> dict:
    """The plain description of scenario ``index`` of ``seed``."""
    rng = np.random.default_rng([seed, index])
    tracks = [_track(rng, 100 + k, num_lanes) for k in range(num_tracks)]
    return dict(
        scenario_id=f"synthetic-{seed}-{index}",
        tracks=tracks,
        features=_map(num_lanes, points),
        traffic_light=index % 8 == 7,
        sdc_track_index=0,
        objects_of_interest=[tracks[1]["id"]] if num_tracks > 1 else [],
        tracks_to_predict=[(0, 1)] + ([(2, 2)] if num_tracks > 2 else []),
    )


class _Feature(types.SimpleNamespace):
    def WhichOneof(self, _oneof):
        return self._kind


def _point(p):
    return types.SimpleNamespace(x=p[0], y=p[1], z=p[2])


def as_namespace(desc: dict):
    """The description as plain objects with the Scenario proto's
    attribute surface."""
    feats = []
    for fid, kind, sub, pts in desc["features"]:
        data = types.SimpleNamespace()
        if kind == "stop_sign":
            data.position = _point(pts[0])
            data.lane = [10]
        elif kind in ("crosswalk", "speed_bump", "driveway"):
            data.polygon = [_point(p) for p in pts]
        else:
            data.type = sub
            data.polyline = [_point(p) for p in pts]
        feat = _Feature(id=fid, _kind=kind)
        setattr(feat, kind, data)
        feats.append(feat)
    lane_states = [types.SimpleNamespace(lane=10, state=3)] if desc[
        "traffic_light"] else []
    return types.SimpleNamespace(
        scenario_id=desc["scenario_id"],
        tracks=[types.SimpleNamespace(
            id=t["id"], object_type=t["object_type"],
            states=[types.SimpleNamespace(**s) for s in t["states"]])
            for t in desc["tracks"]],
        map_features=feats,
        dynamic_map_states=[types.SimpleNamespace(lane_states=lane_states)],
        sdc_track_index=desc["sdc_track_index"],
        objects_of_interest=list(desc["objects_of_interest"]),
        tracks_to_predict=[types.SimpleNamespace(track_index=i, difficulty=d)
                           for i, d in desc["tracks_to_predict"]],
    )


def as_proto(desc: dict, pb2):
    """The description as a ``pb2.Scenario`` message."""
    sc = pb2.Scenario(scenario_id=desc["scenario_id"],
                      sdc_track_index=desc["sdc_track_index"])
    for t in desc["tracks"]:
        tr = sc.tracks.add(id=t["id"], object_type=t["object_type"])
        for s in t["states"]:
            tr.states.add(**s)
    for fid, kind, sub, pts in desc["features"]:
        data = getattr(sc.map_features.add(id=fid), kind)
        if kind == "stop_sign":
            data.position.x, data.position.y, data.position.z = pts[0]
            data.lane.append(10)
            continue
        field = "polygon" if kind in ("crosswalk", "speed_bump",
                                      "driveway") else "polyline"
        if field == "polyline":
            data.type = sub
        for x, y, z in pts:
            getattr(data, field).add(x=x, y=y, z=z)
    dms = sc.dynamic_map_states.add()
    if desc["traffic_light"]:
        dms.lane_states.add(lane=10, state=3)
    sc.objects_of_interest.extend(desc["objects_of_interest"])
    for i, d in desc["tracks_to_predict"]:
        sc.tracks_to_predict.add(track_index=i, difficulty=d)
    return sc


def synthetic_scenarios(n: int, seed: int = 0, num_tracks: int = 24,
                        num_lanes: int = 3, points: int = 41, pb2=None):
    """``n`` seeded scenarios: plain objects, or ``pb2.Scenario`` messages
    when a proto module is given."""
    descs = [describe(i, seed, num_tracks, num_lanes, points)
             for i in range(n)]
    if pb2 is None:
        return [as_namespace(d) for d in descs]
    return [as_proto(d, pb2) for d in descs]

"""Scene JSON parsing of the plain reference (host numpy, no torch).

A frozen copy of the port's ``scene/loader.py``: the reference's MapReader
and JSON deserialization (src/MapReader.cpp, src/json_serialization.hpp).
Object ordering (SDC first, then tracks_to_predict, then
objects_of_interest, then the rest), the incremental world mean and the
iterative triangle-area polyline reduction.
"""

from __future__ import annotations

import json

import numpy as np

from . import constants as C

_TYPE_TO_ENTITY = {
    "vehicle": C.ET_VEHICLE,
    "pedestrian": C.ET_PEDESTRIAN,
    "cyclist": C.ET_CYCLIST,
}

_ROAD_TYPE_TO_ENTITY = {
    "road_edge": C.ET_ROAD_EDGE,
    "road_line": C.ET_ROAD_LINE,
    "lane": C.ET_ROAD_LANE,
    "crosswalk": C.ET_CROSSWALK,
    "speed_bump": C.ET_SPEED_BUMP,
    "stop_sign": C.ET_STOP_SIGN,
}


def reduce_polyline(points: np.ndarray, threshold: float) -> np.ndarray:
    """Iterative triangle-area decimation, replicating the reference's
    skip-list loop (src/json_serialization.hpp:144-196) exactly: repeatedly
    drop the middle of any consecutive (kept) triple whose triangle area is
    below ``threshold`` until a fixed point; endpoints always survive."""
    n = len(points)
    skip = np.zeros(n, dtype=bool)
    changed = True
    while changed:
        changed = False
        k = 0
        while k < n - 1:
            k1 = k + 1
            while k1 < n - 1 and skip[k1]:
                k1 += 1
            if k1 >= n - 1:
                break
            k2 = k1 + 1
            while k2 < n and skip[k2]:
                k2 += 1
            if k2 >= n:
                break
            p1, p2, p3 = points[k], points[k1], points[k2]
            area = 0.5 * abs(
                (p1[0] - p3[0]) * (p2[1] - p1[1])
                - (p1[0] - p2[0]) * (p3[1] - p1[1])
            )
            if area < threshold:
                skip[k1] = True
                k = k2
                changed = True
            else:
                k = k1
    skip[0] = False
    skip[n - 1] = False
    return points[~skip]


def _parse_object(obj: dict) -> dict:
    """One MapObject (src/json_serialization.hpp:18-109)."""
    n = min(len(obj["position"]), C.MAX_POSITIONS)
    pos = np.zeros((C.MAX_POSITIONS, 2), np.float32)
    vel = np.zeros((C.MAX_POSITIONS, 2), np.float32)
    heading = np.zeros(C.MAX_POSITIONS, np.float32)
    valid = np.zeros(C.MAX_POSITIONS, np.float32)
    pos[:n] = [(p["x"], p["y"]) for p in obj["position"][:n]]
    vel[:n] = [(v["x"], v["y"]) for v in obj["velocity"][:n]]
    heading[:n] = obj["heading"][:n]
    valid[:n] = [float(v) for v in obj["valid"][:n]]
    return dict(
        num_positions=n,
        pos=pos,
        vel=vel,
        heading=heading,
        valid=valid,
        size=np.array(
            [obj["length"], obj["width"], obj["height"]], np.float32
        ),
        goal=np.array(
            [obj["goalPosition"]["x"], obj["goalPosition"]["y"]], np.float32
        ),
        etype=_TYPE_TO_ENTITY.get(obj["type"], C.ET_NONE),
        oid=int(obj["id"]),
        mark_as_expert=bool(obj.get("mark_as_expert", False)),
        metadata=np.zeros(4, np.int32),  # isSdc, isOOI, isTTP, difficulty
    )


def _parse_road(road: dict, threshold: float) -> dict:
    """One MapRoad with polyline reduction (src/json_serialization.hpp:111-244)."""
    etype = _ROAD_TYPE_TO_ENTITY.get(road["type"], C.ET_NONE)
    geom = np.array(
        [(p["x"], p["y"]) for p in road["geometry"]], np.float32
    ).reshape(-1, 2)
    num_segments = len(geom) - 1
    if num_segments >= 10 and etype in (
        C.ET_ROAD_LANE, C.ET_ROAD_EDGE, C.ET_ROAD_LINE
    ):
        geom = reduce_polyline(geom, threshold)
    geom = geom[: C.MAX_GEOMETRY]

    map_element_id = road.get("map_element_id", C.MAP_TYPE_UNKNOWN)
    if (
        map_element_id == 4
        or map_element_id >= C.MAP_TYPE_NUM_TYPES
        or map_element_id < -1
    ):
        map_element_id = C.MAP_TYPE_UNKNOWN
    return dict(
        etype=etype,
        geometry=geom,
        rid=int(road.get("id", 0)),
        map_type=int(map_element_id),
    )


def _calc_mean(data: dict) -> np.ndarray:
    """World mean over valid object positions and all raw road points
    (src/json_serialization.hpp:246-279)."""
    total = np.zeros(2, np.float64)
    count = 0
    for obj in data["objects"]:
        for i, p in enumerate(obj["position"]):
            if not obj["valid"][i]:
                continue
            total += (p["x"], p["y"])
            count += 1
    for road in data["roads"]:
        for p in road["geometry"]:
            total += (p["x"], p["y"])
            count += 1
    return (total / max(count, 1)).astype(np.float32)


def _str_codes(s: str) -> np.ndarray:
    out = np.zeros(32, np.int32)
    codes = [ord(ch) for ch in s[:32]]
    out[: len(codes)] = codes
    return out


def load_map(path: str, polyline_reduction_threshold: float = 0.0) -> dict:
    """Parse one scenario JSON into the intermediate Map structure
    (the analogue of the reference's ``Map`` singleton, src/init.hpp:53-69)."""
    with open(path) as f:
        data = json.load(f)

    objects = [_parse_object(o) for o in data["objects"][: C.MAX_OBJECTS]]

    metadata = data.get("metadata", {})
    sdc_index = metadata.get("sdc_track_index", -1)
    n_raw = len(data["objects"])
    ttp = {
        t["track_index"]: t.get("difficulty", 0)
        for t in metadata.get("tracks_to_predict", [])
        if 0 <= t["track_index"] < n_raw
    }
    ooi = set(metadata.get("objects_of_interest", []))

    # SDC-first ordering with metadata flags
    # (src/json_serialization.hpp:293-399).
    order: list[int] = []
    used: set[int] = set()
    if 0 <= sdc_index < len(objects):
        o = objects[sdc_index]
        o["metadata"][0] = 1
        if sdc_index in ttp:
            o["metadata"][2] = 1
            o["metadata"][3] = ttp.pop(sdc_index)
        if o["oid"] in ooi:
            o["metadata"][1] = 1
            ooi.discard(o["oid"])
        order.append(sdc_index)
        used.add(sdc_index)
    for i, o in enumerate(objects):
        if i in used or i not in ttp:
            continue
        o["metadata"][2] = 1
        o["metadata"][3] = ttp[i]
        if o["oid"] in ooi:
            o["metadata"][1] = 1
            ooi.discard(o["oid"])
        order.append(i)
        used.add(i)
    for i, o in enumerate(objects):
        if i in used or o["oid"] not in ooi:
            continue
        o["metadata"][1] = 1
        order.append(i)
        used.add(i)
    for i in range(len(objects)):
        if i not in used:
            order.append(i)

    roads = [
        _parse_road(r, polyline_reduction_threshold)
        for r in data["roads"][: C.MAX_ROADS]
    ]

    return dict(
        name=data.get("name", ""),
        scenario_id=data.get("scenario_id", ""),
        map_name_codes=_str_codes(data.get("name", "")),
        scenario_id_codes=_str_codes(data.get("scenario_id", "")),
        mean=_calc_mean(data),
        objects=[objects[i] for i in order],
        roads=roads,
    )

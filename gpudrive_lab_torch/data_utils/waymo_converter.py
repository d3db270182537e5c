"""WOMD scenario -> simulator JSON conversion (port of
``gpudrive_lab_tpu/data_utils/waymo_converter.py``; numpy only).

Proto-agnostic re-implementation of the reference's converter
(reference: data_utils/process_waymo_files.py:113-536): the core
``scenario_to_dict`` consumes any object exposing the Scenario proto
attribute surface (tracks/states, map_features oneofs, dynamic_map_states,
metadata), so the logic is testable without the waymo-open-dataset
dependency; ``process_waymo_files.py`` supplies the TFRecord/proto plumbing
when that package is installed.

Filters reproduced:
  * scenes with any traffic-light state are dropped
    (process_waymo_files.py:334-343)
  * 3-D structures (overpasses) detected by road-edge points that coincide
    in xy (<0.2m) but differ in z (>0.2m) are dropped (:365-396)
  * vehicles/cyclists whose initial box or logged trajectory collides with
    other agents' initial boxes or road edges are marked ``mark_as_expert``
    (:397-507) — collision checks use our oriented-box/segment geometry in
    place of the reference's trimesh meshes (boxes: full 3-D extents with
    height; edge/trajectory segments: 0.2m wide, 2m tall).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

ERR_VAL = -1e4

_WAYMO_OBJECT_STR = {0: "unset", 1: "vehicle", 2: "pedestrian", 3: "cyclist", 4: "other"}

# waymax MapElementIds (datatypes/roadgraph.py)
_LANE_TYPES = {0: 0, 1: 1, 2: 2, 3: 3}
_ROAD_LINE_TYPES = {0: 5, 1: 6, 2: 7, 3: 8, 4: 9, 5: 10, 6: 11, 7: 12, 8: 13}
_ROAD_EDGE_TYPES = {0: 14, 1: 15, 2: 16}


def feature_class_to_map_id(feature: str, sub_type: int) -> int:
    """reference: process_waymo_files.py:87-112."""
    if feature == "lane":
        return _LANE_TYPES.get(sub_type, -1)
    if feature == "road_line":
        return _ROAD_LINE_TYPES.get(sub_type, 5)
    if feature == "road_edge":
        return _ROAD_EDGE_TYPES.get(sub_type, 14)
    return {"stop_sign": 17, "crosswalk": 18, "speed_bump": 19,
            "driveway": 20}.get(feature, -1)


# Columns of the per-step state matrix extracted from a track.
_X, _Y, _Z, _HEADING, _VX, _VY, _VALID = range(7)


def _track_state_matrix(track) -> np.ndarray:
    """All per-step quantities of one track as a [T, 7] float64 matrix
    (columns ``_X.._VALID``); invalid steps carry ERR_VAL everywhere.

    Output schema contract: reference data_utils/process_waymo_files.py
    (ParseObjectState), re-expressed as one array pass so downstream
    consumers (JSON emit, expert marking) slice columns instead of walking
    proto objects repeatedly."""
    m = np.full((len(track.states), 7), ERR_VAL, np.float64)
    for row, s in zip(m, track.states):
        row[_VALID] = 1.0 if s.valid else 0.0
        if s.valid:
            row[_X], row[_Y], row[_Z] = s.center_x, s.center_y, s.center_z
            # wrap heading into (-pi, pi]
            row[_HEADING] = (s.heading + np.pi) % (2 * np.pi) - np.pi
            row[_VX], row[_VY] = s.velocity_x, s.velocity_y
    return m


def _xyz(triple) -> Dict[str, float]:
    x, y, z = triple
    return {"x": x, "y": y, "z": z}


def _init_object(track) -> Optional[Dict[str, Any]]:
    """One track -> simulator object dict.  The goal position and box
    dimensions are anchored at the LAST valid step (or step 0 if none is
    valid — matching the reference's 0-initialised final_valid_index)."""
    m = _track_state_matrix(track)
    valid_steps = np.flatnonzero(m[:, _VALID] > 0)
    anchor = track.states[int(valid_steps[-1]) if len(valid_steps) else 0]
    return {
        "position": [_xyz(t) for t in m[:, [_X, _Y, _Z]].tolist()],
        "width": anchor.width,
        "length": anchor.length,
        "height": anchor.height,
        "heading": m[:, _HEADING].tolist(),
        "velocity": [
            {"x": vx, "y": vy} for vx, vy in m[:, [_VX, _VY]].tolist()
        ],
        "valid": (m[:, _VALID] > 0).tolist(),
        "goalPosition": _xyz(
            (anchor.center_x, anchor.center_y, anchor.center_z)
        ),
        "type": _WAYMO_OBJECT_STR.get(int(track.object_type), "other"),
        "id": track.id,
    }


# Which repeated-point field holds a map feature's geometry.  Features not
# listed use ``polyline`` (lanes, road lines, road edges).
_GEOMETRY_FIELD = {
    "stop_sign": "position",
    "crosswalk": "polygon",
    "speed_bump": "polygon",
    "driveway": "polygon",
}


def _init_road(map_feature) -> Optional[Dict[str, Any]]:
    """One map feature -> simulator road dict (output schema contract:
    reference data_utils/process_waymo_files.py, init_road).  ``map_feature``
    must expose WhichOneof('feature_data') and the oneof fields."""
    kind = map_feature.WhichOneof("feature_data")
    if kind is None:
        return None
    data = getattr(map_feature, kind)
    pts = getattr(data, _GEOMETRY_FIELD.get(kind, "polyline"))
    if kind == "stop_sign":
        pts = [pts]  # a single Point, not a repeated field
    return {
        "geometry": [_xyz((p.x, p.y, p.z)) for p in pts],
        "type": kind,
        "map_element_id": feature_class_to_map_id(
            kind, int(getattr(data, "type", -1))
        ),
        "id": map_feature.id,
    }


def _has_3d_structure(edge_points: np.ndarray, tolerance: float = 0.2) -> bool:
    """Overpass detection (reference: process_waymo_files.py:365-396)."""
    if len(edge_points) == 0:
        return False
    xy = edge_points[:, :2]
    z = edge_points[:, 2]
    chunk = 1000
    for i in range(0, len(xy), chunk):
        d = np.linalg.norm(xy[i : i + chunk, None] - xy[None], axis=2)
        p1, p2 = np.where((d < tolerance) & (d > 0))
        if np.any(np.abs(z[i + p1] - z[p2]) > tolerance):
            return True
    return False


def _filter_small_segments(segs: np.ndarray, min_length=1e-6) -> np.ndarray:
    if len(segs) == 0:
        return segs.reshape(0, 2, 3)
    lengths = np.linalg.norm(segs[:, 1] - segs[:, 0], axis=-1)
    return segs[lengths >= min_length]


def _segment_boxes(segs: np.ndarray, width=0.2, height=2.0):
    """Segments -> (center xy, yaw, half extents xy, z interval), matching
    the reference's segment meshes (box from start to end, 0.2 wide, 2
    tall, z anchored at the START point — _generate_mesh applies the base
    box's z extent around the start's z)."""
    starts, ends = segs[:, 0], segs[:, 1]
    d = ends - starts
    center = (starts[:, :2] + ends[:, :2]) / 2
    yaw = np.arctan2(d[:, 1], d[:, 0])
    half = np.stack(
        [np.linalg.norm(d[:, :2], axis=-1) / 2, np.full(len(segs), width / 2)],
        axis=-1,
    )
    z_lo = starts[:, 2] - height / 2
    z_hi = starts[:, 2] + height / 2
    return center, yaw, half, z_lo, z_hi


def _obb_overlap_np(c1, y1, h1, c2, y2, h2):
    """Vectorized 2-D SAT (same math as core/obb.py obb_overlap_sat)."""
    d = c2 - c1
    rel = y2 - y1
    ac, asn = np.abs(np.cos(rel)), np.abs(np.sin(rel))
    ca, sa = np.cos(y1), np.sin(y1)
    dx = ca * d[..., 0] + sa * d[..., 1]
    dy = -sa * d[..., 0] + ca * d[..., 1]
    cb, sb = np.cos(y2), np.sin(y2)
    ex = cb * d[..., 0] + sb * d[..., 1]
    ey = -sb * d[..., 0] + cb * d[..., 1]
    a0, a1 = h1[..., 0], h1[..., 1]
    b0, b1 = h2[..., 0], h2[..., 1]
    sep = (
        (np.abs(dx) > a0 + b0 * ac + b1 * asn)
        | (np.abs(dy) > a1 + b0 * asn + b1 * ac)
        | (np.abs(ex) > b0 + a0 * ac + a1 * asn)
        | (np.abs(ey) > b1 + a0 * asn + a1 * ac)
    )
    return ~sep


def _mark_experts(objects: List[dict], edge_segments: np.ndarray):
    """Flag vehicles/cyclists with colliding spawns or trajectories
    (reference: process_waymo_files.py:397-507)."""
    ec, ey, eh, ez_lo, ez_hi = (
        _segment_boxes(edge_segments)
        if len(edge_segments)
        else (np.zeros((0, 2)), np.zeros(0), np.zeros((0, 2)), np.zeros(0), np.zeros(0))
    )

    boxes = []  # (idx, center, yaw, half, z_lo, z_hi)
    traj_boxes = []  # (idx, seg boxes...)
    for i, obj in enumerate(objects):
        if obj["type"] not in ("vehicle", "cyclist"):
            obj["mark_as_expert"] = False
            continue
        obj["mark_as_expert"] = False
        first = next((k for k, v in enumerate(obj["valid"]) if v), None)
        if first is None:
            continue
        p = obj["position"][first]
        boxes.append(
            (
                i,
                np.array([p["x"], p["y"]]),
                obj["heading"][first],
                np.array([obj["length"] / 2, obj["width"] / 2]),
                p["z"] - obj["height"] / 2,
                p["z"] + obj["height"] / 2,
            )
        )
        pts = np.array(
            [
                [q["x"], q["y"], q["z"]]
                for k, q in enumerate(obj["position"])
            ]
        )
        valid = np.array(obj["valid"], bool)
        pair_ok = valid[:-1] & valid[1:]
        segs = np.stack([pts[:-1], pts[1:]], axis=1)[pair_ok]
        segs = _filter_small_segments(segs)
        if len(segs):
            traj_boxes.append((i, *_segment_boxes(segs)))

    colliding = set()
    # agent-agent initial boxes
    for a in range(len(boxes)):
        ia, ca_, ya, ha, zla, zha = boxes[a]
        for b in range(a + 1, len(boxes)):
            ib, cb_, yb, hb, zlb, zhb = boxes[b]
            if zla > zhb or zlb > zha:
                continue
            if _obb_overlap_np(ca_, ya, ha, cb_, yb, hb):
                colliding.add(ia)
                colliding.add(ib)
    # agent initial box vs road edges
    for i, c, y, h, zl, zh in boxes:
        if len(ec) == 0:
            break
        z_ok = ~((zl > ez_hi) | (ez_lo > zh))
        hit = _obb_overlap_np(
            c[None], np.full(len(ec), y), np.broadcast_to(h, (len(ec), 2)),
            ec, ey, eh,
        )
        if np.any(hit & z_ok):
            colliding.add(i)
    # trajectory segments vs road edges
    for entry in traj_boxes:
        i, tc, ty, th, tz_lo, tz_hi = entry
        if i in colliding or len(ec) == 0:
            continue
        z_ok = ~(
            (tz_lo[:, None] > ez_hi[None]) | (ez_lo[None] > tz_hi[:, None])
        )
        hit = _obb_overlap_np(
            tc[:, None], ty[:, None], th[:, None], ec[None], ey[None], eh[None]
        )
        if np.any(hit & z_ok):
            colliding.add(i)

    for i in colliding:
        objects[i]["mark_as_expert"] = True


def scenario_to_dict(scenario, name: str) -> Optional[Dict[str, Any]]:
    """Scenario proto (or stub) -> simulator JSON dict, or None when the
    scene is filtered out (reference: waymo_to_scenario,
    process_waymo_files.py:308-536)."""
    for dms in scenario.dynamic_map_states:
        if len(dms.lane_states) > 0:
            return None  # traffic-light scene

    roads = []
    edge_points = []
    edge_segments = []
    for mf in scenario.map_features:
        road = _init_road(mf)
        if road is None:
            continue
        roads.append(road)
        if road["type"] == "road_edge":
            verts = [[p["x"], p["y"], p["z"]] for p in road["geometry"]]
            edge_points.extend(verts)
            edge_segments.extend(
                [verts[i], verts[i + 1]] for i in range(len(verts) - 1)
            )

    if _has_3d_structure(np.array(edge_points).reshape(-1, 3)):
        return None

    edge_segments = _filter_small_segments(
        np.array(edge_segments, np.float64).reshape(-1, 2, 3)
    )

    objects = []
    for track in scenario.tracks:
        obj = _init_object(track)
        if obj is not None:
            objects.append(obj)
    _mark_experts(objects, edge_segments)

    metadata = {
        "sdc_track_index": int(scenario.sdc_track_index),
        "objects_of_interest": list(scenario.objects_of_interest),
        "tracks_to_predict": [
            {"track_index": t.track_index, "difficulty": t.difficulty}
            for t in scenario.tracks_to_predict
        ],
    }
    return {
        "name": name,
        "scenario_id": scenario.scenario_id,
        "objects": objects,
        "roads": roads,
        "tl_states": {},
        "metadata": metadata,
    }

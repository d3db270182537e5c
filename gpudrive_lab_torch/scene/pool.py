"""Generate a randomized synthetic scene pool (JSON files in the simulator
schema, SURVEY.md Appendix A) for resampling campaigns and IL scaling runs.

Port of ``scripts/make_scene_pool.py``: the numpy generator is copied as
it is, draws and dict key order included, so that a seed gives the same
scene, JSON byte for byte; ``validate_pool`` replays the scenes on the
port's simulator.

v2 scenes are rotated/translated multi-lane roads with randomized lane
count, spacing, speeds, curvature, agent counts and start offsets; expert
trajectories are exact constant-speed lane-following (collision-free by
construction) with goals placed reachable at the 91-step horizon, so
all-expert replay reaches every goal and RL/IL targets are well-posed.

v3 (default) adds INTERACTION PRESSURE — the behaviors real WOMD scenes
contain (reference: data_utils/detect_behavior.py) that the v1/v2
single-road pools lacked:

  * intersections: two corridors crossing, experts time-multiplexed
    through the conflict zone (a policy-controlled agent must yield to
    crossing log traffic);
  * merges: a ramp joining the outer main lane through a gap in the road
    edge, the merger slotting into a hole in main-lane traffic;
  * crosswalks: pedestrians (and sometimes cyclists) crossing the road
    between scheduled vehicle passes, with the reference's collision-pair
    semantics (agent-agent pairs ALWAYS collide; non-vehicles ignore road
    edges, reference src/sim.hpp:88-102) — peds/cyclists are
    mark_as_expert so they are never policy-controlled;
  * lead-vehicle pressure: followers whose tracks cut off before reaching
    the conflict they are driving toward (near goals = curriculum, the v2
    lesson).

Every generated scene passes an EXACT numpy SAT verification sweep
(agent-agent OBBs at all mutually-live steps + vehicle-vs-road-edge thin
OBBs, with an inflation margin) that drops violating agents, plus a
goal-entry-timing check (first entry into the 2.0 goal radius exactly at
the track cutoff — an early goal would teleport the expert to the shared
padding position while its log is still valid and phantom-collide there,
see the v2 notes below).  Scene sizes stay inside one compile bucket
(<= 250 road segments, <= 32 agents) so swap_data_batch never recompiles.

Usage: python -m gpudrive_lab_torch.scene.pool --out data/pool_v3 --num 512
       python -m gpudrive_lab_torch.scene.pool --out runs/p --num 8 \\
           --validate 8

Writing scenes needs no device; the entry point still asks for the card
unless ``--device cpu`` is given, as every entry point of the port does.
"""

import argparse
import json
import math
import os

import numpy as np

T = 91
DT = 0.1


def curved_polyline(rng, x0, y0, heading, length, n_pts, curvature):
    """Points along a constant-curvature arc starting at (x0, y0)."""
    s = np.linspace(0.0, length, n_pts)
    if abs(curvature) < 1e-6:
        xs = x0 + s * math.cos(heading)
        ys = y0 + s * math.sin(heading)
    else:
        r = 1.0 / curvature
        ang = heading + s * curvature
        xs = x0 + r * (np.sin(ang) - math.sin(heading))
        ys = y0 - r * (np.cos(ang) - math.cos(heading))
    return xs, ys, heading + s * curvature


def make_scene(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    heading = rng.uniform(-math.pi, math.pi)
    cx, cy = rng.uniform(-2000, 2000, 2)
    n_lanes = int(rng.integers(2, 7))
    lane_w = rng.uniform(3.5, 4.5)
    curvature = rng.uniform(-1, 1) * 0.004
    length = rng.uniform(120, 240)
    speed_base = rng.uniform(3.0, 10.0)

    objects = []
    oid = 100
    total_agents = 0
    max_agents = int(rng.integers(4, 33))
    for lane_i in range(n_lanes):
        # lane center offset (perpendicular to heading)
        off = (lane_i - (n_lanes - 1) / 2.0) * lane_w
        n_cars = int(rng.integers(1, 7))
        dirsign = 1 if lane_i % 2 == 0 or rng.random() < 0.3 else 1
        speed = speed_base * rng.uniform(0.7, 1.3)
        # same-lane cars share the speed, so enforcing a >= 12 m start gap
        # keeps the whole lane collision-free for the full horizon
        gaps = rng.uniform(12.0, 28.0, n_cars)
        starts = 0.05 * length + np.cumsum(gaps) - gaps[0]
        starts = starts[starts < 0.5 * length]
        # Goal offset calibrated to the trainer's dist_to_goal_threshold
        # (2.0, EnvConfig default): distance at the cutoff step is
        # goal_off <= 2.0 (reached) and one step earlier goal_off +
        # speed*dt > 2.0 (not yet) — the expert goes done EXACTLY at its
        # cutoff, and the padding teleport happens on the first INVALID
        # log step, which collision detection ignores for uncontrolled
        # agents (src/sim.cpp:632-646).  An early-reaching expert would
        # spend valid steps at the shared padding position and
        # phantom-collide there (parity behavior, measured).
        # 0.3 margin over the threshold: the one-step-early distance is
        # goal_off + speed*dt minus small chord/heading/f32 effects
        # (measured up to ~0.03) — a 0.02 margin produced done one step
        # before the cutoff and phantom padding collisions
        goal_off = float(np.clip(2.3 - speed * DT, 0.3, 1.9))
        # Per-agent track cutoffs (the log ends partway through the episode,
        # like real WOMD tracks that leave the scene or stop being observed):
        # goal distances then span ~5-130 m instead of always a full
        # constant-speed episode away — without nearby goals the sparse
        # goal reward gives a fresh policy no gradient and training
        # collapses to "drive safe, reach nothing" (measured round 4:
        # 38M steps on the all-far-goal pool v1 peaked at 0.8% goal).
        # Invalid log steps after the cutoff keep expert replay collision-
        # free BY PARITY: the reference ignores uncontrolled agents at
        # invalid steps in collision detection (src/sim.cpp:632-646), so a
        # goal-done expert teleported to the shared padding position stops
        # colliding there (validated: goal-done VALID experts at padding DO
        # phantom-collide, in our sim and the reference alike).  Cutoffs
        # sort ASCENDING rear-to-front within a lane so in-lane gaps never
        # shrink below the initial >= 12 m while tracks are live; ~30% of
        # agents keep the full horizon.
        # cap at T-2: an agent done at its cutoff is teleported to padding
        # on the NEXT step, which must be an invalid log step even for the
        # "full-horizon" group (done at T-1 would teleport on the final
        # step with a still-valid log and phantom-collide — measured: 6/64
        # scenes with ts=T-1)
        ts_all = np.where(
            rng.random(len(starts)) < 0.3,
            T - 2,
            rng.integers(20, 86, len(starts)),
        )
        ts_all = np.sort(ts_all)  # rear (small s0) ends first
        for j in range(len(starts)):
            if total_agents >= max_agents:
                break
            s0 = starts[j]
            t_stop = int(ts_all[j])
            steps = np.minimum(np.arange(T), t_stop)
            s = s0 + dirsign * speed * DT * steps
            xs, ys, hs = arc_at(cx, cy, heading, curvature, s, off)
            live = np.arange(T) <= t_stop
            # WOMD convention: ERR_VAL positions where the track is invalid
            # (SURVEY.md Appendix A; process_waymo_files.py:39)
            xs = np.where(live, xs, -1e4)
            ys = np.where(live, ys, -1e4)
            moving = np.arange(T) < t_stop
            vxs = np.where(moving, speed * np.cos(hs), 0.0)
            vys = np.where(moving, speed * np.sin(hs), 0.0)
            objects.append(
                {
                    "position": [
                        {"x": float(x), "y": float(y), "z": 0.0}
                        for x, y in zip(xs, ys)
                    ],
                    "width": float(rng.uniform(1.8, 2.3)),
                    "length": float(rng.uniform(4.0, 5.2)),
                    "height": 1.5,
                    "heading": [float(h) for h in hs],
                    "velocity": [
                        {"x": float(vx), "y": float(vy)}
                        for vx, vy in zip(vxs, vys)
                    ],
                    "valid": [bool(v) for v in live],
                    # goal just beyond the final logged position, offset
                    # tuned per speed so the 1 m goal radius is FIRST
                    # entered at the final step (offset + speed*dt > 1 and
                    # offset < 1): an early goal would mark the expert done
                    # and teleport it to the shared padding position, where
                    # simultaneous finishers phantom-collide (parity
                    # behavior, src/sim.cpp:333-343 + 631-666)
                    "goalPosition": {
                        "x": float(xs[t_stop] + goal_off * math.cos(hs[t_stop])),
                        "y": float(ys[t_stop] + goal_off * math.sin(hs[t_stop])),
                        "z": 0.0,
                    },
                    "type": "vehicle",
                    "id": oid,
                    "mark_as_expert": False,
                }
            )
            oid += 1
            total_agents += 1

    roads = []
    rid = 1
    half = (n_lanes / 2.0) * lane_w + rng.uniform(1.0, 2.0)
    n_pts = int(rng.integers(12, 40))
    for off, rtype, meid in [
        (half, "road_edge", 15),
        (-half, "road_edge", 15),
    ]:
        s = np.linspace(-0.1 * length, 1.1 * length, n_pts)
        xs, ys, _ = arc_at(cx, cy, heading, curvature, s, off)
        roads.append(
            {
                "geometry": [
                    {"x": float(x), "y": float(y), "z": 0.0}
                    for x, y in zip(xs, ys)
                ],
                "type": rtype,
                "map_element_id": meid,
                "id": rid,
            }
        )
        rid += 1
    for lane_i in range(n_lanes):
        off = (lane_i - (n_lanes - 1) / 2.0) * lane_w
        s = np.linspace(0, length, max(8, n_pts // 2))
        xs, ys, _ = arc_at(cx, cy, heading, curvature, s, off)
        roads.append(
            {
                "geometry": [
                    {"x": float(x), "y": float(y), "z": 0.0}
                    for x, y in zip(xs, ys)
                ],
                "type": "lane",
                "map_element_id": 2,
                "id": rid,
            }
        )
        rid += 1
    if rng.random() < 0.5:
        xs, ys, _ = arc_at(cx, cy, heading, curvature,
                           np.array([length * 1.05]), half + 2.0)
        roads.append(
            {
                "geometry": [{"x": float(xs[0]), "y": float(ys[0]), "z": 0.0}],
                "type": "stop_sign",
                "map_element_id": 17,
                "id": rid,
            }
        )

    return {
        # SceneDataLoader discovers scenes by the reference's "tfrecord"
        # filename prefix (reference: gpudrive/env/dataset.py:13) — the
        # pool must follow the same convention to be loadable.
        "name": f"tfrecord-synth_{seed}.json",
        "scenario_id": f"synthpool{seed:05d}",
        "objects": objects,
        "roads": roads,
        "tl_states": {},
        "metadata": {
            "sdc_track_index": 0,
            "objects_of_interest": [],
            "tracks_to_predict": [
                {"track_index": 0, "difficulty": 1}
            ],
        },
    }


def arc_at(cx, cy, heading, curvature, s, off):
    """Point at arc-length s with lateral offset off from the center arc."""
    s = np.asarray(s, np.float64)
    if abs(curvature) < 1e-6:
        hs = np.full(s.shape, heading)
        xs = cx + s * math.cos(heading) - off * np.sin(hs)
        ys = cy + s * math.sin(heading) + off * np.cos(hs)
    else:
        r = 1.0 / curvature
        hs = heading + s * curvature
        xs = cx + r * (np.sin(hs) - math.sin(heading)) - off * np.sin(hs)
        ys = cy - r * (np.cos(hs) - math.cos(heading)) + off * np.cos(hs)
    return xs, ys, hs


# ---------------------------------------------------------------------------
# v3: interaction-pressure archetypes + exact verification
# ---------------------------------------------------------------------------

THRESH = 2.0  # trainer dist_to_goal_threshold (EnvConfig default)


def lane_offsets(n, lane_w):
    return [(i - (n - 1) / 2.0) * lane_w for i in range(n)]


def straight_path(cx, cy, h, off, s0, v):
    """[T] samples along a straight corridor at constant speed."""
    s = s0 + v * DT * np.arange(T)
    xs = cx + s * math.cos(h) - off * math.sin(h)
    ys = cy + s * math.sin(h) + off * math.cos(h)
    return xs, ys, np.full(T, h)


def emit_object(rng, xs, ys, hs, cutoff, oid, otype="vehicle",
                mark_expert=False, width=None, length=None):
    """Object dict from a full-horizon path + track cutoff.

    Goal placement and padding rules follow the v2 construction (see the
    long comments in make_scene): goal first entered at exactly the cutoff
    step, positions ERR_VAL after the cutoff so the goal-done teleport
    lands on an invalid log step."""
    cutoff = int(min(max(cutoff, 1), T - 2))
    if width is None:
        width = {"vehicle": rng.uniform(1.8, 2.3),
                 "pedestrian": rng.uniform(0.7, 0.9),
                 "cyclist": rng.uniform(0.5, 0.7)}[otype]
    if length is None:
        length = {"vehicle": rng.uniform(4.0, 5.2),
                  "pedestrian": rng.uniform(0.7, 0.9),
                  "cyclist": rng.uniform(1.6, 2.0)}[otype]
    live = np.arange(T) <= cutoff
    moving = np.arange(T) < cutoff
    vxs = np.zeros(T)
    vys = np.zeros(T)
    vxs[:-1] = (xs[1:] - xs[:-1]) / DT
    vys[:-1] = (ys[1:] - ys[:-1]) / DT
    vxs = np.where(moving, vxs, 0.0)
    vys = np.where(moving, vys, 0.0)
    speed_end = math.hypot(xs[cutoff] - xs[cutoff - 1],
                           ys[cutoff] - ys[cutoff - 1]) / DT
    goal_off = float(np.clip(2.3 - speed_end * DT, 0.3, 1.9))
    gx = xs[cutoff] + goal_off * math.cos(hs[cutoff])
    gy = ys[cutoff] + goal_off * math.sin(hs[cutoff])
    pxs = np.where(live, xs, -1e4)
    pys = np.where(live, ys, -1e4)
    return {
        "position": [{"x": float(x), "y": float(y), "z": 0.0}
                     for x, y in zip(pxs, pys)],
        "width": float(width), "length": float(length),
        "height": 1.8 if otype == "pedestrian" else 1.5,
        "heading": [float(h) for h in hs],
        "velocity": [{"x": float(vx), "y": float(vy)}
                     for vx, vy in zip(vxs, vys)],
        "valid": [bool(v) for v in live],
        "goalPosition": {"x": float(gx), "y": float(gy), "z": 0.0},
        "type": otype,
        "id": int(oid),
        "mark_as_expert": bool(mark_expert),
    }


def _obj_arrays(o):
    xs = np.array([p["x"] for p in o["position"]])
    ys = np.array([p["y"] for p in o["position"]])
    hs = np.array(o["heading"])
    live = np.array(o["valid"], bool)
    return xs, ys, hs, live


def _sat_overlap(cxy1, h1, he1, cxy2, h2, he2):
    """Vectorized 2D OBB overlap over leading batch dims.

    cxy: [..., 2] centers; h: [...] headings; he: [..., 2] half-extents
    (along heading, across).  Separating-axis test over the 4 box axes —
    exact for rectangles (reference narrow phase: src/obb.hpp:34-82)."""
    d = cxy2 - cxy1
    out = np.ones(np.broadcast_shapes(h1.shape, h2.shape), bool)
    for h, other_h, he_a, he_b in ((h1, h2, he1, he2), (h2, h1, he2, he1)):
        for axis_i in range(2):
            ang = h + (0.0 if axis_i == 0 else math.pi / 2)
            ax = np.stack([np.cos(ang), np.sin(ang)], -1)
            dist = np.abs((d * ax).sum(-1))
            ra = he_a[..., axis_i]
            rel = other_h - h
            rb = (np.abs(np.cos(rel)) * he_b[..., 0]
                  + np.abs(np.sin(rel)) * he_b[..., 1])
            if axis_i == 1:
                rb = (np.abs(np.sin(rel)) * he_b[..., 0]
                      + np.abs(np.cos(rel)) * he_b[..., 1])
            out &= dist <= ra + rb
    return out


def _edge_segments(roads):
    """[(x0,y0,x1,y1)] for every road_edge polyline segment."""
    segs = []
    for r in roads:
        if r["type"] != "road_edge":
            continue
        g = r["geometry"]
        for a, b in zip(g[:-1], g[1:]):
            segs.append((a["x"], a["y"], b["x"], b["y"]))
    return np.array(segs) if segs else np.zeros((0, 4))


def verify_objects(objects, roads, inflate=0.25):
    """Exact SAT sweep; returns indices of objects that must be dropped.

    Agent-agent: every pair at every mutually-live step (agent-agent pairs
    always collide in the reference whitelist).  Vehicle-road: vehicles vs
    road_edge thin OBBs (non-vehicles ignore edges, src/sim.hpp:88-102).
    Later-added objects are dropped first (archetype priority order)."""
    objs = list(objects)
    drop = set()
    segs = _edge_segments(roads)
    if len(segs):
        seg_c = np.stack([(segs[:, 0] + segs[:, 2]) / 2,
                          (segs[:, 1] + segs[:, 3]) / 2], -1)
        seg_h = np.arctan2(segs[:, 3] - segs[:, 1], segs[:, 2] - segs[:, 0])
        seg_len = np.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1])
        seg_he = np.stack([seg_len / 2, np.full(len(segs), 0.1)], -1)

    while True:
        alive = [i for i in range(len(objs)) if i not in drop]
        if not alive:
            break
        xs = np.stack([_obj_arrays(objs[i])[0] for i in alive])  # [N, T]
        ys = np.stack([_obj_arrays(objs[i])[1] for i in alive])
        hs = np.stack([_obj_arrays(objs[i])[2] for i in alive])
        lv = np.stack([_obj_arrays(objs[i])[3] for i in alive])
        he = np.stack([
            [objs[i]["length"] / 2 + inflate, objs[i]["width"] / 2 + inflate]
            for i in alive
        ])
        cxy = np.stack([xs, ys], -1)  # [N, T, 2]
        N = len(alive)
        hit = _sat_overlap(
            cxy[:, None], hs[:, None], he[:, None, None],
            cxy[None, :], hs[None, :], he[None, :, None],
        )  # [N, N, T]
        both_live = lv[:, None] & lv[None, :]
        hit &= both_live
        hit &= ~np.eye(N, dtype=bool)[:, :, None]
        worst = None
        if hit.any():
            i, j, _ = np.unravel_index(np.argmax(hit), hit.shape)
            worst = alive[max(i, j)]
        elif len(segs):
            veh = np.array([objs[i]["type"] == "vehicle" for i in alive])
            rh = _sat_overlap(
                cxy[:, :, None], hs[:, :, None], he[:, None, None],
                seg_c[None, None], seg_h[None, None], seg_he[None, None],
            )  # [N, T, S]
            rh &= lv[:, :, None] & veh[:, None, None]
            if rh.any():
                i = int(np.unravel_index(np.argmax(rh), rh.shape)[0])
                worst = alive[i]
        if worst is None:
            break
        drop.add(worst)
    return sorted(drop)


def goal_entry_ok(o):
    """First entry into the goal radius must be exactly the cutoff step."""
    xs, ys, _, live = _obj_arrays(o)
    cutoff = int(np.nonzero(live)[0][-1])
    g = o["goalPosition"]
    d = np.hypot(xs - g["x"], ys - g["y"])
    return bool((d[:cutoff] > THRESH).all() and d[cutoff] <= THRESH)


def _v2_cutoffs(rng, n):
    """Per-agent track cutoffs, ascending rear-to-front (the v2 rule)."""
    ts = np.where(rng.random(n) < 0.3, T - 2, rng.integers(20, 86, n))
    return np.sort(ts)


def scene_intersection(rng):
    """Two corridors crossing; experts time-multiplexed through the
    conflict zone, followers cutting off before they reach it."""
    h_a = rng.uniform(-math.pi, math.pi)
    theta = float(rng.choice([-1, 1])) * rng.uniform(
        math.radians(55), math.radians(125)
    )
    h_b = h_a + theta
    cx, cy = rng.uniform(-2000, 2000, 2)
    lane_w = rng.uniform(3.6, 4.4)
    n_a, n_b = int(rng.integers(1, 3)), int(rng.integers(1, 3))
    v_a, v_b = rng.uniform(5.5, 10.0, 2)
    sin_t = abs(math.sin(theta))
    halfw_a = n_a * lane_w / 2 + 1.5
    halfw_b = n_b * lane_w / 2 + 1.5
    w_a = (halfw_b + 3.0) / sin_t + 3.0  # conflict half-length along A
    w_b = (halfw_a + 3.0) / sin_t + 3.0
    L = 280.0

    # per-(corridor, lane) speeds: same-lane cars share a speed, so in-lane
    # gaps are constant for the whole horizon (the v2 invariant)
    lane_speed = {}
    for cid, (base_v, n_l) in (("a", (v_a, n_a)), ("b", (v_b, n_b))):
        for li in range(n_l):
            lane_speed[(cid, li)] = base_v * rng.uniform(0.85, 1.15)
    lane_s0s = {}  # start positions used per lane (>= 13.5 m gaps)

    objects = []
    oid = 100

    def add_car(cid, li, s0, cutoff, front=False):
        nonlocal oid
        h, n_l = (h_a, n_a) if cid == "a" else (h_b, n_b)
        off = lane_offsets(n_l, lane_w)[li]
        v = lane_speed[(cid, li)]
        s0s = lane_s0s.setdefault((cid, li), [])
        if s0s:
            if front:  # place ahead of every same-lane car
                s0 = max(s0, max(s0s) + rng.uniform(13.5, 24.0))
            else:  # place behind
                s0 = min(s0, min(s0s) - rng.uniform(13.5, 24.0))
        s0s.append(s0)
        xs, ys, hs = straight_path(cx, cy, h, off, s0, v)
        objects.append(emit_object(rng, xs, ys, hs, cutoff, oid))
        oid += 1
        return s0, v

    t_free = rng.uniform(0.5, 1.5)
    k = 0
    while len(objects) < 24:
        cid = "a" if k % 2 == 0 else "b"
        w, n_l = (w_a, n_a) if cid == "a" else (w_b, n_b)
        lanes = [li for li in range(n_l) if rng.random() < 0.8] or [0]
        occ_max = max(w / lane_speed[(cid, li)] for li in lanes)
        t_cross = t_free + occ_max + rng.uniform(0.1, 0.5)
        if t_cross + occ_max > 8.4:
            break
        for li in lanes:  # parallel lanes cross together
            v = lane_speed[(cid, li)]
            exit_step = int(math.ceil((t_cross + w / v) / DT)) + 2
            if rng.random() < 0.5:
                cutoff = T - 2
            else:
                cutoff = int(rng.integers(min(exit_step, T - 2), T - 1))
            cutoff = min(max(cutoff, exit_step), T - 2)
            s0, v = add_car(cid, li, -v * t_cross, cutoff)
            # follower chain that never reaches the zone (near goals)
            sf = s0
            for _ in range(int(rng.integers(0, 3))):
                sf = sf - rng.uniform(14, 26)
                t_entry = (-w - 4.0 - sf) / v
                cut_max = int(t_entry / DT) - 1
                if cut_max < 12:
                    break
                add_car(cid, li, sf,
                        int(rng.integers(10, min(cut_max, T - 2) + 1)))
        t_free = t_cross + occ_max
        k += 1
    # tail cars already past the junction, driving away (goal diversity)
    for cid, n_l in (("a", n_a), ("b", n_b)):
        w = w_a if cid == "a" else w_b
        for li in range(n_l):
            if rng.random() < 0.5 and len(objects) < 30:
                add_car(cid, li, w + rng.uniform(6.0, 40.0),
                        int(rng.integers(20, T - 1)), front=True)

    roads = []
    rid = 1
    for h, halfw, w_gap, n_l in (
        (h_a, halfw_a, w_a + 2.0, n_a), (h_b, halfw_b, w_b + 2.0, n_b)
    ):
        for off in (halfw, -halfw):  # edges with a junction gap
            for s_lo, s_hi in ((-0.55 * L, -w_gap), (w_gap, 0.55 * L)):
                s = np.linspace(s_lo, s_hi, 8)
                xs = cx + s * math.cos(h) - off * math.sin(h)
                ys = cy + s * math.sin(h) + off * math.cos(h)
                roads.append({
                    "geometry": [{"x": float(x), "y": float(y), "z": 0.0}
                                 for x, y in zip(xs, ys)],
                    "type": "road_edge", "map_element_id": 15, "id": rid,
                })
                rid += 1
        for off in lane_offsets(n_l, lane_w):  # lane centerlines, full
            s = np.linspace(-0.55 * L, 0.55 * L, 12)
            xs = cx + s * math.cos(h) - off * math.sin(h)
            ys = cy + s * math.sin(h) + off * math.cos(h)
            roads.append({
                "geometry": [{"x": float(x), "y": float(y), "z": 0.0}
                             for x, y in zip(xs, ys)],
                "type": "lane", "map_element_id": 2, "id": rid,
            })
            rid += 1
    if rng.random() < 0.6:  # stop sign at the zone corner
        off = halfw_a + 1.5
        s = -(w_a + 3.0)
        roads.append({
            "geometry": [{
                "x": float(cx + s * math.cos(h_a) - off * math.sin(h_a)),
                "y": float(cy + s * math.sin(h_a) + off * math.cos(h_a)),
                "z": 0.0}],
            "type": "stop_sign", "map_element_id": 17, "id": rid,
        })
    return objects, roads


def scene_merge(rng):
    """A ramp joins the outer main lane through a gap in the road edge; the
    merger slots into a scheduled hole in same-speed main-lane traffic."""
    h = rng.uniform(-math.pi, math.pi)
    cx, cy = rng.uniform(-2000, 2000, 2)
    lane_w = rng.uniform(3.6, 4.4)
    n_l = int(rng.integers(1, 4))
    v = rng.uniform(5.0, 9.0)
    L = 240.0
    offs = lane_offsets(n_l, lane_w)
    off_t = offs[-1]  # merge target: outermost (+) lane
    half = n_l * lane_w / 2 + 1.5
    ramp_off = rng.uniform(lane_w / 2 + 1.5 + 2.7, 10.0)
    s_r0 = rng.uniform(-40.0, -10.0)
    s_r1 = s_r0 + rng.uniform(45.0, 70.0)

    # lateral offset decays from off_t + ramp_off (u=0) to off_t (u=1)
    def ramp_lat(s):
        u = np.clip((s - s_r0) / (s_r1 - s_r0), 0.0, 1.0)
        return off_t + ramp_off * 0.5 * (1 + np.cos(np.pi * u))

    objects = []
    oid = 100
    # the merger
    s0_m = rng.uniform(-65.0, -45.0)
    s = s0_m + v * DT * np.arange(T)
    lat = ramp_lat(s)
    xs = cx + s * math.cos(h) - lat * math.sin(h)
    ys = cy + s * math.sin(h) + lat * math.cos(h)
    hs = np.full(T, h)
    hs[:-1] = np.arctan2(ys[1:] - ys[:-1], xs[1:] - xs[:-1])
    hs[-1] = hs[-2]
    cut_lo = int(math.ceil((s_r1 + 8.0 - s0_m) / v / DT))
    cutoff = int(rng.integers(min(cut_lo, T - 2), T - 1))
    objects.append(emit_object(rng, xs, ys, hs, cutoff, oid))
    oid += 1
    # main target-lane traffic: same speed, a hole where the merger lands;
    # cars ahead of the hole and a follower train behind it
    hole = rng.uniform(30.0, 42.0)
    ahead = [s0_m + hole]
    while rng.random() < 0.6 and len(ahead) < 3:
        ahead.append(ahead[-1] + rng.uniform(14.0, 28.0))
    behind = []
    sb = s0_m - hole
    while (not behind or rng.random() < 0.6) and len(behind) < 3:
        behind.append(sb)
        sb -= rng.uniform(14.0, 28.0)
    train = sorted(ahead + behind)  # rear -> front
    cuts = _v2_cutoffs(rng, len(train))
    for s0, cut in zip(train, cuts):
        xs, ys, hs = straight_path(cx, cy, h, off_t, s0, v)
        objects.append(emit_object(rng, xs, ys, hs, int(cut), oid))
        oid += 1
    # independent trains on the other lanes (v2 rules)
    for off in offs[:-1]:
        v_l = rng.uniform(4.0, 9.5)
        n_cars = int(rng.integers(2, 6))
        gaps = rng.uniform(13.0, 28.0, n_cars)
        starts = -60.0 + np.cumsum(gaps) - gaps[0]
        cuts = _v2_cutoffs(rng, len(starts))
        for j, s0 in enumerate(starts):
            xs, ys, hs = straight_path(cx, cy, h, off, s0, v_l)
            objects.append(emit_object(rng, xs, ys, hs, int(cuts[j]), oid))
            oid += 1

    roads = []
    rid = 1
    # -edge full length; +edge with the merge gap
    for seg in ([(-0.55 * L, 0.55 * L, -half)]
                + [(-0.55 * L, s_r0 - 5.0, half), (s_r1 + 5.0, 0.55 * L, half)]):
        s_lo, s_hi, off = seg
        s = np.linspace(s_lo, s_hi, 10)
        xs = cx + s * math.cos(h) - off * math.sin(h)
        ys = cy + s * math.sin(h) + off * math.cos(h)
        roads.append({
            "geometry": [{"x": float(x), "y": float(y), "z": 0.0}
                         for x, y in zip(xs, ys)],
            "type": "road_edge", "map_element_id": 15, "id": rid,
        })
        rid += 1
    for off in offs:  # main lane centerlines
        s = np.linspace(-0.55 * L, 0.55 * L, 10)
        xs = cx + s * math.cos(h) - off * math.sin(h)
        ys = cy + s * math.sin(h) + off * math.cos(h)
        roads.append({
            "geometry": [{"x": float(x), "y": float(y), "z": 0.0}
                         for x, y in zip(xs, ys)],
            "type": "lane", "map_element_id": 2, "id": rid,
        })
        rid += 1
    # the ramp centerline
    s = np.linspace(s_r0 - 30.0, s_r1 + 5.0, 14)
    lat = ramp_lat(s)
    xs = cx + s * math.cos(h) - lat * math.sin(h)
    ys = cy + s * math.sin(h) + lat * math.cos(h)
    roads.append({
        "geometry": [{"x": float(x), "y": float(y), "z": 0.0}
                     for x, y in zip(xs, ys)],
        "type": "lane", "map_element_id": 2, "id": rid,
    })
    return objects, roads


def scene_crosswalk(rng):
    """Straight road with a crosswalk; pedestrians (plus an occasional
    cyclist) cross between scheduled vehicle passes."""
    h = rng.uniform(-math.pi, math.pi)
    cx, cy = rng.uniform(-2000, 2000, 2)
    lane_w = rng.uniform(3.6, 4.4)
    n_l = int(rng.integers(1, 3))
    L = 200.0
    half = n_l * lane_w / 2 + 1.5
    s_cw = rng.uniform(-15.0, 15.0)
    offs = lane_offsets(n_l, lane_w)

    objects = []
    oid = 100
    # pedestrians: lateral crossings at the crosswalk
    ped_windows = {off: [] for off in offs}  # per-lane occupancy [t0, t1]
    n_ped = int(rng.integers(1, 4))
    for pk in range(n_ped):
        dirn = float(rng.choice([-1, 1]))
        vp = rng.uniform(1.3, 2.0)
        lat0 = -dirn * (half + rng.uniform(0.5, 2.0))
        # distinct s slots so peds never walk through each other
        s_p = s_cw + (pk - (n_ped - 1) / 2.0) * rng.uniform(1.9, 2.6)
        t0 = rng.uniform(0.0, 3.5)  # start walking at t0
        tt = np.maximum(np.arange(T) * DT - t0, 0.0)
        lat = lat0 + dirn * vp * tt
        xs = cx + s_p * math.cos(h) - lat * math.sin(h)
        ys = cy + s_p * math.sin(h) + lat * math.cos(h)
        hs = np.full(T, h + dirn * math.pi / 2)
        # cutoff: reached the far side (or horizon)
        across = np.abs(lat - lat0) >= (2 * half + rng.uniform(0.5, 1.5))
        cutoff = int(np.argmax(across)) if across.any() else T - 2
        cutoff = min(max(cutoff, 10), T - 2)
        objects.append(emit_object(rng, xs, ys, hs, cutoff, oid,
                                   otype="pedestrian", mark_expert=True))
        oid += 1
        for off in offs:  # record when this ped occupies each lane band
            band = lane_w / 2 + 1.6
            inlane = np.abs(lat - off) < band
            inlane &= np.arange(T) <= cutoff
            if inlane.any():
                ped_windows[off].append(
                    (np.argmax(inlane) * DT, (T - np.argmax(inlane[::-1])) * DT)
                )
    # vehicles: schedule strip crossings outside ped windows (same-lane
    # cars share a speed, so the follower gaps stay constant)
    for off in offs:
        v = rng.uniform(5.0, 9.0)
        occ = (2.5 + 2.6) / v  # strip half-width + car half-length, in s
        # exact ped-free intervals of [0.3, 8.2], then greedy placement
        blocked = sorted(
            (w0 - occ - 0.4, w1 + occ + 0.4) for w0, w1 in ped_windows[off]
        )
        free = []
        lo = 0.3
        for b0, b1 in blocked:
            if b0 > lo:
                free.append((lo, min(b0, 8.2)))
            lo = max(lo, b1)
        if lo < 8.2:
            free.append((lo, 8.2))
        spacing = 13.5 / v + 2 * occ
        picked = []
        for f0, f1 in free:
            tc = max(f0, (picked[-1] + spacing) if picked else f0)
            while tc <= f1 and len(picked) < 3:
                picked.append(tc)
                tc += spacing * rng.uniform(1.0, 1.6)
        rear_s0 = None
        for t_c in picked[:3]:
            s0 = s_cw - v * t_c
            if rear_s0 is not None and s0 > rear_s0 - 13.5:
                continue
            xs, ys, hs = straight_path(cx, cy, h, off, s0, v)
            cutoff = T - 2 if rng.random() < 0.5 else int(
                rng.integers(30, T - 1)
            )
            exit_step = int((t_c + occ) / DT) + 2
            cutoff = min(max(cutoff, exit_step), T - 2)
            objects.append(emit_object(rng, xs, ys, hs, cutoff, oid))
            oid += 1
            rear_s0 = s0
        # follower stopping before the crosswalk (lead-vehicle pressure)
        if rear_s0 is not None and rng.random() < 0.8:
            for _ in range(int(rng.integers(1, 3))):
                rear_s0 = rear_s0 - rng.uniform(14, 26)
                cut_max = int(((s_cw - 6.0) - rear_s0) / v / DT) - 1
                if cut_max < 12:
                    break
                cutoff_f = int(rng.integers(10, min(cut_max, T - 2) + 1))
                xs, ys, hs = straight_path(cx, cy, h, off, rear_s0, v)
                objects.append(emit_object(rng, xs, ys, hs, cutoff_f, oid))
                oid += 1
    # an occasional cyclist riding the shoulder
    if rng.random() < 0.4:
        v_c = rng.uniform(3.0, 5.5)
        s0 = rng.uniform(-70.0, -30.0)
        xs, ys, hs = straight_path(cx, cy, h, half + 1.0, s0, v_c)
        cutoff = int(rng.integers(30, T - 1))
        objects.append(emit_object(rng, xs, ys, hs, cutoff, oid,
                                   otype="cyclist", mark_expert=True))
        oid += 1

    roads = []
    rid = 1
    for off in (half, -half):
        s = np.linspace(-0.55 * L, 0.55 * L, 10)
        xs = cx + s * math.cos(h) - off * math.sin(h)
        ys = cy + s * math.sin(h) + off * math.cos(h)
        roads.append({
            "geometry": [{"x": float(x), "y": float(y), "z": 0.0}
                         for x, y in zip(xs, ys)],
            "type": "road_edge", "map_element_id": 15, "id": rid,
        })
        rid += 1
    for off in offs:
        s = np.linspace(-0.55 * L, 0.55 * L, 10)
        xs = cx + s * math.cos(h) - off * math.sin(h)
        ys = cy + s * math.sin(h) + off * math.cos(h)
        roads.append({
            "geometry": [{"x": float(x), "y": float(y), "z": 0.0}
                         for x, y in zip(xs, ys)],
            "type": "lane", "map_element_id": 2, "id": rid,
        })
        rid += 1
    # the crosswalk polygon (4 corners)
    corners = []
    for ds, dl in ((-2.0, -(half + 1.0)), (2.0, -(half + 1.0)),
                   (2.0, half + 1.0), (-2.0, half + 1.0)):
        s_c = s_cw + ds
        corners.append({
            "x": float(cx + s_c * math.cos(h) - dl * math.sin(h)),
            "y": float(cy + s_c * math.sin(h) + dl * math.cos(h)),
            "z": 0.0,
        })
    roads.append({"geometry": corners, "type": "crosswalk",
                  "map_element_id": 18, "id": rid})
    return objects, roads


def make_scene_v3(seed: int) -> dict:
    """Archetype mix with exact post-hoc verification (drop violators)."""
    for attempt in range(6):
        rng = np.random.default_rng(seed * 7 + attempt)
        r = rng.random()
        if r < 0.40:
            scene = make_scene(seed * 7 + attempt + 31337)
            # v2 arc scenes are collision-free by construction; still run
            # the goal check for uniformity
            scene["name"] = f"tfrecord-synth3_{seed}.json"
            scene["scenario_id"] = f"synthv3{seed:05d}"
            scene["metadata"]["synth_archetype"] = "arc"
            return scene
        if r < 0.70:
            kind = "intersection"
            objects, roads = scene_intersection(rng)
        elif r < 0.85:
            kind = "merge"
            objects, roads = scene_merge(rng)
        else:
            kind = "crosswalk"
            objects, roads = scene_crosswalk(rng)
        objects = objects[:32]
        objects = [o for o in objects if goal_entry_ok(o)]
        for i in reversed(verify_objects(objects, roads)):
            objects.pop(i)
        # vehicles first (sdc/tracks_to_predict point at a controllable one)
        objects.sort(key=lambda o: o["type"] != "vehicle")
        n_veh = sum(o["type"] == "vehicle" for o in objects)
        if len(objects) >= 4 and n_veh >= 2:
            segs = sum(len(rd["geometry"]) - 1 or 1 for rd in roads)
            if segs <= 250:
                return {
                    "name": f"tfrecord-synth3_{seed}.json",
                    "scenario_id": f"synthv3{seed:05d}",
                    "objects": objects,
                    "roads": roads,
                    "tl_states": {},
                    "metadata": {
                        "sdc_track_index": 0,
                        "objects_of_interest": [],
                        "tracks_to_predict": [
                            {"track_index": 0, "difficulty": 1}
                        ],
                        "synth_archetype": kind,
                    },
                }
    # all attempts failed: fall back to a v2 arc scene
    scene = make_scene(seed * 7 + 99991)
    scene["name"] = f"tfrecord-synth3_{seed}.json"
    scene["scenario_id"] = f"synthv3{seed:05d}"
    scene["metadata"]["synth_archetype"] = "arc"
    return scene




def validate_pool(paths, ignore_non_vehicles=False, device=None):
    """All-expert replay through the port's simulator on ``device`` (CUDA
    unless another is named): every valid agent must reach its goal with
    zero collision flags (the expert-replay contract, reference
    tests/test_expert.py)."""
    import torch

    from gpudrive_lab_torch.core import step as stepmod
    from gpudrive_lab_torch.core.types import (
        CollisionBehaviour, DynamicsModel, Params, RewardType,
    )
    from gpudrive_lab_torch.scene.compiler import build_scene

    params = Params(
        dynamics_model=DynamicsModel.CLASSIC,
        collision_behaviour=CollisionBehaviour.IGNORE,
        reward_type=RewardType.ON_GOAL_ACHIEVED,
        dist_to_goal_threshold=THRESH,
        observation_radius=50.0,
        polyline_reduction_threshold=0.1,
        ignore_non_vehicles=ignore_non_vehicles,
        max_num_controlled_agents=0,
    )
    scene = build_scene(paths, params, device=device)
    state = stepmod.reset(scene, None, params)
    acts = torch.zeros(tuple(scene.agents.valid.shape) + (10,),
                       dtype=torch.float32, device=scene.device)
    for _ in range(T):
        state = stepmod.step(scene, state, acts, params)
    valid = scene.agents.valid
    col = (state.collided_vehicle + state.collided_non_vehicle
           + state.collided_road)
    n_valid = int(valid.sum())
    n_goal = int((state.reached_goal * valid).sum())
    n_col = int((col * valid > 0).sum())
    print(f"validate: {len(paths)} scenes, {n_valid} agents, "
          f"goal {n_goal}/{n_valid}, collided {n_col}")
    return n_goal == n_valid and n_col == 0


def main(argv=None):
    from gpudrive_lab_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data/pool_v3")
    ap.add_argument("--num", type=int, default=512)
    ap.add_argument("--seed0", type=int, default=1000)
    ap.add_argument("--version", type=int, choices=[2, 3], default=3)
    ap.add_argument("--validate", type=int, default=0,
                    help="run all-expert sim replay on this many scenes "
                         "and assert 100%% goal / 0 collisions")
    ap.add_argument("--device", "--platform", dest="device", default=None,
                    help="torch device or JAX platform name of --validate; "
                         "CUDA unless another is named (cpu for the CPU); "
                         "the run fails without CUDA otherwise")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    gen = make_scene_v3 if args.version == 3 else make_scene
    max_roads = 0
    max_agents = 0
    paths = []
    from collections import Counter

    kinds = Counter()
    for i in range(args.num):
        scene = gen(args.seed0 + i)
        segs = sum(len(r["geometry"]) - 1 or 1 for r in scene["roads"])
        max_roads = max(max_roads, segs)
        max_agents = max(max_agents, len(scene["objects"]))
        types = {o["type"] for o in scene["objects"]}
        kinds[scene["metadata"].get("synth_archetype", "arc")] += 1
        kinds["with_peds"] += "pedestrian" in types
        kinds["with_cyclists"] += "cyclist" in types
        path = os.path.join(args.out, scene["name"])
        with open(path, "w") as f:
            json.dump(scene, f)
        paths.append(path)
    print(f"wrote {args.num} scenes to {args.out} "
          f"(max segments {max_roads}, max agents {max_agents}) "
          f"mix={dict(kinds)}")
    if args.validate:
        ok = validate_pool(paths[: args.validate], device=device)
        if not ok:
            raise SystemExit("validation FAILED")
    return paths


if __name__ == "__main__":
    main()

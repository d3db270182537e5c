"""Behavior tagging over processed scene JSONs (port of
``gpudrive_lab_tpu/data_utils/detect_behavior.py``).

Mirror of the reference's scene-behavior scanner
(reference: data_utils/detect_behavior.py:14-220): counts vehicles that
perform U-turns (cumulative heading change beyond ~150 degrees between valid
steps) or sustained reversing (velocity pointing into the rear cone of the
heading for >= min_timesteps consecutive valid steps).
"""

from __future__ import annotations

import argparse
import json
from multiprocessing import cpu_count, get_context

# fork() after CUDA is initialised in the parent is unsafe (the child
# inherits a CUDA context it cannot use); spawn starts a fresh interpreter
Pool = get_context("spawn").Pool
from pathlib import Path

import numpy as np

UTURN_ANGLE_THRESHOLD = 2.618  # ~150 degrees (reference: :24)
SPEED_EPS = 0.5


def check_uturn(headings: np.ndarray, valid_mask: np.ndarray) -> bool:
    """reference: detect_behavior.py:14-42."""
    h = headings[valid_mask]
    if len(h) < 2:
        return False
    ref = h[0]
    for angle in h[1:]:
        diff = np.arctan2(np.sin(angle - ref), np.cos(angle - ref))
        if abs(diff) > UTURN_ANGLE_THRESHOLD:
            return True
    return False


def check_reversing(
    headings: np.ndarray,
    velocities: np.ndarray,
    valid_mask: np.ndarray,
    min_timesteps: int = 10,
) -> bool:
    """reference: detect_behavior.py:44-90."""
    consecutive = 0
    for h, v, ok in zip(headings, velocities, valid_mask):
        if not ok:
            consecutive = 0
            continue
        speed = np.hypot(v[0], v[1])
        if speed < SPEED_EPS:
            consecutive = 0
            continue
        vel_angle = np.arctan2(v[1], v[0])
        diff = np.arctan2(np.sin(vel_angle - h), np.cos(vel_angle - h))
        if abs(diff) > np.pi / 2:
            consecutive += 1
            if consecutive >= min_timesteps:
                return True
        else:
            consecutive = 0
    return False


def process_scene(args):
    """reference: detect_behavior.py:92-127."""
    filepath, min_reverse_timesteps = args
    try:
        with open(filepath) as f:
            data = json.load(f)
    except (json.JSONDecodeError, IOError):
        return filepath, (0, 0, 0)
    total = uturns = reverses = 0
    for obj in data.get("objects", []):
        if obj.get("type") != "vehicle":
            continue
        total += 1
        valid = np.array(obj["valid"], bool)
        headings = np.array(obj["heading"], np.float64)
        velocities = np.array(
            [[v["x"], v["y"]] for v in obj["velocity"]], np.float64
        )
        if check_uturn(headings, valid):
            uturns += 1
        if check_reversing(headings, velocities, valid, min_reverse_timesteps):
            reverses += 1
    return filepath, (total, uturns, reverses)


def process_directory(dataset_dir: str, min_reverse_timesteps: int = 10,
                      num_workers=None) -> dict:
    files = sorted(Path(dataset_dir).glob("*.json"))
    total = uturns = reverses = 0
    flagged = []
    with Pool(num_workers or cpu_count()) as pool:
        for path, (t, u, r) in pool.imap_unordered(
            process_scene, [(str(f), min_reverse_timesteps) for f in files]
        ):
            total += t
            uturns += u
            reverses += r
            if u or r:
                flagged.append(path)
    return {
        "total_agents": total,
        "total_uturns": uturns,
        "total_reversing": reverses,
        "uturn_percentage": 100.0 * uturns / total if total else 0.0,
        "reverse_percentage": 100.0 * reverses / total if total else 0.0,
        "flagged_scenes": flagged,
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset-dir", required=True)
    p.add_argument("--min_reverse_timesteps", type=int, default=10)
    p.add_argument("--num-workers", type=int, default=None)
    args = p.parse_args()
    stats = process_directory(
        args.dataset_dir, args.min_reverse_timesteps, args.num_workers
    )
    print(json.dumps({k: v for k, v in stats.items() if k != "flagged_scenes"}))


if __name__ == "__main__":
    main()

"""Dataset validation / flattening (port of
``gpudrive_lab_tpu/data_utils/post_processing.py``).

Mirror of the reference's post-processing (reference:
data_utils/post_processing.py:8-214): validate scenario-JSON structure,
delete corrupt files, and flatten ``group_*`` subdirectories from HF-hub
downloads into the dataset root.
"""

from __future__ import annotations

import argparse
import json
import shutil
from multiprocessing import cpu_count, get_context

# fork() after CUDA is initialised in the parent is unsafe (the child
# inherits a CUDA context it cannot use); spawn starts a fresh interpreter
Pool = get_context("spawn").Pool
from pathlib import Path


def is_valid_json_structure(file_path) -> bool:
    """reference: post_processing.py:8-43."""
    try:
        with open(file_path) as f:
            data = json.load(f)
        if not all(k in data for k in ("name", "objects", "roads", "tl_states")):
            return False
        if not isinstance(data["objects"], list) or not all(
            isinstance(o, dict) and "position" in o and "type" in o
            for o in data["objects"]
        ):
            return False
        if not isinstance(data["roads"], list) or not all(
            isinstance(r, dict) and "geometry" in r for r in data["roads"]
        ):
            return False
        for road in data["roads"]:
            if not all(
                isinstance(g, dict) and "x" in g and "y" in g
                for g in road.get("geometry", [])
            ):
                return False
        return True
    except (json.JSONDecodeError, ValueError, IOError):
        return False


def process_file(args):
    """Validate and optionally move one file
    (reference: post_processing.py:45-80)."""
    source_path, target_dir, should_move = args
    source_path = Path(source_path)
    if not is_valid_json_structure(source_path):
        try:
            source_path.unlink()
        except OSError:
            pass
        return str(source_path), False
    if should_move and target_dir:
        try:
            shutil.move(str(source_path), str(Path(target_dir) / source_path.name))
        except OSError:
            return str(source_path), False
    return str(source_path), True


def process_directory(dataset_dir: str, num_workers=None):
    """reference: post_processing.py:82-170."""
    root = Path(dataset_dir)
    if not root.is_dir():
        return 0, 0
    group_dirs = [
        d for d in root.iterdir() if d.is_dir() and d.name.startswith("group_")
    ]
    tasks = []
    for g in sorted(group_dirs):
        tasks.extend((str(f), str(root), True) for f in g.glob("*.json"))
    tasks.extend(
        (str(f), None, False)
        for f in root.glob("*.json")
    )
    if not tasks:
        return 0, 0
    valid = invalid = 0
    with Pool(num_workers or cpu_count()) as pool:
        for _, ok in pool.imap_unordered(process_file, tasks):
            valid += ok
            invalid += not ok
    for g in group_dirs:
        try:
            g.rmdir()
        except OSError:
            pass
    return valid, invalid


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--dataset-dirs", nargs="+", required=True)
    p.add_argument("--num-workers", type=int, default=None)
    args = p.parse_args()
    for d in args.dataset_dirs:
        valid, invalid = process_directory(d, args.num_workers)
        print(f"{d}: {valid} valid, {invalid} removed")


if __name__ == "__main__":
    main()

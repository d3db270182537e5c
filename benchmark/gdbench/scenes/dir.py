"""Scenes kept in a directory of the repository: its ``count`` first JSON
files in sorted order, tiled when there are fewer."""

from __future__ import annotations

from pathlib import Path

from ..registry import ROOT


def scene_paths(spec: dict, cache_root: Path) -> list:
    base = ROOT / spec["dir"]
    files = sorted(str(p) for p in base.glob("*.json"))
    if not files:
        raise FileNotFoundError(f"no scenes in {base}")
    return [files[i % len(files)] for i in range(spec["count"])]

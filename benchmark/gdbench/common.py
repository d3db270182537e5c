"""What both drivers share: the run's result, the scenes a traffic mix
names, the device's description, and the comparison helpers that decide
``correct``."""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from multiprocessing import get_context

import numpy as np
import torch

from .registry import BENCH_DIR

# Caches the benchmark and the program write, inside the checkout at fixed
# paths (listed in .gitignore), so only a checkout's first run fills them.
CACHE_DIR = BENCH_DIR / ".cache"
GIB = 1024.0 ** 3


@dataclass
class RunResult:
    """What a driver hands back to ``run.py``."""

    attempted: int
    failed: int
    end_to_end: dict  # metric name -> value
    checks: dict  # compared number -> (value, limit)
    memory_peak_bytes: int
    setup_parts: dict  # part -> seconds
    device: torch.device  # the (first) device the run used
    trace: object = None  # trace.TraceSummary of the traced window
    ctx: dict = field(default_factory=dict)  # what the metric readers read

    @property
    def correct(self) -> bool:
        return all(v <= lim for v, lim in self.checks.values())


def use_cache_dirs() -> None:
    """Point the build and kernel caches that PyTorch and Triton honour at
    fixed directories of the checkout (the port builds its own kernels
    into ``gpudrive_lab_torch/_build`` in the checkout)."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(CACHE_DIR / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE_DIR / "triton"))


def scene_paths(spec: dict) -> list:
    """The scene JSON files of a traffic mix's ``scenes`` entry, from the
    module of ``gdbench/scenes/`` that its ``kind`` names."""
    kind = importlib.import_module(f"gdbench.scenes.{spec['kind']}")
    return kind.scene_paths(spec, CACHE_DIR / "scenes")


def first_card() -> torch.device:
    """The first CUDA card, made the current one: a one-chip driver's
    device."""
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return device


def device_description(device: torch.device, count: int) -> dict:
    return {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": count}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().replace("\n", "; ")


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def log(*parts) -> None:
    print("[bench]", *parts, file=sys.stderr, flush=True)


def compile_scenes_reference(paths, params, device, workers: int = 0):
    """The reference's own compile of ``paths``: serially, or over
    ``workers`` spawned processes for large batches."""
    from .reference import compiler

    if workers <= 1:
        return compiler.build_scene(paths, params, max_agents="auto",
                                    device=device)
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as ex:
        worlds = list(ex.map(compiler.compile_world, paths,
                             [params] * len(paths), chunksize=8))
    return compiler.stack_worlds(worlds, params, max_agents="auto",
                                 device=device)


# ---- comparison helpers -------------------------------------------------

def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    d = (a.double() - b.double()).abs()
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    return float(d.max())


def angle_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest wrapped difference of two angle tensors."""
    if a.numel() == 0:
        return 0.0
    d = a.double() - b.double()
    d = torch.atan2(torch.sin(d), torch.cos(d)).abs()
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    return float(d.max())


def set_gap(p: torch.Tensor, r: torch.Tensor, chunk: int = 256) -> float:
    """Largest Hausdorff distance, under the max-norm over features,
    between the row sets p[i] and r[i] ([N, K, F] each, on r's device):
    the gap of two selections of K rows whatever their order inside K."""
    worst = 0.0
    for i in range(0, p.shape[0], chunk):
        a = p[i:i + chunk].to(r.device, torch.float32)
        b = r[i:i + chunk].to(torch.float32)
        d = (a[:, :, None] - b[:, None]).abs().amax(-1)  # [n, K, K]
        d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
        h = torch.maximum(d.amin(2).amax(1), d.amin(1).amax(1))
        worst = max(worst, float(h.max()))
    return worst


def leaf_gap(prog: dict, ref: dict, keep) -> tuple:
    """(worst gap, its leaf): over the leaves in ``keep``, the gap between
    the program's and the reference's norm of each leaf, against the
    larger of the reference leaf's norm and the median leaf's."""
    norms = {k: float(ref[k].double().norm()) for k in keep}
    med = float(np.median(list(norms.values()))) if norms else 0.0
    worst, where = 0.0, None
    for k in keep:
        gap = abs(float(prog[k].double().norm()) - norms[k])
        rel = gap / max(norms[k], med, 1e-30)
        if not np.isfinite(rel):
            rel = float("inf")
        if rel >= worst:
            worst, where = rel, k
    return worst, where


SCENE_FIELDS = {"agents": ("valid", "etype", "size", "goal", "controlled",
                           "static", "traj_pos", "traj_vel", "traj_yaw",
                           "traj_valid"),
                "roads": ("pos", "yaw", "scale", "etype", "valid")}
STATE_FLOATS = ("pos", "vel", "ang_vel", "reward", "z")
STATE_FLAGS = ("collided", "done", "collided_road", "collided_vehicle",
               "collided_non_vehicle", "reached_goal", "steps_remaining")


def cpu_state(s) -> dict:
    """A SimState's fields on the host."""
    return {f: getattr(s, f).detach().cpu() for f in s.__dataclass_fields__}


def scene_arrays(scene) -> dict:
    """The compiled scene's arrays that the start is compared on, on the
    host."""
    return {f"{grp}.{k}": getattr(getattr(scene, grp), k).detach().cpu()
            for grp, keys in SCENE_FIELDS.items() for k in keys}


def compare_states(prog: dict, ref) -> tuple:
    """(largest float gap, angles wrapped, flags that differ) of a state's
    fields on the host (``prog``) and a reference SimState."""
    gap = max(max_abs(prog[k], getattr(ref, k).cpu()) for k in STATE_FLOATS)
    yaw = angle_gap(prog["yaw"], ref.yaw.cpu())
    flags = sum(int((prog[k] != getattr(ref, k).cpu()).sum())
                for k in STATE_FLAGS)
    return max(gap, yaw), flags


def compare_start(prog_scene: dict, prog_fresh: dict, rscene,
                  rfresh) -> tuple:
    """(largest float gap, entries that differ) of the program's compiled
    scene and reset state against the reference's own."""
    gap, flags = 0.0, 0
    for key, prog in prog_scene.items():
        grp, name = key.split(".")
        ref = getattr(getattr(rscene, grp), name).cpu()
        if prog.shape != ref.shape:
            flags += max(prog.numel(), ref.numel())
        elif prog.dtype.is_floating_point:
            gap = max(gap, (angle_gap if "yaw" in name else max_abs)(prog,
                                                                      ref))
        else:
            flags += int((prog != ref).sum())
    g, f = compare_states(prog_fresh, rfresh)
    return max(gap, g), flags + f

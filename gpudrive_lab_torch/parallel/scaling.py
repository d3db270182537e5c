"""Scaling of the world-sharded step across processes (the counterpart of
``bench_scaling.py``).

For each rank count k in ``counts`` it starts k ranks (``spawn``), each
holding its contiguous block of ``worlds_per_rank`` pool_v3 worlds
(``shard_scene_paths``), times ``steps`` simulator steps between two
barriers, and reports world-steps/s = steps x k x worlds_per_rank / the
slowest rank's wall time, and the efficiency SPS(k) / (k x SPS(1))
(``distributed.scaling_efficiency``).

Rank r runs on card r where the host has a card per rank
(``distributed.rank_devices``); those counts measure scaling.  Ranks that
share one device (more ranks than cards, a card named by index, or the
CPU) split one device's work: their numbers validate the sharded program
and the measurement, and are labelled not scaling evidence (``valid``
false), as the JAX harness labels virtual meshes.

    python -m gpudrive_lab_torch.parallel.scaling --counts 1 2 4
    python -m gpudrive_lab_torch.parallel.scaling --counts 1 2 --backend gloo
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.parallel import distributed as dist
from gpudrive_lab_torch.rollout import SLICE_CONFIG, pool_scene_paths
from gpudrive_lab_torch.scene.compiler import build_scene

SHARED_LABEL = ("not scaling evidence: ranks share one device, so they "
                "split one device's work")


def _rank_main(rank: int, spec: dict) -> float:
    """A rank: its block's step, timed; returns the slowest rank's best
    seconds."""
    k = spec["ranks"]
    device = torch.device(spec["devices"][rank])
    dist.initialize(spec["backend"], spec["init_method"], k, rank, device)
    wpr = spec["worlds_per_rank"]
    paths = dist.shard_scene_paths(pool_scene_paths(spec["root"]), wpr,
                                   rank, k)
    params = EnvConfig(**SLICE_CONFIG).sim_params()
    scene = build_scene(paths, params, device=device)
    state = stepmod.reset(scene, None, params)
    acts = torch.zeros((wpr, scene.max_agents, C.ACTION_DIM), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if k > 1:
            torch.distributed.barrier()

    s = state
    for _ in range(2):  # warm-up
        s = stepmod.step(scene, s, acts, params)
    best = None
    for _ in range(spec["reps"]):
        s = state
        sync()
        t0 = time.perf_counter()
        for _ in range(spec["steps"]):
            s = stepmod.step(scene, s, acts, params)
        sync()
        # on the device: NCCL reduces CUDA tensors only
        dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                          device=device)
        if k > 1:  # the slowest rank's time
            torch.distributed.all_reduce(dt, torch.distributed.ReduceOp.MAX)
        best = float(dt) if best is None else min(best, float(dt))
    dist.shutdown()
    return best


def measure_scaling(counts=(1, 2), device=None, worlds_per_rank: int = 128,
                    steps: int = 30, reps: int = 3, backend: str | None = None,
                    root: str | None = None, timeout: float = 600.0) -> dict:
    """World-steps/s of the world-sharded step at each rank count of
    ``counts``, the best of ``reps`` timed runs.  Ranks are placed by
    ``distributed.rank_devices(device, k)`` (``device`` CUDA unless the
    caller names another); ``backend`` defaults to NCCL on CUDA and gloo on
    the CPU, and ranks that share a card need "gloo".  Returns {"sps": {k:
    world-steps/s}, "efficiency": {k: ...}, "devices": {k: [device per
    rank]}, "valid": every count had a device per rank, "label": None or
    ``SHARED_LABEL``}."""
    root = root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sps, devices = {}, {}
    for k in counts:
        devs = dist.rank_devices(device, k)
        spec = dict(ranks=k, devices=[str(d) for d in devs],
                    backend=dist.rank_backend(backend, devs),
                    worlds_per_rank=worlds_per_rank, steps=steps, reps=reps,
                    root=root)
        seconds = dist.run_ranks(_rank_main, k, spec, timeout)[0]
        sps[k] = steps * k * worlds_per_rank / seconds
        devices[k] = spec["devices"]
    base = counts[0]
    valid = all(len(set(d)) == len(d) for d in devices.values())
    return {"sps": sps,
            "efficiency": {k: dist.scaling_efficiency(v / k,
                                                      sps[base] / base)
                           for k, v in sps.items()},
            "devices": devices, "valid": valid,
            "label": None if valid else SHARED_LABEL,
            "worlds_per_rank": worlds_per_rank, "steps": steps}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--counts", type=int, nargs="+", default=[1, 2])
    p.add_argument("--device", default=None)
    p.add_argument("--worlds-per-rank", type=int, default=128)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--backend", default=None)
    args = p.parse_args(argv)
    out = measure_scaling(tuple(args.counts), args.device,
                          args.worlds_per_rank, args.steps,
                          backend=args.backend)
    for k, v in out["sps"].items():
        print(json.dumps({"ranks": k, "worlds": k * args.worlds_per_rank,
                          "world_steps_per_sec": v,
                          "efficiency": out["efficiency"][k],
                          "devices": out["devices"][k],
                          "valid": out["valid"], "label": out["label"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

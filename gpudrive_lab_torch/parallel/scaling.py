"""Scaling of the world-sharded step across processes (the port of
``bench_scaling.py``, with its flags, workload and printed JSON).

Measures world-steps/s of the world-sharded sim step at 1, 2, 4, ... ranks
and reports efficiency = SPS(n) / (n x SPS(1)), BASELINE.json's north-star
metric (target >= 85 %).  Each count k starts k ranks (``spawn``); rank r
holds its block of W = ``--worlds-per-device`` worlds of the k x W worlds
of ``synthetic_scene(num_worlds=k * W, num_agents=8, num_roads=16)`` and
steps it under ``Params()`` with the JAX script's program: the actions are
an argument, zero but for [0, 0, 0] = 1e-6 x (rep + 1) on the global world
axis, every repetition starts from the reset state, and a reward
accumulator is carried along.  World-steps/s = steps x k x W / the slowest
rank's best wall time.  ``measure_scaling(..., workload="pool")`` steps
blocks of data/pool_v3 worlds under the slice's configuration instead,
with the program its first readings were taken with (two warm-up steps,
zero actions, no accumulator: ``pool_body``).

Without ``--counts`` it times 1, 2, 4, ... up to min(``--max-devices``,
n): n is the host's card count where each rank takes a card of its own
(``--platform`` cuda or gpu, the default), else ``--max-devices`` with
every rank on the one named device (cpu, or a card named by index), the
counterpart of the JAX script's forced-host virtual devices.  Ranks that
share a device split its work: their efficiency validates the sharded
program and the measurement only, and the summary says so (``valid``
false, ``invalid_reason``).  So does a run that timed one count only (a
one-card host at the defaults), which measured no scaling.

Prints one line per count to stderr, then one summary line to stdout
(``metric``, ``value``, ``unit``, ``vs_baseline`` = efficiency / 0.85,
``per_device_counts``, ``valid`` and, where ranks share a device,
``invalid_reason``), as the JAX script does.

    python -m gpudrive_lab_torch.parallel.scaling --max-devices 4
    python -m gpudrive_lab_torch.parallel.scaling --platform cuda:0 \\
        --counts 1 2 --backend gloo
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.core.types import Params
from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.parallel import distributed as dist
from gpudrive_lab_torch.parallel.mesh import shard_worlds
from gpudrive_lab_torch.rollout import SLICE_CONFIG, pool_scene_paths
from gpudrive_lab_torch.scene.compiler import build_scene
from gpudrive_lab_torch.scene.synthetic import synthetic_scene

SHARED_LABEL = ("ranks share one device (the CPU's cores, or one card), so "
                "they split one device's work; this validates the sharded "
                "program and the measurement only: run with a card per rank "
                "for a quotable efficiency")
ONE_COUNT_LABEL = ("one rank count timed: no scaling measured; run on a "
                   "host with a card per rank, or name --counts")
WORKLOADS = ("synthetic", "pool")


def workload_scene(workload: str, group, worlds_per_rank: int, root: str):
    """(this rank's block of the scene, its Params) for the group's ranks
    of ``worlds_per_rank`` worlds each: the JAX script's synthetic worlds
    under ``Params()``, or pool_v3 worlds under the slice's
    configuration."""
    if workload == "synthetic":
        scene = synthetic_scene(num_worlds=group.size * worlds_per_rank,
                                num_agents=8, num_roads=16,
                                device=group.device)
        return shard_worlds(scene, group), Params()
    paths = dist.shard_scene_paths(pool_scene_paths(root), worlds_per_rank,
                                   group.rank, group.size)
    params = EnvConfig(**SLICE_CONFIG).sim_params()
    return build_scene(paths, params, device=group.device), params


def rep_actions(acts0: torch.Tensor, rep: int, rank: int) -> torch.Tensor:
    """Repetition ``rep``'s actions on a rank: the JAX script's
    ``acts0.at[0, 0, 0].set(1e-6 * (rep + 1))`` on the global world axis,
    whose world 0 is rank 0's."""
    acts = acts0.clone()
    if rank == 0:
        acts[0, 0, 0] = 1e-6 * (rep + 1)
    return acts


def body(scene, state, acts, acc, params):
    """One timed step: the next state and the accumulator plus its
    reward[0, 0] (the JAX script's jitted body)."""
    s2 = stepmod.step(scene, state, acts, params)
    return s2, acc + s2.reward[0, 0]


def pool_body(scene, state, acts, acc, params):
    """The pool workload's timed step: the step alone, the accumulator
    untouched."""
    return stepmod.step(scene, state, acts, params), acc


def _rank_main(rank: int, spec: dict) -> float:
    """A rank: its block's step, timed; returns the slowest rank's best
    seconds."""
    k = spec["ranks"]
    group = dist.initialize(spec["backend"], spec["init_method"], k, rank,
                            torch.device(spec["devices"][rank]))
    device = group.device
    scene, params = workload_scene(spec["workload"], group,
                                   spec["worlds_per_rank"], spec["root"])
    fresh = stepmod.reset(scene, None, params)
    acts0 = torch.zeros((spec["worlds_per_rank"], scene.max_agents,
                         C.ACTION_DIM), device=device)
    zero = torch.zeros((), device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        if k > 1:
            torch.distributed.barrier()

    pool = spec["workload"] == "pool"
    timed = pool_body if pool else body
    s = fresh
    for _ in range(2 if pool else 1):  # warm-up (kernels built)
        s, _ = timed(scene, s, acts0, zero, params)
    best = None
    for rep in range(spec["reps"]):
        acts = acts0 if pool else rep_actions(acts0, rep, rank)
        s, acc = fresh, zero
        sync()
        t0 = time.perf_counter()
        for _ in range(spec["steps"]):
            s, acc = timed(scene, s, acts, acc, params)
        sync()
        # on the device: NCCL reduces CUDA tensors only
        dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                          device=device)
        if k > 1:  # the slowest rank's time
            torch.distributed.all_reduce(dt, torch.distributed.ReduceOp.MAX)
        best = float(dt) if best is None else min(best, float(dt))
    dist.shutdown()
    return best


def default_counts(max_devices: int, device=None) -> list[int]:
    """1, 2, 4, ... up to min(``max_devices``, n), as bench_scaling.py
    counts: n is the host's card count where ranks take a card each (CUDA
    without an index), else ``max_devices`` (ranks share the device)."""
    dev = resolve_device(device)
    n = (torch.cuda.device_count() if dev.type == "cuda" and dev.index is None
         else max_devices)
    counts, k = [1], 2
    while k <= min(max_devices, n):
        counts.append(k)
        k *= 2
    return counts


def measure_scaling(counts=(1, 2), device=None, worlds_per_rank: int = 8,
                    steps: int = 30, reps: int = 3, backend: str | None = None,
                    root: str | None = None, timeout: float = 600.0,
                    workload: str = "synthetic") -> dict:
    """World-steps/s of the world-sharded step at each rank count of
    ``counts`` (the first is 1), the best of ``reps`` timed runs of
    ``steps`` steps.  Ranks are placed by ``distributed.rank_devices(device,
    k)`` (``device`` CUDA unless the caller names another); ``backend``
    defaults to NCCL on CUDA and gloo on the CPU, and ranks that share a
    card need "gloo".  ``workload`` is "synthetic" (the JAX script's) or
    "pool".  Returns {"sps": {k: world-steps/s}, "efficiency": {k: ...},
    "devices": {k: [device per rank]}, "valid": more than one count and a
    card per rank in each, "label": None where valid, else
    ``SHARED_LABEL`` or ``ONE_COUNT_LABEL``, and the arguments'
    "worlds_per_rank", "steps", "workload"}."""
    if counts[0] != 1:
        raise ValueError(f"counts {counts}: the efficiency is against one "
                         "rank, so the first count is 1")
    if workload not in WORKLOADS:
        raise ValueError(f"workload {workload!r}: one of {WORKLOADS}")
    root = root or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sps, devices = {}, {}
    for k in counts:
        devs = dist.rank_devices(device, k)
        spec = dict(ranks=k, devices=[str(d) for d in devs],
                    backend=dist.rank_backend(backend, devs),
                    worlds_per_rank=worlds_per_rank, steps=steps, reps=reps,
                    root=root, workload=workload)
        seconds = dist.run_ranks(_rank_main, k, spec, timeout)[0]
        sps[k] = steps * k * worlds_per_rank / seconds
        devices[k] = spec["devices"]
    shared = not all(len(set(d)) == len(d)
                     and torch.device(d[0]).type == "cuda"
                     for d in devices.values())
    label = (SHARED_LABEL if shared
             else ONE_COUNT_LABEL if len(counts) == 1 else None)
    return {"sps": sps,
            "efficiency": {k: dist.scaling_efficiency(v / k, sps[1])
                           for k, v in sps.items()},
            "devices": devices, "valid": label is None, "label": label,
            "worlds_per_rank": worlds_per_rank, "steps": steps,
            "workload": workload}


def summary(result: dict) -> dict:
    """bench_scaling.py's summary line of a ``measure_scaling`` result,
    with its keys and rounding."""
    eff = result["efficiency"]
    n = list(eff)[-1]
    out = {
        "metric": "scaling_efficiency",
        "value": round(eff[n], 4),
        "unit": f"SPS({n} dev) / ({n} x SPS(1))",
        # BASELINE.md north star: >= 85% efficiency at scale.
        "vs_baseline": round(eff[n] / 0.85, 4),
        "per_device_counts": {str(k): round(v, 3) for k, v in eff.items()},
        "valid": result["valid"],
    }
    if not result["valid"]:
        out["invalid_reason"] = result["label"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--max-devices", type=int, default=8)
    p.add_argument("--worlds-per-device", "--worlds-per-rank",
                   dest="worlds_per_device", type=int, default=8)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--platform", "--device", dest="device", default=None,
                   help="torch device or JAX platform name; CUDA (a card "
                        "per rank) unless another is named; the run fails "
                        "without CUDA otherwise")
    p.add_argument("--counts", type=int, nargs="+", default=None,
                   help="rank counts to time, the first 1 (default: 1, 2, "
                        "4, ... up to min(--max-devices, n))")
    p.add_argument("--backend", default=None,
                   help="process-group backend (default: NCCL on CUDA, "
                        "gloo on the CPU; ranks that share a card need "
                        "gloo)")
    args = p.parse_args(argv)
    counts = args.counts or default_counts(args.max_devices, args.device)
    result = measure_scaling(counts, args.device, args.worlds_per_device,
                             args.steps, backend=args.backend)
    for k, v in result["sps"].items():
        print(json.dumps({"devices": k, "worlds": k * args.worlds_per_device,
                          "world_steps_per_sec": round(v)}), file=sys.stderr)
    print(json.dumps(summary(result)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

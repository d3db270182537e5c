#!/usr/bin/env python3
"""Time versions of the agent-road kernels K1 and K2 against each other.

Builds each given ``agent_road.cu`` (default: the package's
``csrc/agent_road.cu``; any file with the same C entry points, such as an
older version unpacked from git) with the package's nvcc flags, then, in
the order given, puts each behind the wrappers of
``gpudrive_lab_torch/core/kernels.py`` (``cuda_build.use``) and reads, on
the same inputs:

  * the slice: K2 on the 512 ``data/pool_v3`` worlds (128 agent rows, 256
    roads) after 5 random steps, as in ``chip_smoke.py`` phase 2;
  * the padded 2048-road tiled path: K1 and K2 after 5 random steps, as in
    phase 4;
  * the synthetic large map of ``scene/large_map.py`` (10,240 roads):
    K1 and K2, as in phase 7.

Each version is first held against the plain versions (bitwise; the large
map on its first 16 worlds, K1 against K2 at full width).  For each kernel
and input it prints the wrapper's time per call (CUDA events, ``--reps``
calls), the device time per launch (torch.profiler, ``--reps`` launches)
and the bound, then one JSON line with all readings; ``--out`` also writes
it to a file.  All wrapper times are read, in every run, before the first
profiler session: after one, each launch costs the host more for the rest
of the process.
Needs an NVIDIA GPU and nvcc.  Parent against change, in turns:

    python3 scripts/time_agent_road.py --source parent=old/agent_road.cu \\
        --source new=gpudrive_lab_torch/csrc/agent_road.cu \\
        --order parent,new,new,parent
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(source: str) -> tuple[ctypes.CDLL, str]:
    """The library of one agent_road.cu and ptxas's register lines."""
    from gpudrive_lab_torch import cuda_build

    lib, log = cuda_build.load_source("agent_road", source)
    return lib, "; ".join(line.strip() for line in log.splitlines()
                          if "registers" in line)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", action="append", default=[],
                    help="label=path of an agent_road.cu (repeatable)")
    ap.add_argument("--order", default=None,
                    help="comma-separated labels, in turn (default: each "
                         "source once)")
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_agent_road: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from gpudrive_lab_torch import cuda_build
    from gpudrive_lab_torch.core import collision, kernels
    from gpudrive_lab_torch.core import step as stepmod
    from gpudrive_lab_torch.rollout import pool_scene_paths, slice_env
    from gpudrive_lab_torch.scene.large_map import LARGE_MAP, large_map
    from gpudrive_lab_torch.utils.profiling import kernel_time_ms

    sources = dict(s.split("=", 1) for s in args.source) or {
        "package": str(cuda_build.CSRC / "agent_road.cu")}
    order = args.order.split(",") if args.order else list(sources)
    libs = {}
    for label, path in sources.items():
        libs[label], regs = build(path)
        print(f"[build] {label} ({os.path.relpath(path, ROOT)}): {regs}")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)

    def stepped(env):
        W, A = env.num_worlds, env.max_agent_count
        for _ in range(5):
            env.step_dynamics(torch.randint(
                0, env.action_space_n, (W, A), generator=gen, device=dev))
        s, scene = env.state, env.scene
        active = ~collision._skip_mask(scene, s,
                                       stepmod.current_step_index(s))
        feat = collision.agent_features(
            scene, s, active, collision.agent_half_extents(scene))
        return feat, collision.road_features_t(scene)

    scenes = pool_scene_paths(ROOT)
    inputs = {}
    feat, roads_t = stepped(slice_env(scenes, device=dev))
    inputs["slice"] = dict(K2=(feat, roads_t))
    tenv = slice_env(scenes, device=dev, max_roads=2048,
                     use_tile_collision=True)
    feat, roads_t = stepped(tenv)
    feat_s, mask, inv_perm = collision.tile_mask_and_order(
        tenv.scene, tenv.state, feat)
    inputs["padded_2048"] = dict(K2=(feat, roads_t),
                                 K1=(feat_s, tenv.scene.rtiles.feat, mask),
                                 inv_perm=inv_perm)
    del tenv
    m = large_map(**LARGE_MAP, seed=cs.SEED, device=dev)
    print(f"[large map] {m.describe()}")
    inputs["large_map"] = dict(K2=(m.agents, m.roads_t),
                               K1=(m.agents_s, m.rtiles.feat, m.mask),
                               inv_perm=m.inv_perm)

    fns = {"K2": (kernels.agent_road_hits_dense,
                  kernels.agent_road_hits_dense_plain, "ar_dense_kernel",
                  cs.k2_bound),
           "K1": (kernels.agent_road_hits_tiled,
                  kernels.agent_road_hits_tiled_plain, "ar_tiled_kernel",
                  cs.k1_bound)}
    bounds = {(name, key): fns[key][3](kernels, *inp[key])
              for name, inp in inputs.items() for key in ("K2", "K1")
              if key in inp}
    checked, readings = set(), {}
    # pass 1: checks and wrapper times, no profiler session yet
    for run, label in enumerate(order):
        cuda_build.use("agent_road", libs[label])
        for name, inp in inputs.items():
            outs = {}
            for key in ("K2", "K1"):
                if key not in inp:
                    continue
                wrapper, plain, kernel, _ = fns[key]
                args_k = inp[key]
                outs[key] = got = wrapper(*args_k)
                if (label, name, key) not in checked:
                    again = wrapper(*args_k)
                    n = 16 if name == "large_map" else got.shape[0]
                    want = plain(*(t[:n] for t in args_k))
                    cs.check(torch.equal(got, again),
                             f"{label} {name} {key}: two launches differ")
                    cs.check(torch.equal(got[:n], want),
                             f"{label} {name} {key}: differs from plain")
                    checked.add((label, name, key))
                bms, by, ops = bounds[(name, key)]
                readings[(run, name, key)] = dict(
                    run=run + 1, source=label, input=name, kernel=key,
                    wrapper_ms=cs.time_ms(lambda: wrapper(*args_k),
                                          args.reps),
                    bound_ms=bms, bound_by=by, operations=ops)
            if "K1" in outs:
                cs.check(torch.equal(torch.gather(outs["K1"], 1,
                                                  inp["inv_perm"]),
                                     outs["K2"]),
                         f"{label} {name}: K1 differs from K2")
    # pass 2: device times under torch.profiler
    for run, label in enumerate(order):
        cuda_build.use("agent_road", libs[label])
        for name, inp in inputs.items():
            for key in ("K2", "K1"):
                if key not in inp:
                    continue
                wrapper, _, kernel, _ = fns[key]
                r = readings[(run, name, key)]
                r["ms"] = kernel_time_ms(lambda: wrapper(*inp[key]),
                                         args.reps, kernel)
                print(f"[run {run + 1} {label}] {name} {key}: device "
                      f"{r['ms']:.5f} ms, wrapper {r['wrapper_ms']:.5f} ms, "
                      f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    line = json.dumps(dict(card=card, reps=args.reps,
                           sources={k: os.path.relpath(v, ROOT)
                                    for k, v in sources.items()},
                           readings=list(readings.values())))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Time the slice's policy rollout of one tree of the port.

Builds the slice's env and policy (``gpudrive_lab_torch.rollout.slice_env``
and ``slice_policy`` over the 512 worlds of data/pool_v3, as chip_smoke.py's
phase 3 does) from the package under ``--root`` (default: this
repository), runs one warm-up rollout, then ``--repeats`` rollouts of
``--steps`` steps from a reset, and prints the card's name and power limit
and, for each rollout, its wall ms per step and agent-steps/s (steps x
created agents / wall time).  To compare two trees on one card, run each
in its own process, in turns:

    python3 scripts/time_rollout.py --root parent_tree --label parent
    python3 scripts/time_rollout.py --label change

Needs one NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=ROOT,
                   help="tree whose gpudrive_lab_torch is timed")
    p.add_argument("--label", default="tree")
    p.add_argument("--steps", type=int, default=91)
    p.add_argument("--repeats", type=int, default=3)
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("time_rollout: CUDA is not available", file=sys.stderr)
        return 2
    from gpudrive_lab_torch.rollout import (
        pool_scene_paths,
        rollout,
        slice_env,
        slice_policy,
    )

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    env = slice_env(pool_scene_paths(ROOT), device=dev)
    policy = slice_policy(device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    n_agents = int(env.scene.num_agents.sum())
    rollout(env, policy, 2, gen)  # warm-up
    for i in range(args.repeats):
        env.reset()
        torch.cuda.synchronize()
        t0 = time.time()
        rollout(env, policy, args.steps, gen)
        torch.cuda.synchronize()
        wall = time.time() - t0
        print(f"{args.label} run {i}: {wall * 1e3 / args.steps:.3f} ms/step "
              f"wall, agent-steps/s {args.steps * n_agents / wall:.1f} "
              f"({env.num_worlds} worlds, {n_agents} created agents)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

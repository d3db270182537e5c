"""SB3-stack training-throughput bench (port of ``scripts/bench_sb3.py``).

Measures the masked-rollout-buffer IPPO stack (``env/wrappers/
sb3_learner.py`` over ``sb3_wrapper.py``) end to end, the counterpart of
the reference's SB3 integration row ("Training SPS 25-50K", reference:
README.md:175-177), and prints bench.py's one-line JSON schema.

This stack dispatches act and step per env step from Python (its design,
as the reference's SB3 loop), and every step reads the dead-agent count
back to the host, so the wall clock around a window measures finished
work.  The first learn window is discarded (warm-up); ``--windows``
further windows are timed.  SPS counts VALID (live controlled-agent)
samples, the filtering the reference's MaskedRolloutBuffer applies.  Runs
on the card unless ``--device cpu`` asks for the CPU.  Kernels: K2 on
every env step.

    python -m gpudrive_lab_torch.bench_sb3 --scenes-dir data/pool_v3
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.dataset import SceneDataLoader
from gpudrive_lab_torch.env.wrappers.sb3_learner import IPPO, IPPOConfig
from gpudrive_lab_torch.env.wrappers.sb3_wrapper import SB3MultiAgentEnv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> dict:
    """Run the bench; prints the details line and the result line, and
    returns the result with the details under "meta"."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--worlds", type=int, default=32)
    p.add_argument("--scenes-dir",
                   default=os.path.join(ROOT, "data", "processed",
                                        "examples"),
                   help="directory of tfrecord*.json scenes (default: the "
                        "reference's data/processed/examples under the "
                        "repository)")
    p.add_argument("--n-steps", type=int, default=91,
                   help="rollout length (reference sb3 default: one episode)")
    p.add_argument("--n-epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--windows", type=int, default=2,
                   help="timed learn windows after the warm-up window")
    p.add_argument("--device", "--platform", dest="device", default=None,
                   help="torch device or JAX platform name; CUDA "
                        "unless another is named (cpu for the CPU); the run "
                        "fails without CUDA otherwise")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    loader = SceneDataLoader(
        root=args.scenes_dir, batch_size=args.worlds,
        dataset_size=max(args.worlds, 4),
    )
    env = SB3MultiAgentEnv(EnvConfig(num_worlds=args.worlds), loader,
                           device=device)
    learner = IPPO(env, IPPOConfig(
        n_steps=args.n_steps, batch_size=args.batch_size,
        n_epochs=args.n_epochs,
    ))

    # window 0: warm-up (allocator, cuBLAS handles, the kernels' build)
    learner.collect_rollouts()
    learner.train()
    start_steps = learner.num_timesteps

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    window_metrics = []
    for _ in range(args.windows):
        learner.collect_rollouts()
        window_metrics.append(learner.train())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.time() - t0
    samples = learner.num_timesteps - start_steps
    sps = samples / elapsed

    meta = {
        "mode": "sb3_ippo_train",
        "worlds": args.worlds,
        "num_envs": env.num_envs,
        "n_steps": args.n_steps,
        "windows": args.windows,
        "valid_samples": samples,
        "elapsed_s": round(elapsed, 3),
        "backend": "gpu" if device.type == "cuda" else "cpu",
        "v_loss": round(window_metrics[-1].get("v_loss", float("nan")), 4),
    }
    # reference SB3 band midpoint (37.5K SPS) as the comparison point
    result = {
        "metric": "sb3_train_sps",
        "value": round(sps, 1),
        "unit": "valid-agent-steps/s",
        "vs_baseline": round(sps / 37500.0, 4),
    }
    print(json.dumps(meta))
    print(json.dumps(result), flush=True)
    return dict(result, meta=meta)


if __name__ == "__main__":
    main()

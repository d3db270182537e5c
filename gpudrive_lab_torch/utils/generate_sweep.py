"""Hyperparameter-sweep launcher generation (port of
``gpudrive_lab_tpu/utils/generate_sweep.py``).

Mirror of the reference's SLURM sweep generator
(reference: gpudrive/utils/generate_sbatch.py, 304 LoC of sbatch templating):
expands a grid of dotted config overrides into launch scripts — either SLURM
sbatch files or plain shell scripts for a fleet of machines."""

from __future__ import annotations

import argparse
import itertools
import json
from pathlib import Path

SBATCH_TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --output={log_dir}/{name}_%j.out
#SBATCH --time={time}
{extra}
{command}
"""

SHELL_TEMPLATE = """#!/bin/bash
# sweep job {name}
set -e
{command}
"""


def expand_grid(grid: dict) -> list[dict]:
    keys = sorted(grid)
    return [
        dict(zip(keys, combo))
        for combo in itertools.product(*(grid[k] for k in keys))
    ]


def generate_sweep(
    base_command: str,
    grid: dict,
    out_dir: str,
    backend: str = "shell",
    time_limit: str = "24:00:00",
    extra_sbatch: str = "",
) -> list[Path]:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = []
    for i, combo in enumerate(expand_grid(grid)):
        overrides = " ".join(f"{k}={json.dumps(v)}" for k, v in combo.items())
        name = f"sweep_{i:03d}"
        command = f"{base_command} {overrides}"
        if backend == "sbatch":
            text = SBATCH_TEMPLATE.format(
                name=name, log_dir=str(out), time=time_limit,
                extra=extra_sbatch, command=command,
            )
        else:
            text = SHELL_TEMPLATE.format(name=name, command=command)
        p = out / f"{name}.sh"
        p.write_text(text)
        p.chmod(0o755)
        paths.append(p)
    return paths


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--base-command",
                   default="python -m gpudrive_lab_torch.ppo.train")
    p.add_argument("--grid", required=True,
                   help='JSON, e.g. {"--rollout-len": [16, 32]}')
    p.add_argument("--out-dir", default="sweeps")
    p.add_argument("--backend", choices=["shell", "sbatch"], default="shell")
    args = p.parse_args()
    paths = generate_sweep(
        args.base_command, json.loads(args.grid), args.out_dir, args.backend
    )
    print(f"wrote {len(paths)} scripts to {args.out_dir}")


if __name__ == "__main__":
    main()

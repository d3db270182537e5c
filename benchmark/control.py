"""Readings for the limits of the correctness check, on the chip.

    python3 benchmark/control.py --workload <cell> --seconds <s> \\
        --seeds <n> <n> ... [--program | --fault <name>] [--out x.jsonl]

For each seed, in one process, runs the cell through its driver with the
timed path replaced by its control (``gdbench/control.py``: the plain
reference in the precision below the configuration's), or with
``--program`` the program itself, or with ``--fault`` the program with a
fault planted under the timed path (``gdbench/faults.py``), and prints
the numbers the check compares as one JSON line per seed.  A limit lies
above every sound run's reading and below the control's and, in a
training cell, below the faults'.  The benchmark's own runs never run a
control or a fault.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T0 = time.perf_counter()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def readings(cell, seed: int, seconds: float, side: str):
    """The check's numbers of one run of ``cell`` (limits ignored):
    ``side`` is "program", "control" or the name of a fault."""
    import contextlib

    from gdbench import common, registry

    driver = registry.load_driver(cell.config["driver"])
    device = common.first_card()
    if side == "program":
        ctx = contextlib.nullcontext()
    elif side == "control":
        ctx = driver.control(cell, device, seed)
    else:
        ctx = driver.faults()[side]()
    with ctx:
        res = driver.run(cell, seed, seconds, False,
                         lambda: time.perf_counter() - T0)
    return {k: v for k, (v, _) in res.checks.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--program", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [BENCH_DIR, ROOT]
    import torch

    from gdbench import common, registry

    cell = registry.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    common.use_cache_dirs()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed in args.seeds:
        side = ("program" if args.program else args.fault or "control")
        rec = {"workload": args.workload, "seed": seed, "side": side}
        try:
            rec["readings"] = readings(cell, seed, args.seconds, side)
        except Exception as e:  # a control that crashes has failed
            rec["error"] = f"{type(e).__name__}: {e}"
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

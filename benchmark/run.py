"""Run one cell of the benchmark of gpudrive_lab_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for.  The cell's configuration, traffic and limits are found by
the names ``BENCHMARK.json`` gives them (``gdbench/registry.py``).  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number the
correctness check compared, with its limit.  The last lines of standard
error repeat the checks.

Exits non-zero with no result line when CUDA or enough cards are missing,
and when JAX or the JAX package (compared by whole top-level module names)
is loaded once the run is over.
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


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(cell, seed: int, seconds: float, traced: bool, clock,
            device=None) -> dict:
    """Run ``cell`` through the driver its configuration names and return
    the result object (without the chip look, which ``main`` does first).
    The driver sets up its devices; ``device`` overrides that (the CPU
    tests)."""
    import torch

    from gdbench import common, registry

    # the reference's float32 products stay float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = registry.load_driver(cell.config["driver"])
    res = driver.run(cell, seed, seconds, traced, clock, device)
    if traced:
        metrics = registry.read_metrics(cell.per_layer, res.ctx)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": float(v), "unit": units[k]}
                   for k, v in res.end_to_end.items() if k in units}
    dev = common.device_description(res.device, cell.chips)
    dev["memory_peak_bytes"] = int(res.memory_peak_bytes)
    out = {"correct": res.correct, "attempted": res.attempted,
           "failed": res.failed, "metrics": metrics, "device": dev}
    if traced and res.trace is not None:
        dev["busy_s"] = res.trace.busy_s
        dev["window_s"] = res.trace.window_s
        out["breakdown"] = res.trace.breakdown()
    out["checks"] = {k: {"value": float(v), "limit": float(lim)}
                     for k, (v, lim) in res.checks.items()}
    common.log("set-up parts (s): " + json.dumps(res.setup_parts))
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path[:0] = [BENCH_DIR, ROOT]
    import torch

    from gdbench import common, guard, registry

    # one host thread for torch's CPU ops: the timed loops are launch-bound
    # on the host, and idle worker threads compete with them for its cores
    torch.set_num_threads(1)

    cell = registry.find_cell(args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"needs {cell.chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    common.use_cache_dirs()
    out = execute(cell, args.seed, args.seconds, bool(args.trace),
                  lambda: time.perf_counter() - T0)
    common.log(f"card: {common.power_limit()}")
    bad = guard.forbidden_modules(sys.modules)
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

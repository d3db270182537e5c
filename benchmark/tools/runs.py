"""Run cells of the benchmark several times in one call, each run in a
process of its own, and keep every run's result.

    python3 benchmark/tools/runs.py --out chiprun_out/sets.jsonl \\
        --run sim_pool512:101:10:0 --run sim_pool512:102:10:1 ...

Each ``--run`` is workload:seed:seconds:trace.  Every run's result line
(or its failure), exit code and wall time are appended to ``--out`` as one
JSON line; each run's standard error goes to ``<out>.<n>.err``.  Used to
measure spreads, limits and predictions; the benchmark's own runs do not
use it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--run", action="append", default=[])
    p.add_argument("--timeout", type=float, default=1300)
    args = p.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for n, spec in enumerate(args.run):
        workload, seed, seconds, trace = spec.split(":")
        cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"),
               "--workload", workload, "--seed", seed, "--seconds", seconds,
               "--trace", trace]
        t = time.perf_counter()
        err_path = Path(f"{out}.{n}.err")
        try:
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                                  text=True, timeout=args.timeout)
            rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, stdout = 124, e.stdout or ""
            stderr = (e.stderr or "") if isinstance(e.stderr, str) else ""
        err_path.write_text(stderr)
        lines = stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        rec = {"n": n, "workload": workload, "seed": int(seed),
               "seconds": float(seconds), "trace": int(trace), "rc": rc,
               "wall_s": time.perf_counter() - t, "result": result,
               "stderr_tail": stderr[-1500:]}
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        summary = (result or {}).get("metrics")
        print(f"[runs] {spec}: rc {rc}, {rec['wall_s']:.1f} s, correct "
              f"{(result or {}).get('correct')}, {summary}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run phases of chip_smoke.py alone, on one NVIDIA GPU.

    python3 scripts/chip_phases.py [il] [rnn] [vbd] [periphery]

With no argument it runs the il, rnn, vbd and periphery phases, in that
order.
Prints the card's name and power limit, the Python, torch and CUDA
versions, each phase's lines and its wall time, and last the launch counts
of the phases as one JSON line.  Exits non-zero when a check of a phase
fails.  A quicker call than the whole chip_smoke.py when only these paths
changed; its numbers differ from chip_smoke.py's, where the phases follow
a torch.profiler session (after one, each launch costs the host more).
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs

    phases = {"il": cs.il_phase, "rnn": cs.rnn_phase, "vbd": cs.vbd_phase,
              "periphery": cs.periphery_phase}
    names = sys.argv[1:] or list(phases)
    unknown = [n for n in names if n not in phases]
    if unknown:
        print(f"chip_phases: unknown phases {unknown}; choose from "
              f"{list(phases)}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_phases: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(sys.version.split()[0], torch.__version__, torch.version.cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    launches = {}
    try:
        for name in names:
            t0 = time.time()
            launches[name] = phases[name](ROOT, dev)["launches"]
            print(f"{name} phase {time.time() - t0:.1f} s")
    except cs.CheckFailed as e:
        print(f"chip_phases: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(launches))
    return 0


if __name__ == "__main__":
    sys.exit(main())

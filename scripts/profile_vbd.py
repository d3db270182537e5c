#!/usr/bin/env python3
"""Device-time breakdown of the official VBD model at full width, on one
NVIDIA GPU.

    python3 scripts/profile_vbd.py [--worlds 64] [--top 12]

Builds the sample batch of the first ``--worlds`` pool_v3 worlds, an
OfficialVBD with OfficialVBDConfig() (6 layers, 256 wide, 8 heads, 32
agents) and seeded random weights, warms it up, then traces one encode and
one denoise step under torch.profiler (TF32 off, as chip_smoke.py runs
it).  Prints the card's name and power limit, each range's wall and device
time, and its ``--top`` device activities by time.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    from torch.profiler import record_function

    from gpudrive_lab_torch.core import step as stepmod
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.rollout import SLICE_CONFIG, pool_scene_paths
    from gpudrive_lab_torch.scene.compiler import build_scene
    from gpudrive_lab_torch.utils.profiling import (
        device_breakdown,
        device_trace,
    )
    from gpudrive_lab_torch.vbd import model_official as vofficial
    from gpudrive_lab_torch.vbd.data_utils import (
        official_inputs,
        process_scenario_data,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds", type=int, default=64)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_vbd: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    params = EnvConfig(**SLICE_CONFIG).sim_params()
    scene = build_scene(pool_scene_paths(ROOT)[:args.worlds], params,
                        device=dev)
    state = stepmod.reset(scene, None, params)
    cfg = vofficial.OfficialVBDConfig()
    inputs = official_inputs(process_scenario_data(scene, state, 0))
    model = vofficial.OfficialVBD(
        cfg, device=dev, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn((args.worlds, cfg.agents_len, cfg.seq_len, 2),
                    device=dev, generator=torch.Generator(dev).manual_seed(0))
    t = torch.full((args.worlds, cfg.agents_len), cfg.diffusion_steps - 1,
                   device=dev)

    def run():
        with torch.no_grad():
            with record_function("encode"):
                enc = model.encode(inputs)
            with record_function("denoise"):
                model.denoise(enc, x, t)

    run()  # warm-up: allocator, cuBLAS handles, lazy module loading
    torch.cuda.synchronize()
    with device_trace() as prof:
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    busy, by_name, by_range = device_breakdown(prof, ("encode", "denoise"))
    print(f"{args.worlds} worlds: wall {wall:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms; device " + ", ".join(
              f"{r} {us / 1e3:.1f} ms" for r, us in by_range.items()))
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:args.top]:
        print(f"{us / 1e3:10.2f} ms {n:5d}x  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

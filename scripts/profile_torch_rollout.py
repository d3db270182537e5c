"""Device-time breakdown of the port's policy rollout (gpudrive_lab_torch).

Builds the slice's env and policy with the helpers that chip_smoke.py uses
(gpudrive_lab_torch.rollout.slice_env and slice_policy: the 512 worlds of
data/pool_v3, 128 agent rows, road bucket 256, KNN road obs, a
LateFusionPolicy with fused_embed), warms up,
then traces a few rollout steps with torch.profiler and prints:

  * the card's name and power limit;
  * wall ms per step, and device busy ms per step (the sum of kernel
    times; busy share = busy / wall);
  * device and host ms per step of each phase (obs, policy, step,
    rewards, reset: the kernels launched inside each phase's
    record_function range, and the host's time inside it; with
    --sensors also lidar, bev and camera, each output reduced to a sum as
    the rollout's sensor option does);
  * the device activities with the most time, and with --sensors those of
    each sensor.

Run on a machine with one NVIDIA GPU, from the repository root:

    python3 scripts/profile_torch_rollout.py [--steps 5] [--worlds 512]
        [--sensors]

The chrome trace is written to runs/profile/rollout_trace.json.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _device_kernels(event):
    """The kernels (name, device, duration in us) launched under ``event``
    (a CPU range), its nested operators included."""
    out, todo = [], [event]
    while todo:
        e = todo.pop()
        out += e.kernels
        todo += e.cpu_children
    return out


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpudrive_lab_torch.networks.late_fusion import sample_logits
    from gpudrive_lab_torch.rollout import (
        pool_scene_paths,
        rollout,
        slice_env,
        slice_policy,
    )

    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--worlds", type=int, default=512)
    p.add_argument("--sensors", action="store_true",
                   help="also collect lidar, BEV and camera every step")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_rollout: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())

    env = slice_env(pool_scene_paths(ROOT)[: args.worlds], device=dev)
    policy = slice_policy(device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    W, A = env.num_worlds, env.max_agent_count
    rollout(env, policy, 1 if args.sensors else 3, gen,
            sensors=args.sensors)  # warm-up
    torch.cuda.synchronize()
    sensors = ("lidar", "bev", "camera") if args.sensors else ()

    def phase_step():
        with record_function("obs"):
            obs = env.get_obs()
        with record_function("policy"), torch.no_grad():
            logits, _ = policy(obs.reshape(W * A, -1))
            action, _, _ = sample_logits(gen, logits)
        with record_function("step"):
            act = env.action_values(action.reshape(W, A))
            env.step_dynamics(act)
        with record_function("rewards"):
            env.get_rewards()
            env.get_dones()
        if sensors:
            with record_function("lidar"):
                env.get_lidar_obs(act)[..., 0].sum()
            with record_function("bev"):
                env.get_bev_obs().sum()
            with record_function("camera"):
                rgb, depth = env.get_camera_obs()
                depth.sum() + rgb[..., 0].sum(dtype=torch.float32)
        with record_function("reset"):
            env.reset_worlds(env.world_done())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(args.steps):
            phase_step()
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3 / args.steps

    phases = ("obs", "policy", "step", "rewards", "reset") + sensors
    events = prof.events()
    # Device activity (kernels, copies, sets), without the device-side
    # copies of the phase annotations.
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name not in phases]
    busy = sum(e.time_range.elapsed_us() for e in device)
    by_kernel = defaultdict(lambda: [0.0, 0])
    for e in device:
        k = by_kernel[e.name[:100]]
        k[0] += e.time_range.elapsed_us()
        k[1] += 1
    # Per phase: the device time of every kernel launched inside the
    # phase's record_function range (its nested ops included).
    ranges = [e for e in events
              if e.name in phases
              and e.device_type == torch.autograd.DeviceType.CPU]
    by_phase = {p: sum(e.device_time_total for e in ranges if e.name == p)
                for p in phases}
    # host time inside each range: Python, dispatch, launches and any wait
    # for the device (a synchronizing call)
    host_phase = {p: sum(e.cpu_time_total for e in ranges if e.name == p)
                  for p in phases}
    n = args.steps
    print(f"worlds {W} rows {W * A} steps {n}: wall {wall:.3f} ms/step, "
          f"device busy {busy / 1e3 / n:.3f} ms/step "
          f"(busy share {busy / 1e3 / n / wall:.3f}), "
          f"{len(device) / n:.0f} device activities/step")
    for phase, us in by_phase.items():
        print(f"  phase {phase:8s} {us / 1e3 / n:8.3f} ms/step device, "
              f"{host_phase[phase] / 1e3 / n:8.3f} ms/step host")
    print("top device activities (ms/step, count/step, name):")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:25]
    for name, (us, cnt) in top:
        print(f"  {us / 1e3 / n:8.3f} {cnt / n:6.1f}  {name}")
    for phase in sensors:
        # the kernels launched inside the sensor's range
        kern = defaultdict(lambda: [0.0, 0])
        cpu = torch.autograd.DeviceType.CPU
        for e in events:
            if e.name != phase or e.device_type != cpu:
                continue
            for k in _device_kernels(e):
                kern[k.name[:100]][0] += k.duration
                kern[k.name[:100]][1] += 1
        launches = sum(c for _, c in kern.values())
        print(f"{phase}: {launches / n:.0f} device activities/step; top:")
        for name, (us, cnt) in sorted(kern.items(),
                                      key=lambda kv: -kv[1][0])[:8]:
            print(f"  {us / 1e3 / n:8.3f} {cnt / n:6.1f}  {name}")
    out = os.path.join(ROOT, "runs", "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "rollout_trace.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())

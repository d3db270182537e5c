#!/usr/bin/env python3
"""Time versions of K3-bf16 and K4-bf16 (the bf16 compute mode of the fused
embed + max-pool kernels) against each other.

Builds each given source of the forward (``--fwd label=path``: any file
with the C entry point ``fused_embed_pool_fwd_bf16``, such as the package's
``csrc/fused_embed_bf16.cu`` or an older ``fused_embed.cu`` unpacked from
git) and of the backward (``--bwd label=path``: ``fused_embed_pool_bwd_bf16``
and ``fused_embed_pool_bwd_blocks_bf16``) with the package's nvcc flags,
then, in the order given, puts each label's pair behind the wrappers of
``gpudrive_lab_torch/networks/fused_embed.py`` (``cuda_build.use``) and
times them on the same inputs: the observations of the 512 ``data/pool_v3``
worlds through the slice policy's weights (seed 0), as

  * K3-bf16 on the partner [., 127, 6] and road [., 200, 13] blocks of the
    controlled agents' rows of 9 random steps (a bf16 training minibatch:
    35,328 rows; a PPO rollout step: 4,416 rows), x in bfloat16 and float32,
    and on all 65,536 agent rows of one step, x in float32 (the rollout);
  * K4-bf16 on the same 35,328 rows, bfloat16 and float32 x, with the plain
    bf16 forward's argmax and a seeded random pooled cotangent.

Each reading is the mean over ``--reps`` launches of both blocks (CUDA
events, after 2 warm-up launches), with the version's largest difference
from the first version's outputs.  Prints one line per reading and one JSON
line with all of them; ``--out`` also writes it to a file.  Needs an NVIDIA
GPU and nvcc.  Parent against change, in turns:

    python3 scripts/time_embed_bf16.py \\
        --fwd parent=old/fused_embed.cu --bwd parent=old/fused_embed_bwd.cu \\
        --fwd new=gpudrive_lab_torch/csrc/fused_embed_bf16.cu \\
        --bwd new=gpudrive_lab_torch/csrc/fused_embed_bwd_bf16.cu \\
        --order parent,new,new,parent
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MINIBATCH, ROLLOUT_STEP = 35328, 4416


def libraries(fwd: str, bwd: str):
    """The two libraries of one version, their entry points declared."""
    from gpudrive_lab_torch import cuda_build
    from gpudrive_lab_torch.networks.fused_embed import declare

    lf, _ = cuda_build.load_source("fused_embed_bf16", fwd)
    declare(lf, ["fused_embed_pool_fwd_bf16"])
    lb, _ = cuda_build.load_source("fused_embed_bwd_bf16", bwd)
    declare(lb, ["fused_embed_pool_bwd_bf16",
                 "fused_embed_pool_bwd_blocks_bf16"])
    return lf, lb


def inputs(dev):
    """{block: (weights, x of the controlled rows, x of all rows)}."""
    import torch

    from gpudrive_lab_torch.rollout import (
        pool_scene_paths, slice_env, slice_policy)

    env = slice_env(pool_scene_paths(ROOT), device=dev)
    policy = slice_policy(device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    ctrl = env.scene.agents.controlled.bool()
    rows, every = [], None
    while sum(r.shape[0] for r in rows) < MINIBATCH:
        env.step_dynamics(torch.randint(
            0, env.action_space_n, (env.num_worlds, env.max_agent_count),
            generator=gen, device=dev))
        obs = env.get_obs()
        every = obs.reshape(-1, obs.shape[-1])
        rows.append(obs[ctrl])
    ctl = torch.cat(rows)[:MINIBATCH].contiguous()
    out = {}
    for name, emb, sl, shape in (
            ("partner", policy.partner_embed, slice(6, 768), (127, 6)),
            ("road", policy.road_map_embed, slice(768, 3368), (200, 13))):
        lin1, ln, _, _, lin2 = emb
        w = tuple(t.detach().contiguous() for t in (
            lin1.weight.t(), lin1.bias, ln.weight, ln.bias, lin2.weight.t(),
            lin2.bias))
        out[name] = (w, ctl[:, sl].unflatten(-1, shape),
                     every[:, sl].unflatten(-1, shape))
    return out


def time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    from gpudrive_lab_torch import cuda_build
    from gpudrive_lab_torch.networks import fused_embed as fe

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fwd", action="append", default=[],
                    help="label=path of a K3-bf16 source (repeatable)")
    ap.add_argument("--bwd", action="append", default=[],
                    help="label=path of a K4-bf16 source (repeatable)")
    ap.add_argument("--order", default=None,
                    help="comma-separated labels, repeats allowed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_embed_bf16: CUDA is not available", file=sys.stderr)
        return 2
    fwd = dict(s.split("=", 1) for s in args.fwd)
    bwd = dict(s.split("=", 1) for s in args.bwd)
    if not fwd or set(fwd) != set(bwd):
        print("time_embed_bf16: give --fwd and --bwd for the same labels",
              file=sys.stderr)
        return 2
    order = args.order.split(",") if args.order else list(fwd)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {card.strip()}")
    dev = torch.device("cuda")
    libs = {label: libraries(fwd[label], bwd[label]) for label in fwd}
    data = inputs(dev)
    bf = torch.bfloat16
    cases = []
    for name, (w, ctl, every) in data.items():
        for dt in (bf, torch.float32):
            for rows in (MINIBATCH, ROLLOUT_STEP):
                cases.append(("K3-bf16", name, ctl[:rows].to(dt), w, None))
        cases.append(("K3-bf16", name, every.float(), w, None))
        _, arg = fe.reference_embed_pool_argmax(ctl, *w, "tanh", bf)
        dpool = torch.randn(arg.shape, device=dev,
                            generator=torch.Generator(dev).manual_seed(1))
        for dt in (bf, torch.float32):
            cases.append(("K4-bf16", name, ctl.to(dt), w, (arg, dpool)))
    del data

    def run(kernel, x, w, extra):
        if kernel == "K3-bf16":
            return fe.fused_embed_pool_fwd(x, *w, "tanh", bf)
        return fe.fused_embed_pool_bwd(x, *w, *extra, "tanh", bf)

    readings, first = [], {}
    for i, label in enumerate(order):
        lf, lb = libs[label]
        cuda_build.use("fused_embed_bf16", lf)
        cuda_build.use("fused_embed_bwd_bf16", lb)
        per = {}
        for kernel, name, x, w, extra in cases:
            key = (kernel, x.shape[0], str(x.dtype)[6:])
            outs = [t.float() for t in run(kernel, x, w, extra)]
            ref = first.setdefault((key, name), outs)
            diff = max(float((a - b).abs().max()) for a, b in zip(outs, ref))
            ms = time_ms(lambda: run(kernel, x, w, extra), args.reps)
            rec = per.setdefault(key, dict(ms=0.0, diff=0.0))
            rec["ms"] += ms
            rec["diff"] = max(rec["diff"], diff)
        for (kernel, rows, dtype), rec in per.items():
            print(f"[{label} run {i}] {kernel} partner + road, {rows} rows, "
                  f"{dtype} x: {rec['ms']:.4f} ms (max abs diff from the "
                  f"first run {rec['diff']:.3g})")
            readings.append(dict(label=label, run=i, kernel=kernel, rows=rows,
                                 x=dtype, ms=rec["ms"], diff=rec["diff"]))
    line = json.dumps({"card": card.strip(), "readings": readings})
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

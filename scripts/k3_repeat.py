#!/usr/bin/env python3
"""Launch kernel K3, and K3-bf16, many times on one input and count what
goes wrong.

Builds a K3 source (default: the package's ``csrc/fused_embed.cu``; any
file with the same C entry point ``fused_embed_pool_fwd``, such as an older
version unpacked from git) and a K3-bf16 source (``--bf16-source``, default
``csrc/fused_embed_bf16.cu``, entry point ``fused_embed_pool_fwd_bf16``)
with nvcc, then launches each ``--reps`` times on the input of
``tests/test_torch_cuda.py::test_fused_embed_kernel_matches_plain``
(``--case B,E,F``, tanh; K3-bf16 on the same x stored in bf16) and holds
every launch to the card tests' bars against the plain version: K3 pooled
max abs error <= 1e-4 and the argmax equal where the top two values differ
by more than 1e-5; K3-bf16 pooled error within 4 bf16 flips of t
(``fused_embed.bf16_flip_bound``), at most 1% of entries beyond 1e-5, and
the argmax equal where the top two differ by more than twice that bar.
Half the launches reuse one set of device buffers, half allocate new ones
each time.  Prints, per kernel, one JSON line with the number of failures,
of launches whose bits differ from the first launch's and the largest
error seen; for K3 also how far the plain version moves when recomputed
and how far it and the kernel are from a float64 evaluation.  Needs an
NVIDIA GPU and nvcc:

    python3 scripts/k3_repeat.py --reps 400 [--source path/to/fused_embed.cu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CSRC = os.path.join(ROOT, "gpudrive_lab_torch", "csrc")


def build(name: str, source: str, entry: str):
    from gpudrive_lab_torch import cuda_build
    from gpudrive_lab_torch.networks.fused_embed import declare

    lib, _ = cuda_build.load_source(name, source)
    declare(lib, [entry])
    return getattr(lib, entry)


def repeat(launch, x, w, reps, want, y, bar, loose_bar, arg_gap):
    """Launch reps times (fresh buffers for the second half); the failures
    against the bars, the launches whose bits differ from the first, the
    largest error and the first failure."""
    import torch

    top2 = y.topk(2, dim=1)
    clear = (top2.values[:, 0] - top2.values[:, 1]) > arg_gap
    dev = torch.device("cuda")
    xd, wd = x.to(dev), [t.to(dev) for t in w]
    first = None
    fails, differ, worst, first_fail = 0, 0, 0.0, None
    for rep in range(reps):
        if rep >= reps // 2:  # fresh buffers at other addresses
            xd, wd = x.to(dev), [t.to(dev) for t in w]
        pooled, arg = launch(xd, wd)
        torch.cuda.synchronize()
        pooled, arg = pooled.cpu(), arg.cpu()
        diff = (pooled - want).abs()
        err = float(diff.max())
        loose = float((diff > 1e-5).float().mean())
        arg_ok = torch.equal(arg.long()[clear], top2.indices[:, 0][clear])
        worst = max(worst, err)
        if first is None:
            first = (pooled, arg)
        elif not (torch.equal(pooled, first[0]) and torch.equal(arg, first[1])):
            differ += 1
        if err > bar or loose > loose_bar or not arg_ok:
            fails += 1
            if first_fail is None:
                first_fail = dict(rep=rep, err=err, loose=loose,
                                  argmax_ok=arg_ok)
    return dict(reps=reps, failures=fails, bits_differ_from_first=differ,
                max_abs_err=worst, bar=bar, first_failure=first_fail), first


def main() -> int:
    import torch

    from gpudrive_lab_torch.networks import fused_embed as fe

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=os.path.join(CSRC, "fused_embed.cu"))
    ap.add_argument("--bf16-source",
                    default=os.path.join(CSRC, "fused_embed_bf16.cu"))
    ap.add_argument("--reps", type=int, default=400)
    ap.add_argument("--case", default="37,127,6")
    ap.add_argument("--reference-repeats", type=int, default=20,
                    help="times the plain version is recomputed on the CPU")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_repeat: CUDA is not available", file=sys.stderr)
        return 2
    B, E, F = (int(v) for v in args.case.split(","))
    fwd = build("fused_embed", args.source, "fused_embed_pool_fwd")
    fwd_bf16 = build("fused_embed_bf16", args.bf16_source,
                     "fused_embed_pool_fwd_bf16")

    # the test's input: the same generator, seed and draw order
    g = torch.Generator().manual_seed(B + E)
    x = torch.randn(B, E, F, generator=g)
    w = [torch.randn(F, 64, generator=g) * 0.3,
         torch.randn(64, generator=g) * 0.1,
         1 + 0.1 * torch.randn(64, generator=g),
         torch.randn(64, generator=g) * 0.1,
         torch.randn(64, 64, generator=g) * 0.2,
         torch.randn(64, generator=g) * 0.1]
    dev = torch.device("cuda")

    def launcher(entry, *mode):
        def launch(xd, wd):
            out = torch.empty((B, 64), device=dev)
            amax = torch.empty((B, 64), dtype=torch.int32, device=dev)
            status = entry(
                xd.data_ptr(), *[t.data_ptr() for t in wd], out.data_ptr(),
                amax.data_ptr(), B, E, F, xd.stride(0), *mode, 0,
                torch.cuda.current_stream().cuda_stream)
            if status != 0:
                raise RuntimeError(f"launch: CUDA error {status}")
            return out, amax
        return launch

    want, _ = fe.reference_embed_pool_argmax(x, *w, "tanh")
    report, first = repeat(launcher(fwd), x, w, args.reps, want,
                           fe._embed(x, *w, "tanh"), 1e-4, 1.0, 1e-5)
    # the plain version itself: recomputed on the CPU, and in float64
    ref_spread = max(
        float((fe.reference_embed_pool_argmax(x, *w, "tanh")[0] - want)
              .abs().max()) for _ in range(args.reference_repeats))
    want64, _ = fe.reference_embed_pool_argmax(
        x.double(), *[t.double() for t in w], "tanh")
    print(json.dumps(dict(
        kernel="K3", source=os.path.relpath(args.source, ROOT), case=[B, E, F],
        **report, plain_recomputed_max_diff=ref_spread,
        plain_vs_float64=float((want.double() - want64).abs().max()),
        kernel_vs_float64=float((first[0].double() - want64).abs().max()),
        device=torch.cuda.get_device_name(0))))

    bf, xb = torch.bfloat16, x.to(torch.bfloat16)
    bar = 4 * fe.bf16_flip_bound("tanh", w[2], w[3], w[4])
    want, _ = fe.reference_embed_pool_argmax(xb, *w, "tanh", bf)
    report, _ = repeat(launcher(fwd_bf16, 1), xb, w, args.reps, want,
                       fe._embed(xb, *w, "tanh", bf), bar, 0.01, 2 * bar)
    print(json.dumps(dict(
        kernel="K3-bf16", source=os.path.relpath(args.bf16_source, ROOT),
        case=[B, E, F], **report, device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())

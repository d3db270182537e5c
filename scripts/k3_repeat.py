#!/usr/bin/env python3
"""Launch kernel K3 many times on one input and count what goes wrong.

Builds a K3 source (default: the package's ``csrc/fused_embed.cu``; any
file with the same C entry point ``fused_embed_pool_fwd``, such as an older
version unpacked from git) with nvcc, then launches it ``--reps`` times on
the input of ``tests/test_torch_cuda.py::test_fused_embed_kernel_matches_plain``
(``--case B,E,F``, tanh) and holds every launch to that test's bars against
the plain version: pooled max abs error <= 1e-4, argmax equal where the top
two values differ by more than 1e-5.  Half the launches reuse one set of
device buffers, half allocate new ones each time.  Prints the number of
failures, of launches whose bits differ from the first launch's, and the
largest error seen, then how far the plain version moves when recomputed
and how far it and the kernel are from a float64 evaluation.  Needs an
NVIDIA GPU and nvcc:

    python3 scripts/k3_repeat.py --reps 400 [--source path/to/fused_embed.cu]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(source: str) -> ctypes.CDLL:
    from gpudrive_lab_torch import cuda_build

    lib, _ = cuda_build.load_source("fused_embed", source)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.fused_embed_pool_fwd.argtypes = [p] * 9 + [i, i, i, ll, i, p]
    lib.fused_embed_pool_fwd.restype = i
    return lib


def main() -> int:
    import torch

    from gpudrive_lab_torch.networks import fused_embed as fe

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=os.path.join(
        ROOT, "gpudrive_lab_torch", "csrc", "fused_embed.cu"))
    ap.add_argument("--reps", type=int, default=400)
    ap.add_argument("--case", default="37,127,6")
    ap.add_argument("--reference-repeats", type=int, default=20,
                    help="times the plain version is recomputed on the CPU")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_repeat: CUDA is not available", file=sys.stderr)
        return 2
    B, E, F = (int(v) for v in args.case.split(","))
    lib = build(args.source)

    # the test's input: the same generator, seed and draw order
    g = torch.Generator().manual_seed(B + E)
    x = torch.randn(B, E, F, generator=g)
    w = [torch.randn(F, 64, generator=g) * 0.3,
         torch.randn(64, generator=g) * 0.1,
         1 + 0.1 * torch.randn(64, generator=g),
         torch.randn(64, generator=g) * 0.1,
         torch.randn(64, 64, generator=g) * 0.2,
         torch.randn(64, generator=g) * 0.1]
    want, _ = fe.reference_embed_pool_argmax(x, *w, "tanh")
    y = fe._embed(x, *w, "tanh")
    top2 = y.topk(2, dim=1)
    clear = (top2.values[:, 0] - top2.values[:, 1]) > 1e-5
    dev = torch.device("cuda")

    def launch(xd, wd):
        out = torch.empty((B, 64), device=dev)
        amax = torch.empty((B, 64), dtype=torch.int32, device=dev)
        status = lib.fused_embed_pool_fwd(
            xd.data_ptr(), *[t.data_ptr() for t in wd], out.data_ptr(),
            amax.data_ptr(), B, E, F, xd.stride(0), 0,
            torch.cuda.current_stream().cuda_stream)
        if status != 0:
            raise RuntimeError(f"launch: CUDA error {status}")
        return out, amax

    xd, wd = x.to(dev), [t.to(dev) for t in w]
    first = None
    fails, differ, worst, first_fail = 0, 0, 0.0, None
    for rep in range(args.reps):
        if rep >= args.reps // 2:  # fresh buffers at other addresses
            xd, wd = x.to(dev), [t.to(dev) for t in w]
        pooled, arg = launch(xd, wd)
        torch.cuda.synchronize()
        pooled, arg = pooled.cpu(), arg.cpu()
        err = float((pooled - want).abs().max())
        arg_ok = torch.equal(arg.long()[clear], top2.indices[:, 0][clear])
        worst = max(worst, err)
        if first is None:
            first = (pooled, arg)
        elif not (torch.equal(pooled, first[0]) and torch.equal(arg, first[1])):
            differ += 1
        if err > 1e-4 or not arg_ok:
            fails += 1
            if first_fail is None:
                first_fail = dict(rep=rep, err=err, argmax_ok=arg_ok)
    # the plain version itself: recomputed on the CPU, and in float64
    ref_spread = max(
        float((fe.reference_embed_pool_argmax(x, *w, "tanh")[0] - want)
              .abs().max()) for _ in range(args.reference_repeats))
    want64, _ = fe.reference_embed_pool_argmax(
        x.double(), *[t.double() for t in w], "tanh")
    print(json.dumps(dict(
        source=os.path.relpath(args.source, ROOT), case=[B, E, F],
        reps=args.reps, failures=fails, bits_differ_from_first=differ,
        max_abs_err=worst, first_failure=first_fail,
        plain_recomputed_max_diff=ref_spread,
        plain_vs_float64=float((want.double() - want64).abs().max()),
        kernel_vs_float64=float((first[0].double() - want64).abs().max()),
        device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())

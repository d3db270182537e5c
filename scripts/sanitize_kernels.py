#!/usr/bin/env python3
"""Run the port's CUDA kernels K1-K4 under compute-sanitizer.

With no arguments it launches each kernel once at the small shapes of
``tests/test_torch_cuda.py`` (K2 [3,128,256] and [2,37,33]; K1 [2,64,3
tiles of 256] with a random mask; K3 and K4 [37,127,6] and [64,200,13],
tanh; K3-bf16 and K4-bf16 on the same x stored in float32, in bf16, and in
bf16 at an odd 2-byte offset), waits for the card, and holds each result
against its plain version (K1/K2 bitwise, K3 pooled within 1e-4, K4 each
gradient within 1e-4 of its largest value, the bf16 modes at the bars of
the card tests).  Then it does the same again with the caching
allocator's free blocks filled with NaN before each launch, so that an
output row the kernel never writes, or scratch it reads before writing,
shows up as a difference.

With ``--tools`` it runs that launch under each named compute-sanitizer
tool, with PYTORCH_NO_CUDA_MEMORY_CACHING=1 so that every buffer is its
own allocation and an out-of-bounds access is not hidden inside a cached
block, and prints each tool's verdict (its error summary, or why it could
not run); each tool's full report goes to ``--log-dir``:

    python3 scripts/sanitize_kernels.py \
        --tools memcheck,initcheck,racecheck,synccheck
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def launch_all(poison: bool) -> list[str]:
    """Each kernel once on fresh inputs; returns the failed checks."""
    import numpy as np
    import torch

    from gpudrive_lab_torch.core import kernels
    from gpudrive_lab_torch.networks import fused_embed as fe

    dev = torch.device("cuda")
    failed = []

    def fill():
        # the allocator hands these blocks to the kernel's outputs next
        if poison:
            for n in (1 << 12, 1 << 16, 1 << 20):
                torch.full((n,), float("nan"), device=dev)
            torch.cuda.synchronize()

    def features(rng, W, A, R):
        def col(*s, lo=-1.0, hi=1.0):
            return rng.uniform(lo, hi, s).astype(np.float32)
        ya, yr = col(W, A, lo=-3, hi=3), col(W, R, lo=-3, hi=3)
        agents = np.stack(
            [col(W, A, lo=-60, hi=60), col(W, A, lo=-60, hi=60),
             np.cos(ya), np.sin(ya), col(W, A, lo=0.5, hi=3),
             col(W, A, lo=0.5, hi=2), rng.random((W, A)) < 0.8,
             rng.random((W, A)) < 0.7], -1).astype(np.float32)
        roads = np.stack(
            [col(W, R, lo=-60, hi=60), col(W, R, lo=-60, hi=60),
             np.cos(yr), np.sin(yr), col(W, R, lo=1, hi=20),
             np.full((W, R), 0.1, np.float32), rng.random((W, R)) < 0.5,
             rng.random((W, R)) < 0.2], 1).astype(np.float32)
        return torch.from_numpy(agents), torch.from_numpy(roads)

    rng = np.random.default_rng(0)
    for W, A, R in ((3, 128, 256), (2, 37, 33)):
        a, r = features(rng, W, A, R)
        fill()
        got = kernels.agent_road_hits_dense(a.to(dev), r.to(dev)).cpu()
        if not torch.equal(got, kernels.agent_road_hits_dense_plain(a, r)):
            failed.append(f"K2 [{W},{A},{R}]")
    W, A, T = 2, 64, 3
    a, r = features(rng, W, A, T * 256)
    tiles = r.reshape(W, 8, T, 256).transpose(1, 2).contiguous()
    mask = torch.from_numpy((rng.random((W, A // 16, T)) < 0.6)
                            .astype(np.int32))
    fill()
    got = kernels.agent_road_hits_tiled(a.to(dev), tiles.to(dev),
                                        mask.to(dev)).cpu()
    if not torch.equal(got, kernels.agent_road_hits_tiled_plain(a, tiles,
                                                                mask)):
        failed.append(f"K1 [{W},{A},{T}x256]")

    for B, E, F in ((37, 127, 6), (64, 200, 13)):
        g = torch.Generator().manual_seed(B + E)
        x = torch.randn(B, E, F, generator=g)
        w = [torch.randn(F, 64, generator=g) * 0.3,
             torch.randn(64, generator=g) * 0.1,
             1 + 0.1 * torch.randn(64, generator=g),
             torch.randn(64, generator=g) * 0.1,
             torch.randn(64, 64, generator=g) * 0.2,
             torch.randn(64, generator=g) * 0.1]
        wd = [t.to(dev) for t in w]
        fill()
        pooled, arg = fe.fused_embed_pool_fwd(x.to(dev), *wd, "tanh")
        want, _ = fe.reference_embed_pool_argmax(x, *w, "tanh")
        err = float((pooled.cpu() - want).abs().max())
        if not err <= 1e-4:
            failed.append(f"K3 [{B},{E},{F}]: pooled max abs err {err}")
        dpool = torch.randn(B, 64, generator=g)
        fill()
        grads = fe.fused_embed_pool_bwd(x.to(dev), *wd, arg, dpool.to(dev),
                                        "tanh")
        wants = fe.reference_embed_pool_bwd(x, *w, arg.cpu(), dpool, "tanh")
        for name, a_, b_ in zip(("w1", "b1", "g", "be", "w2", "b2"), grads,
                                wants):
            e = float((a_.cpu() - b_).abs().max())
            if not e <= 1e-4 * float(b_.abs().max()):
                failed.append(f"K4 [{B},{E},{F}] d{name}: max abs err {e}")
        for x_dtype in (torch.float32, torch.bfloat16):
            failed += _bf16_modes(x.to(x_dtype), w, wd, dpool, fill)
        # bf16 x at an odd 2-byte offset of its buffer
        xo = torch.cat([torch.zeros(B, 1), x.reshape(B, -1)], 1)
        xo = xo.to(torch.bfloat16)[:, 1:].unflatten(-1, (E, F))
        failed += _bf16_modes(xo, w, wd, dpool, fill)
    torch.cuda.synchronize()
    return failed


def _bf16_modes(x, w, wd, dpool, fill) -> list[str]:
    """K3-bf16 and K4-bf16 once each on x (float32 or bf16, as stored)
    against their plain bf16 versions, at the bars of
    tests/test_torch_cuda.py: the pooled output within 4 bf16 flips of t
    and at most 1% of entries beyond 1e-5; dw1, dw2 within
    BF16_PRODUCT_BAR of their terms' root-sum-square, the other gradients
    within 1e-4 of their largest value."""
    import torch

    from gpudrive_lab_torch.networks import fused_embed as fe

    bf, dev = torch.bfloat16, torch.device("cuda")
    what = f"{list(x.shape)} {str(x.dtype)[6:]} x, offset {x.storage_offset()}"
    failed = []
    fill()
    pooled, arg = fe.fused_embed_pool_fwd(x.to(dev), *wd, "tanh", bf)
    want, _ = fe.reference_embed_pool_argmax(x, *w, "tanh", bf)
    err = (pooled.cpu() - want).abs()
    bar = 4 * fe.bf16_flip_bound("tanh", w[2], w[3], w[4])
    loose = float((err > 1e-5).float().mean())
    if not (float(err.max()) <= bar and loose <= 0.01):
        failed.append(f"K3-bf16 {what}: pooled max abs err "
                      f"{float(err.max())}, {loose} beyond 1e-5")
    arg = arg.cpu()
    fill()
    grads = fe.fused_embed_pool_bwd(x.to(dev), *wd, arg.to(dev),
                                    dpool.to(dev), "tanh", bf)
    wants = fe.reference_embed_pool_bwd(x, *w, arg, dpool, "tanh", bf)
    rss = fe.bwd_product_rss(x, *w, arg, dpool, "tanh", bf)
    for name, a_, b_ in zip(("w1", "b1", "g", "be", "w2", "b2"), grads,
                            wants):
        if name in ("w1", "w2"):
            e = fe.bf16_product_error(a_.cpu(), b_, rss[name == "w2"])
            ok = e <= fe.BF16_PRODUCT_BAR
        else:
            e = float((a_.cpu() - b_).abs().max())
            ok = e <= 1e-4 * float(b_.abs().max())
        if not ok:
            failed.append(f"K4-bf16 {what} d{name}: error {e}")
    return failed


def sanitizer_path() -> str | None:
    for cand in (shutil.which("compute-sanitizer"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "compute-sanitizer"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "compute-sanitizer", "compute-sanitizer")):
        if cand and os.path.exists(cand):
            return cand
    return None


def run_tools(tools: list[str], log_dir: str, timeout: float) -> dict:
    tool = sanitizer_path()
    if tool is None:
        return {t: "not run: compute-sanitizer not found" for t in tools}
    os.makedirs(log_dir, exist_ok=True)
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    verdicts = {}
    for t in tools:
        cmd = [tool, "--tool", t, "--error-exitcode", "9",
               sys.executable, os.path.abspath(__file__), "--once"]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 env=env, timeout=timeout)
            text, rc = res.stdout + res.stderr, res.returncode
        except subprocess.TimeoutExpired as e:
            text, rc = f"timed out after {e.timeout} s", None
        with open(os.path.join(log_dir, f"sanitize_{t}.log"), "w") as fh:
            fh.write(text)
        summary = re.findall(r"ERROR SUMMARY: .*", text)
        errors = [line for line in text.splitlines()
                  if line.startswith("========= ")
                  and "ERROR SUMMARY" not in line][:8]
        verdicts[t] = dict(
            exit_code=rc, summary=summary[-1] if summary else None,
            first_lines=errors,
            checks="passed" if "KERNELS OK" in text else "not reached",
            tail=None if summary else text.strip().splitlines()[-3:])
    return verdicts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tools", default=None,
                    help="comma-separated compute-sanitizer tools")
    ap.add_argument("--once", action="store_true",
                    help="launch once, without the NaN-filled repeat (what "
                         "each tool runs)")
    ap.add_argument("--log-dir", default=os.path.join(ROOT, "runs", "sanitize"))
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds allowed to each tool")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sanitize_kernels: CUDA is not available", file=sys.stderr)
        return 2
    if args.tools:
        verdicts = run_tools(args.tools.split(","), args.log_dir,
                             args.timeout)
        print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                              sanitizer=sanitizer_path(), tools=verdicts)))
        return 0
    failed = launch_all(poison=False)
    if not args.once:
        failed += [f"NaN-filled: {f}" for f in launch_all(poison=True)]
    for f in failed:
        print(f"sanitize_kernels: FAILED {f}")
    if failed:
        return 1
    print("KERNELS OK: K1-K4 each launched and equal to plain"
          + ("" if args.once else ", also over NaN-filled memory"))
    return 0


if __name__ == "__main__":
    sys.exit(main())

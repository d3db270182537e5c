#!/usr/bin/env python3
"""How far the host CPU's float32 products are from float64, and what
torch does them with.  Runs on the CPU only (no card needed).

Prints the CPU model, torch's float32 matmul settings, the oneDNN/MKL
environment variables, torch's build configuration lines on BLAS and
oneDNN, then, on the input of
``tests/test_torch_cuda.py::test_fused_embed_kernel_matches_plain``
(``--case B,E,F``, tanh, seeded as the test seeds it), the largest
absolute error against float64 of: K3's plain version (``fused_embed.
_embed`` then the max over entities), its first product ``x @ w1`` and its
second product ``t @ w2``, each through ``torch.matmul`` and through an
elementwise product summed in float32 (``(a[..., None] * b).sum``), with
torch's default threads and with one.  A matmul error far above the
elementwise sum's means the CPU's GEMM computes float32 products in less
than float32 precision.  One JSON line at the end:

    python3 scripts/cpu_gemm_precision.py [--case 37,127,6]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def cpu_model() -> str:
    """The CPU's model name from /proc/cpuinfo, or its vendor and family
    where the model name is hidden."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if ":" in line:
                    k, v = (p.strip() for p in line.split(":", 1))
                    fields.setdefault(k, v)
    except OSError:
        pass
    if "model name" in fields:
        return fields["model name"]
    return " ".join(f"{k} {fields[k]}" for k in ("vendor_id", "cpu family",
                                                 "model", "flags")
                    if k in fields)[:300] or platform.processor() or "unknown"


def main() -> int:
    import torch

    from gpudrive_lab_torch.networks import fused_embed as fe

    ap = argparse.ArgumentParser()
    ap.add_argument("--case", default="37,127,6")
    args = ap.parse_args()
    B, E, F = (int(v) for v in args.case.split(","))
    g = torch.Generator().manual_seed(B + E)
    x = torch.randn(B, E, F, generator=g)
    # tests/test_torch_cuda.py::_embed_params
    w = [torch.randn(F, 64, generator=g) * 0.3,
         torch.randn(64, generator=g) * 0.1,
         1 + 0.1 * torch.randn(64, generator=g),
         torch.randn(64, generator=g) * 0.1,
         torch.randn(64, 64, generator=g) * 0.2,
         torch.randn(64, generator=g) * 0.1]
    out = {"cpu": cpu_model(), "machine": platform.machine(),
           "cpu_capability": torch.backends.cpu.get_cpu_capability(),
           "torch": torch.__version__,
           "threads": torch.get_num_threads(),
           "float32_matmul_precision": torch.get_float32_matmul_precision(),
           "mkldnn": torch.backends.mkldnn.is_available(),
           "mkl": torch.backends.mkl.is_available()}
    for name in ("fp32_precision",):
        for mod in ("mkldnn", "mkldnn.matmul"):
            obj = torch.backends
            for part in mod.split("."):
                obj = getattr(obj, part, None)
            if obj is not None and hasattr(obj, name):
                out[f"{mod}.{name}"] = str(getattr(obj, name))
    out["env"] = {k: v for k, v in os.environ.items()
                  if k.startswith(("ONEDNN", "DNNL", "MKL", "OMP", "KMP"))}
    print(json.dumps(out))
    for line in torch.__config__.show().splitlines():
        if any(k in line for k in ("BLAS", "LAPACK", "oneDNN", "MKL",
                                   "CPU capability")):
            print("config:", line.strip()[:200])

    x64, w64 = x.double(), [t.double() for t in w]
    pre64 = x64 @ w64[0] + w64[1]
    # the activation output t: the embed with an identity second layer
    t64 = fe._embed(x64, *w64[:4], torch.eye(64).double(),
                    torch.zeros(64).double(), "tanh")
    t32 = t64.float()
    want_pool = fe._embed(x64, *w64, "tanh").amax(dim=1)
    rows = {}
    for threads in (out["threads"], 1):
        torch.set_num_threads(threads)
        pool = fe._embed(x, *w, "tanh").amax(dim=1)
        rows[f"plain_pool_vs_f64_threads{threads}"] = float(
            (pool.double() - want_pool).abs().max())
        for pname, a, b, ref in (
                ("x_w1", x, w[0], pre64 - w64[1]),
                ("t_w2", t32, w[4], t32.double() @ w64[4])):
            mm = torch.matmul(a, b)
            ew = (a[..., :, None] * b).sum(dim=-2)
            rows[f"{pname}_matmul_threads{threads}"] = float(
                (mm.double() - ref).abs().max())
            rows[f"{pname}_elementwise_threads{threads}"] = float(
                (ew.double() - ref).abs().max())
    for k, v in rows.items():
        print(f"{k}: {v:.3g}")
    out.update(rows)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

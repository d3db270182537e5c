"""Check that K3 and K4 in float32 give the same bits as another version.

Builds another version of ``csrc/fused_embed.cu`` and
``csrc/fused_embed_bwd.cu`` (``--old-dir``, a directory holding both,
unpacked from git with ``git archive``, say) beside the package's own, launches both versions' float32
entry points through the package's wrappers on the same inputs at the main
path's shapes (the partner and road blocks at 65,536, 35,328 and 4,416 rows,
the partner block read in place from [B, 3368] rows, both activations), and
fails unless the pooled outputs, the argmax and the six gradients are equal
bit for bit.  Needs an NVIDIA GPU and nvcc; from the repository root:

    python3 -m gpudrive_lab_torch.utils.same_bits --old-dir path/to/old/csrc
"""

from __future__ import annotations

import argparse
import os
import sys


def old_libs(old_dir: str) -> dict:
    """The other version's libraries with their float32 entry points
    declared, ready for cuda_build.use."""
    from gpudrive_lab_torch import cuda_build
    from gpudrive_lab_torch.networks.fused_embed import declare

    fwd, _ = cuda_build.load_source(
        "fused_embed", os.path.join(old_dir, "fused_embed.cu"))
    declare(fwd, ["fused_embed_pool_fwd"])
    bwd, _ = cuda_build.load_source(
        "fused_embed_bwd", os.path.join(old_dir, "fused_embed_bwd.cu"))
    declare(bwd, ["fused_embed_pool_bwd", "fused_embed_pool_bwd_blocks"])
    return {"fused_embed": fwd, "fused_embed_bwd": bwd}


def cases(dev):
    """(label, x, params, dpool) at the main path's shapes."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    for rows in (65536, 35328, 4416):
        obs = torch.randn(rows, 3368, generator=g, device=dev)
        for name, x, F in (
                ("partner", obs[:, 6:768].unflatten(-1, (127, 6)), 6),
                ("road", obs[:, 768:].unflatten(-1, (200, 13)), 13)):
            w = [torch.randn(F, 64, generator=g, device=dev) * 0.3,
                 torch.randn(64, generator=g, device=dev) * 0.1,
                 1 + 0.1 * torch.randn(64, generator=g, device=dev),
                 torch.randn(64, generator=g, device=dev) * 0.1,
                 torch.randn(64, 64, generator=g, device=dev) * 0.2,
                 torch.randn(64, generator=g, device=dev) * 0.1]
            dpool = torch.randn(rows, 64, generator=g, device=dev)
            yield f"{name} [{rows},{x.shape[1]},{F}]", x, w, dpool


def run(dev) -> dict:
    import torch

    from gpudrive_lab_torch.networks import fused_embed as fe

    out = {}
    for label, x, w, dpool in cases(dev):
        for act in ("tanh", "gelu"):
            pooled, arg = fe.fused_embed_pool_fwd(x, *w, act)
            grads = fe.fused_embed_pool_bwd(x, *w, arg, dpool, act)
            out[(label, act)] = [t.cpu() for t in (pooled, arg, *grads)]
    torch.cuda.synchronize()
    return out


def main() -> int:
    import torch

    from gpudrive_lab_torch import cuda_build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-dir", required=True,
                    help="directory with the other fused_embed.cu and "
                         "fused_embed_bwd.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("same_bits: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    new = run(dev)
    for name, lib in old_libs(args.old_dir).items():
        cuda_build.use(name, lib)
    old = run(dev)
    names = ("pooled", "argmax", "dw1", "db1", "dg", "dbe", "dw2", "db2")
    differ = [f"{key} {n}" for key in new
              for n, a, b in zip(names, new[key], old[key])
              if not torch.equal(a, b)]
    print(f"same_bits: {len(new)} cases x {len(names)} outputs, "
          f"{len(differ)} differ")
    for d in differ[:20]:
        print(f"same_bits:   differs: {d}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())

"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` compiles with ``nvcc`` into its own shared
library with a plain C interface, for ``sm_90a`` (Hopper).  Libraries land in
``gpudrive_lab_torch/_build/`` under a name that carries a hash of the source
and flags, so an edited source rebuilds and an unchanged one is reused.
``build()`` starts one ``nvcc`` per missing library, all at once, and waits
for all of them.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_COMMON = ["-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v"]
# Per-source flags.  agent_road: exact SAT, no FMA contraction (see the
# source's header comment).  flat_obs writes its arithmetic with the _rn
# intrinsics, which are never contracted, and keeps the default flags that
# PyTorch's own kernels, whose sinf, cosf and atan2f it must match, are
# built with.
FLAGS = {
    "agent_road": ["--fmad=false"],
    "flat_obs": [],
    "fused_embed": [],
    "fused_embed_bf16": [],
    "fused_embed_bwd": [],
    "fused_embed_bwd_bf16": [],
}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source(name: str, source=None) -> Path:
    return Path(source) if source is not None else CSRC / f"{name}.cu"


def _command(name: str, out: Path, source=None) -> list[str]:
    return ([nvcc_path()] + _ARCH + _COMMON + FLAGS[name]
            + ["-o", str(out), str(_source(name, source))])


def library_path(name: str, source=None) -> Path:
    """Where the library of ``csrc/<name>.cu`` (or of ``source``, built with
    ``name``'s flags) lands: named by a hash of the source and flags."""
    digest = hashlib.sha256(
        _source(name, source).read_bytes()
        + " ".join(_ARCH + _COMMON + FLAGS[name]).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None) -> dict[str, str]:
    """Compile the named sources (default: all) that are not built yet, in
    parallel.  Returns {name: compiler output} for the sources compiled by
    this call (ptxas register and shared-memory report included).  Raises
    RuntimeError with the compiler's output if any build fails."""
    names = list(FLAGS) if names is None else list(names)
    return _build({name: (name, None) for name in names})


def _build(jobs: dict) -> dict[str, str]:
    """Compile each job {key: (name, source)} not built yet, in parallel;
    {key: compiler output} of those compiled."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, (name, source) in jobs.items():
        out = library_path(name, source)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[key] = (
            subprocess.Popen(
                _command(name, tmp, source), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ),
            tmp,
            out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def load_source(name: str, source) -> tuple[ctypes.CDLL, str]:
    """Another version of ``csrc/<name>.cu`` with the same C entry points
    (an older one, say), built with ``name``'s flags and loaded beside the
    package's own, to compare versions on the card.  Returns the library
    and the compiler's output ('' if it was built before)."""
    log = _build({name: (name, source)}).get(name, "")
    return ctypes.CDLL(str(library_path(name, source))), log


def use(name: str, lib: ctypes.CDLL) -> None:
    """From now on serve ``lib`` (from ``load_source``) as the library of
    ``csrc/<name>.cu``: the package's wrappers launch that version."""
    _loaded[name] = lib


def check(status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")

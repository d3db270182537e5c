"""Native (C++) scene compiler for the port (counterpart of
``gpudrive_lab_tpu/native/__init__.py``).

Builds the repository's ``csrc/scene_compiler.cpp`` (shared with the JAX
package) with ``g++ -O3 -std=c++17 -shared -fPIC``, the JAX package's flags,
so both libraries give the same bits.  The library lands in
``gpudrive_lab_torch/_build/`` under a name that carries a digest of the
source and flags; it is written to a temporary file and moved into place
with ``os.replace``, so processes that build at once never load half a
library.  It is loaded through ctypes, whose foreign calls release the
interpreter lock.  Nothing here runs at import time.

Unlike the JAX package, a failed build or load raises with the compiler's
or loader's message; ``GPUDRIVE_TORCH_NO_NATIVE=1`` is the only way to have
``scene.compiler.compile_world`` take the Python path for every scene.  A
scene the C++ parser declines (a non-zero return) takes the Python path,
as in the JAX package; ``fallbacks()`` counts those scenes and the first
one warns.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "scene_compiler.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
NO_NATIVE_ENV = "GPUDRIVE_TORCH_NO_NATIVE"
A, T = 128, 91  # agent rows and trajectory steps of the C interface

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_fallbacks = 0


class _Options(ctypes.Structure):
    _fields_ = [
        ("polyline_threshold", ctypes.c_float),
        ("ignore_non_vehicles", ctypes.c_int32),
        ("init_only_valid", ctypes.c_int32),
        ("read_tracks", ctypes.c_int32),
        ("is_static_controlled", ctypes.c_int32),
        ("max_controlled", ctypes.c_int32),
        ("r_cap", ctypes.c_int32),
    ]


_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


class _SceneOut(ctypes.Structure):
    _fields_ = [
        ("valid", _U8P), ("etype", _I32P), ("size", _F32P), ("goal", _F32P),
        ("aid", _I32P), ("controlled", _U8P), ("is_static", _U8P),
        ("mark_expert", _U8P), ("metadata", _I32P),
        ("traj_pos", _F32P), ("traj_vel", _F32P), ("traj_yaw", _F32P),
        ("traj_valid", _F32P),
        ("road_pos", _F32P), ("road_yaw", _F32P), ("road_scale", _F32P),
        ("road_type", _I32P), ("road_id", _I32P), ("road_map_type", _I32P),
        ("num_agents", _I32P), ("num_roads", _I32P), ("mean", _F32P),
        ("name_codes", _I32P), ("scenario_codes", _I32P),
    ]


def enabled() -> bool:
    """False when ``GPUDRIVE_TORCH_NO_NATIVE`` is set: scenes then compile
    with the Python path on purpose."""
    return not os.environ.get(NO_NATIVE_ENV)


def library_path(source=None) -> Path:
    """Where the library of ``source`` (default: the repository's
    ``csrc/scene_compiler.cpp``) lands: named by a digest of the source
    and the flags."""
    src = Path(source) if source is not None else SOURCE
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libscene_compiler-{digest}.so"


def build(source=None) -> Optional[str]:
    """Compile ``source`` (default: ``csrc/scene_compiler.cpp``) unless it
    is built already.  Returns g++'s output, or None when the library was
    there.  Raises RuntimeError with g++'s output when the build fails."""
    src = Path(source) if source is not None else SOURCE
    if not src.exists():
        raise RuntimeError(f"native scene compiler: no source at {src}")
    out = library_path(src)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *FLAGS, str(src), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native scene compiler: {' '.join(cmd)} did not run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native scene compiler: g++ exited {proc.returncode}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed.  Raises RuntimeError when
    the build or the load fails."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            path = library_path()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(
                    f"native scene compiler: cannot load {path}: {e}") from e
            lib.compile_scene_json.restype = ctypes.c_int
            lib.compile_scene_json.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(_Options),
                _I32P, ctypes.c_int32, ctypes.POINTER(_SceneOut),
            ]
            _lib = lib
        return _lib


def available() -> bool:
    """Whether scenes compile natively here: the native path is enabled
    (``enabled()``) and the library builds and loads.  Unlike ``load`` it
    does not raise; it answers what the JAX package's ``available`` does,
    for callers that choose a path or skip (a later ``load`` raises with
    the reason)."""
    if not enabled():
        return False
    try:
        load()
    except RuntimeError:
        return False
    return True


def fallbacks() -> int:
    """Scenes the C++ parser declined since the last ``reset_fallbacks``
    (each one compiled with the Python path instead)."""
    return _fallbacks


def reset_fallbacks() -> None:
    global _fallbacks
    with _lock:
        _fallbacks = 0


def _declined(rc: int) -> None:
    global _fallbacks
    with _lock:
        _fallbacks += 1
        first = _fallbacks == 1
    if first:
        warnings.warn(
            f"native scene compiler declined a scene (return code {rc}); it "
            "and any later such scene compile with the Python path "
            "(native.fallbacks() counts them)", RuntimeWarning, stacklevel=3)


def compile_scene_native(
    json_bytes: bytes,
    polyline_threshold: float,
    ignore_non_vehicles: bool,
    init_only_valid: bool,
    read_tracks: bool,
    is_static_controlled: bool,
    max_controlled: int,
    r_cap: int,
    deleted: tuple = (),
) -> Optional[dict]:
    """Run the C++ compiler on one scene's JSON.  Returns the agent
    (padded to A = 128 rows, T = 91 steps) and road (``r_cap`` rows)
    arrays, or None when the C++ parser declines the scene (counted by
    ``fallbacks``)."""
    lib = load()

    def f32(*shape):
        return np.zeros(shape, np.float32)

    def i32(*shape):
        return np.zeros(shape, np.int32)

    def u8(*shape):
        return np.zeros(shape, np.uint8)

    arrays = dict(
        valid=u8(A), etype=i32(A), size=f32(A, 3), goal=f32(A, 2),
        aid=np.full(A, -1, np.int32), controlled=u8(A), is_static=u8(A),
        mark_expert=u8(A), metadata=np.full((A, 4), -1, np.int32),
        traj_pos=f32(A, T, 2), traj_vel=f32(A, T, 2), traj_yaw=f32(A, T),
        traj_valid=f32(A, T),
        road_pos=f32(r_cap, 3), road_yaw=f32(r_cap),
        road_scale=f32(r_cap, 3), road_type=i32(r_cap),
        road_id=np.full(r_cap, -1, np.int32),
        road_map_type=np.full(r_cap, -1, np.int32),
        num_agents=i32(1), num_roads=i32(1), mean=f32(2),
        name_codes=i32(32), scenario_codes=i32(32),
    )
    ctype = {np.dtype(np.float32): _F32P, np.dtype(np.int32): _I32P,
             np.dtype(np.uint8): _U8P}
    # the arrays dict keeps every buffer alive across the foreign call
    out = _SceneOut(**{k: v.ctypes.data_as(ctype[v.dtype])
                       for k, v in arrays.items()})
    opt = _Options(
        polyline_threshold=polyline_threshold,
        ignore_non_vehicles=int(ignore_non_vehicles),
        init_only_valid=int(init_only_valid),
        read_tracks=int(read_tracks),
        is_static_controlled=int(is_static_controlled),
        max_controlled=int(min(max_controlled, 2**31 - 1)),
        r_cap=int(r_cap),
    )
    deleted_arr = np.asarray(sorted(deleted), np.int32)
    rc = lib.compile_scene_json(
        json_bytes, len(json_bytes), ctypes.byref(opt),
        deleted_arr.ctypes.data_as(_I32P) if len(deleted_arr) else None,
        len(deleted_arr), ctypes.byref(out),
    )
    if rc != 0:
        _declined(rc)
        return None
    return arrays

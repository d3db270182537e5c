"""Helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages are fed the same values: data is made with numpy from a seed,
and a Scene or SimState crosses between the packages as numpy arrays.  The
JAX package is used as it is; its native scene compiler is switched off
(``python_scene_compiler``) so that both packages compile scenes with the
same Python path.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.core import types as jtypes
from gpudrive_lab_tpu.scene import compiler as jcompiler
from gpudrive_lab_torch.core import types as ttypes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNTHETIC_SCENE = os.path.join(ROOT, "tests", "data", "tfrecord_synthetic_0.json")
POOL_SCENES = sorted(glob.glob(os.path.join(ROOT, "data", "pool_v3", "*.json")))
AGENT_AGENT = os.path.join(ROOT, "tests", "data", "agent_agent_collision.json")
ROAD_EDGE = os.path.join(ROOT, "tests", "data", "agent_road_edge_collision.json")

# The suite runs in several worker processes at once; torch's default of one
# thread per core in each of them oversubscribes the host several times over.
torch.set_num_threads(min(torch.get_num_threads(), 2))


@contextlib.contextmanager
def python_scene_compiler():
    """Make the JAX package compile scenes with its pure-Python path (the
    path the port carries) for the duration of the block."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcompiler, "_compile_world_native", lambda *a, **k: None)
        jcompiler.compile_world.cache_clear()
        try:
            yield
        finally:
            jcompiler.compile_world.cache_clear()


def jax_params(tparams: ttypes.Params) -> jtypes.Params:
    """The JAX Params with the same field values."""
    vals = {}
    for f in dataclasses.fields(tparams):
        v = getattr(tparams, f.name)
        if isinstance(v, int) and type(v) is not int and type(v) is not bool:
            v = getattr(jtypes, type(v).__name__)(int(v))
        vals[f.name] = v
    return jtypes.Params(**vals)


def to_jax(obj, cls):
    """A port tensor dataclass -> the JAX package's struct of the same
    name (``cls``), field by field through numpy."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[f.name] = jnp.asarray(v.detach().cpu().numpy())
        elif v is None:
            out[f.name] = None
        else:
            out[f.name] = to_jax(v, getattr(jtypes, type(v).__name__))
    return cls(**out)


def scene_to_jax(scene: ttypes.Scene) -> jtypes.Scene:
    return to_jax(scene, jtypes.Scene)


def state_to_jax(state: ttypes.SimState) -> jtypes.SimState:
    return to_jax(state, jtypes.SimState)


def state_to_torch(state) -> ttypes.SimState:
    return ttypes.SimState(**{
        f.name: torch.from_numpy(np.array(getattr(state, f.name)))
        for f in dataclasses.fields(ttypes.SimState)
    })


def yaw_diff(a, b):
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(np.arctan2(np.sin(d), np.cos(d)))


INT_FIELDS = ("done", "collided", "collided_road", "collided_vehicle",
              "collided_non_vehicle", "reached_goal", "steps_remaining")


def assert_states_match(js, ts, tol=1e-3, where=""):
    """Integer and flag fields exactly equal; pos, yaw and vel within
    ``tol`` (the reference's own per-step epsilon, ROADMAP "parity bar")."""
    for f in INT_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(js, f)), getattr(ts, f).numpy(),
            err_msg=f"{f} {where}",
        )
    for f in ("pos", "vel"):
        np.testing.assert_allclose(
            np.asarray(getattr(js, f)), getattr(ts, f).numpy(),
            rtol=0, atol=tol, err_msg=f"{f} {where}",
        )
    assert yaw_diff(js.yaw, ts.yaw.numpy()).max() <= tol, f"yaw {where}"


def sorted_rows(block: np.ndarray) -> np.ndarray:
    """Sort the rows of [..., K, D] lexicographically within each [K, D]
    set, so that two blocks holding the same rows in another order
    compare equal."""
    flat = block.reshape(-1, *block.shape[-2:])
    out = np.empty_like(flat)
    for i, rows in enumerate(flat):
        order = np.lexsort(np.round(rows, 4).T[::-1])
        out[i] = rows[order]
    return out.reshape(block.shape)

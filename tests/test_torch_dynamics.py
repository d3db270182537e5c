"""Dynamics and OBB parity: the port's four forward models, two inverse
models and both OBB forms against the JAX package, elementwise on random
batches made with numpy."""

import jax
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.core import dynamics as jdyn
from gpudrive_lab_tpu.core import geometry as jgeo
from gpudrive_lab_tpu.core import obb as jobb
from gpudrive_lab_torch.core import dynamics as tdyn
from gpudrive_lab_torch.core import geometry as tgeo
from gpudrive_lab_torch.core import obb as tobb

N = (4, 33)


def _batch(seed):
    rng = np.random.default_rng(seed)
    f = lambda lo, hi, *s: rng.uniform(lo, hi, N + s).astype(np.float32)
    return dict(
        action=f(-5, 5, 10), length=f(1, 6), pos=f(-50, 50, 2),
        yaw=f(-4, 4), vel=f(-10, 10, 2), tpos=f(-50, 50, 2),
        tyaw=f(-4, 4), tvel=f(-10, 10, 2),
    )


def _close(got, want, tol=1e-5):
    got = [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]
    want = [np.asarray(w) for w in (want if isinstance(want, tuple) else (want,))]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


@pytest.mark.parametrize("model", ["classic", "bicycle", "delta", "state"])
def test_forward_models(model):
    b = _batch(1)
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    if model == "classic":
        got = tdyn.forward_classic(t["action"], t["length"], t["pos"],
                                   t["yaw"], t["vel"])
        want = jdyn.forward_classic(b["action"], b["length"], b["pos"],
                                    b["yaw"], b["vel"])
    elif model == "bicycle":
        got = tdyn.forward_invertible_bicycle(t["action"], t["pos"],
                                              t["yaw"], t["vel"])
        want = jdyn.forward_invertible_bicycle(b["action"], b["pos"],
                                               b["yaw"], b["vel"])
    elif model == "delta":
        got = tdyn.forward_delta_local(t["action"], t["pos"], t["yaw"],
                                       t["vel"])
        want = jdyn.forward_delta_local(b["action"], b["pos"], b["yaw"],
                                        b["vel"])
    else:
        got = tdyn.forward_state(t["action"])
        want = jdyn.forward_state(b["action"])
    _close(got, want, tol=2e-5)


def test_inverse_models_and_angles():
    b = _batch(2)
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    _close(tdyn.inverse_bicycle(t["vel"], t["yaw"], t["tvel"], t["tyaw"]),
           jdyn.inverse_bicycle(b["vel"], b["yaw"], b["tvel"], b["tyaw"]),
           tol=1e-4)
    _close(tdyn.inverse_delta(t["pos"], t["yaw"], t["tpos"], t["tyaw"]),
           jdyn.inverse_delta(b["pos"], b["yaw"], b["tpos"], b["tyaw"]))
    big = np.linspace(-20, 20, 401).astype(np.float32)
    _close(tgeo.normalize_angle(torch.from_numpy(big)),
           jax.jit(jgeo.normalize_angle)(big))


def test_obb_forms_match():
    rng = np.random.default_rng(3)
    n = (6, 50)
    ca, cb = (rng.uniform(-4, 4, n + (2,)).astype(np.float32) for _ in "ab")
    ya, yb = (rng.uniform(-3, 3, n).astype(np.float32) for _ in "ab")
    ha, hb = (rng.uniform(0.3, 3, n + (2,)).astype(np.float32) for _ in "ab")
    args = (ca, ya, ha, cb, yb, hb)
    targs = [torch.from_numpy(a) for a in args]
    sat = tobb.obb_overlap_sat(*targs).numpy()
    np.testing.assert_array_equal(sat, np.asarray(jobb.obb_overlap_sat(*args)))
    np.testing.assert_array_equal(
        tobb.obb_overlap_from_params(*targs).numpy(),
        np.asarray(jobb.obb_overlap_from_params(*args)))
    assert 0 < sat.sum() < sat.size

"""The port's native scene compiler (gpudrive_lab_torch.native and
scene.compiler._compile_world_native) against the JAX package's native
path (the same csrc/scene_compiler.cpp built with the same flags: equal
bits) and against the port's Python path (within the 2e-4 of
tests/test_native_compiler.py), over the same option sets; the switch that
selects the Python path, the count of declined scenes, and a failed build."""

import glob
import json
import os
import threading

import numpy as np
import pytest

from gpudrive_lab_tpu import native as jnative
from gpudrive_lab_tpu.scene import compiler as jcompiler
from gpudrive_lab_torch import native
from gpudrive_lab_torch.core.types import DynamicsModel, Params
from gpudrive_lab_torch.scene import compiler as tcompiler
from torch_parity import (
    POOL_SCENES,
    ROOT,
    SYNTHETIC_SCENE,
    assert_jax_native,
    jax_params,
)

PARAM_SETS = [
    Params(polyline_reduction_threshold=0.0, ignore_non_vehicles=True),
    Params(polyline_reduction_threshold=0.5, ignore_non_vehicles=True,
           max_num_controlled_agents=2,
           dynamics_model=DynamicsModel.DELTA_LOCAL),
    Params(polyline_reduction_threshold=0.1, ignore_non_vehicles=False,
           dynamics_model=DynamicsModel.INVERTIBLE_BICYCLE),
    Params(init_only_valid_agents=False),
]
SCENES = sorted(glob.glob(os.path.join(ROOT, "tests", "data", "*.json"))
                ) + POOL_SCENES[:3]
CASES = [(p, s) for p in range(len(PARAM_SETS)) for s in SCENES]
CASE_IDS = [f"params{p}-{os.path.basename(s)}" for p, s in CASES]


def _fields(w):
    """Every array of a CompiledWorld, by name."""
    out = {f"agent[{k}]": v for k, v in w.agent.items()}
    out.update({f"road[{k}]": v for k, v in w.road.items()})
    out.update(num_agents=np.asarray(w.num_agents),
               num_roads=np.asarray(w.num_roads), mean=w.mean,
               map_name=w.map_name, scenario_id=w.scenario_id)
    return out


def assert_worlds_equal(got, want):
    a, b = _fields(got), _fields(want)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def assert_worlds_close(nat, py):
    """The bar of tests/test_native_compiler.py::_assert_world_equal."""
    assert nat.num_agents == py.num_agents
    assert nat.num_roads == py.num_roads
    np.testing.assert_allclose(nat.mean, py.mean, atol=1e-4)
    np.testing.assert_array_equal(nat.map_name, py.map_name)
    np.testing.assert_array_equal(nat.scenario_id, py.scenario_id)
    for k in nat.agent:
        np.testing.assert_allclose(nat.agent[k], py.agent[k], atol=2e-4,
                                   err_msg=f"agent[{k}]")
    for k in nat.road:
        np.testing.assert_allclose(nat.road[k], py.road[k], atol=2e-4,
                                   err_msg=f"road[{k}]")


@pytest.fixture(scope="module", autouse=True)
def _native_on():
    """Both native paths present: neither package falls back silently."""
    assert native.enabled(), "GPUDRIVE_TORCH_NO_NATIVE is set"
    assert_jax_native()


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_native_equals_jax_native(case):
    p, path = case
    params = PARAM_SETS[p]
    got = tcompiler._compile_world_native(path, params, frozenset())
    want = jcompiler._compile_world_native(path, jax_params(params),
                                           frozenset())
    assert got is not None and want is not None
    assert_worlds_equal(got, want)


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_native_matches_python_path(case):
    p, path = case
    params = PARAM_SETS[p]
    nat = tcompiler._compile_world_native(path, params, frozenset())
    py = tcompiler._compile_world_py(path, params, frozenset())
    assert_worlds_close(nat, py)


@pytest.mark.parametrize("path", [SYNTHETIC_SCENE, POOL_SCENES[0]],
                         ids=["synthetic", "pool"])
def test_native_deleted_agents(path):
    params = Params(polyline_reduction_threshold=0.5, ignore_non_vehicles=True)
    py_all = tcompiler._compile_world_py(path, params, frozenset())
    victim = frozenset({int(py_all.agent["aid"][0])})
    nat = tcompiler._compile_world_native(path, params, victim)
    assert_worlds_close(nat, tcompiler._compile_world_py(path, params, victim))
    assert_worlds_equal(nat, jcompiler._compile_world_native(
        path, jax_params(params), victim))
    assert min(victim) not in nat.agent["aid"][: nat.num_agents]
    assert nat.num_agents == py_all.num_agents - 1


def test_compile_world_prefers_native(monkeypatch):
    """compile_world gives the native path's bits and never calls the
    Python path for a scene the C++ accepts."""
    def no_python(*a, **k):
        raise AssertionError("the Python path ran")

    monkeypatch.setattr(tcompiler, "_compile_world_py", no_python)
    tcompiler.compile_world.cache_clear()
    try:
        got = tcompiler.compile_world(POOL_SCENES[1], Params())
    finally:
        tcompiler.compile_world.cache_clear()
    assert_worlds_equal(got, tcompiler._compile_world_native(
        POOL_SCENES[1], Params(), frozenset()))


def test_no_native_env_takes_python_path(monkeypatch):
    def no_native(*a, **k):
        raise AssertionError("the native compiler ran")

    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    monkeypatch.setattr(native, "compile_scene_native", no_native)
    assert not native.enabled()
    tcompiler.compile_world.cache_clear()
    try:
        got = tcompiler.compile_world(POOL_SCENES[2], Params())
    finally:
        tcompiler.compile_world.cache_clear()
    assert_worlds_equal(got, tcompiler._compile_world_py(
        POOL_SCENES[2], Params(), frozenset()))


def test_declined_scene_counts_one_fallback(tmp_path):
    """A JSON the C++ parser declines (``objects`` a string, not an array:
    return code -2) while Python's loader reads it (an empty string is no
    objects) compiles with the Python path, counts one fallback and
    warns."""
    blob = json.load(open(SYNTHETIC_SCENE))
    blob["objects"] = ""
    path = str(tmp_path / "no_objects.json")
    with open(path, "w") as f:
        json.dump(blob, f)
    native.reset_fallbacks()
    tcompiler.compile_world.cache_clear()
    try:
        with pytest.warns(RuntimeWarning, match="declined"):
            got = tcompiler.compile_world(path, Params())
        assert native.fallbacks() == 1
        assert tcompiler._compile_world_native(
            path, Params(), frozenset()) is None
        assert native.fallbacks() == 2
    finally:
        tcompiler.compile_world.cache_clear()
        native.reset_fallbacks()
    assert got.num_agents == 0 and got.num_roads > 0
    assert_worlds_equal(got, tcompiler._compile_world_py(
        path, Params(), frozenset()))


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises with g++'s message; compile_world does
    not fall back to the Python path."""
    bad = tmp_path / "scene_compiler.cpp"
    bad.write_text("int broken( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ exited") as e:
        native.build(bad)
    assert "scene_compiler.cpp" in str(e.value)  # g++'s own diagnostic
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    tcompiler.compile_world.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
            tcompiler.compile_world(SYNTHETIC_SCENE, Params())
    finally:
        tcompiler.compile_world.cache_clear()
    assert not list((tmp_path / "build").glob("*"))  # no half library left


def test_available_answers_without_raising(tmp_path, monkeypatch):
    """``available()`` is the JAX package's: True where scenes compile
    natively, False with the native path switched off or a library that
    does not build, where ``load`` raises."""
    assert native.available() and jnative.available()
    monkeypatch.setenv(native.NO_NATIVE_ENV, "1")
    assert not native.available()
    monkeypatch.delenv(native.NO_NATIVE_ENV)
    bad = tmp_path / "scene_compiler.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
        native.load()


def test_concurrent_builds_leave_one_library(tmp_path, monkeypatch):
    """Builds that run at once (the test workers', the prefetch threads')
    each write a temporary file and move it into place: one library, no
    temporary file left, and it loads."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    errors = []

    def run():
        try:
            native.build()
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert [p.name for p in tmp_path.iterdir()] == [
        native.library_path().name]
    import ctypes

    ctypes.CDLL(str(native.library_path()))

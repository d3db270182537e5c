"""The grid and top-K agent-road collision paths of the port
(gpudrive_lab_torch/scene/grid.py, core/collision.py) against the JAX
package on the same inputs:

  * the collision grid, bit for bit: origin, dims, cell size and table of
    ``build_collision_grid``, and each cell of ``build_world_grid``, over
    tests/data/*.json, a slice of data/pool_v3 and 2 large-map worlds of
    10,240 roads; every road registered in some cell;
  * 25 steps with seeded random actions: the port's grid path against the
    JAX grid path, and the port's top-K (approx_top_k both ways, an alias
    of the exact torch.topk) against the JAX exact top-K, collision flags
    exactly, positions within 1e-6 (against JAX also within 1e-5 of their
    magnitude: JAX_POS_RTOL); each against the port's dense path;
  * the dispatch: K >= R goes dense, the grid asked for on a scene without
    one goes dense or through the road tiles, top-K keeps the tiles off;
  * an env with ``use_collision_grid`` reset, stepped and swapped against
    the JAX env.

Top-K is an approximation: a hit is missed when K or more roads score
below it, in both packages.  It is held against dense only where the test
shows that cannot happen (fewer than K candidates score at or below the
hit).  torch.topk does not promise JAX's order among equal scores; a tie at
the K-th score changes the flags only if a hit sits exactly on the cut,
which the equality with the JAX flags would show.
"""

import dataclasses
import glob
import os
import types

import jax
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.core import step as jstep
from gpudrive_lab_tpu.env.config import EnvConfig as JaxEnvConfig
from gpudrive_lab_tpu.env.env_jax import GPUDriveTPUEnv
from gpudrive_lab_tpu.scene import compiler as jcompiler
from gpudrive_lab_tpu.scene import grid as jgrid
from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import collision
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.core.types import CollisionBehaviour, Params
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.rollout import SLICE_CONFIG
from gpudrive_lab_torch.scene import compiler as tcompiler
from gpudrive_lab_torch.scene import grid as tgrid
from gpudrive_lab_torch.scene.compiler import build_scene
from gpudrive_lab_torch.scene.large_map import large_map_scene
from torch_parity import (
    POOL_SCENES,
    ROOT,
    assert_jax_native,
    assert_obs_match,
    jax_params,
    scene_to_jax,
)

TEST_SCENES = sorted(glob.glob(os.path.join(ROOT, "tests", "data", "*.json")))
STEP_SCENES = POOL_SCENES[40:46] + TEST_SCENES
BASE = Params(polyline_reduction_threshold=0.1, ignore_non_vehicles=True,
              collision_behaviour=CollisionBehaviour.IGNORE)
GRID = dataclasses.replace(BASE, use_collision_grid=True)
STEPS = 25


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_grids_equal(got, want):
    for f in ("origin", "cell_size", "dims", "table"):
        a, b = _np(getattr(got, f)), _np(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture(scope="module")
def worlds():
    """The compiled worlds of tests/data and a pool_v3 slice, from both
    packages' compilers (the same C++ source: equal arrays)."""
    assert_jax_native()
    paths = TEST_SCENES + POOL_SCENES[::64]
    tw = [tcompiler.compile_world(p, BASE, frozenset()) for p in paths]
    jw = [jcompiler.compile_world(p, jax_params(BASE), frozenset())
          for p in paths]
    for a, b in zip(tw, jw):
        for k in ("pos", "yaw", "scale"):
            np.testing.assert_array_equal(a.road[k], b.road[k])
    return tw, jw


@pytest.fixture(scope="module")
def large_roads():
    """Two large-map worlds as road arrays: 10,240 roads each."""
    scene, _, _ = large_map_scene(W=2, A=32, R=10240, n_active=8,
                                  device="cpu", seed=3)
    r = scene.roads
    roads = [({"pos": r.pos[w].numpy(), "yaw": r.yaw[w].numpy(),
               "scale": r.scale[w].numpy()}, 10240) for w in range(2)]
    return scene, roads


def test_grid_table_matches_jax(worlds):
    tw, jw = worlds
    _assert_grids_equal(tgrid.build_collision_grid(tw, device="cpu"),
                        jgrid.build_collision_grid(jw))
    for cs in (20.0, 75.0):
        _assert_grids_equal(
            tgrid.build_collision_grid(tw, cs, device="cpu"),
            jgrid.build_collision_grid(jw, cs))


def test_world_grid_cells_match_jax_and_cover_every_road(worlds):
    for w in worlds[0]:
        origin, dims, cells = tgrid.build_world_grid(w.road, w.num_roads)
        jorigin, jdims, jcells = jgrid.build_world_grid(w.road, w.num_roads)
        np.testing.assert_array_equal(origin, jorigin)
        assert origin.dtype == jorigin.dtype and dims == jdims
        assert [c.tolist() for c in cells] == jcells
        registered = set(np.concatenate(cells).tolist())
        assert registered == set(range(w.num_roads))
    origin, dims, cells = tgrid.build_world_grid({}, 0)
    assert dims == (1, 1) and [c.tolist() for c in cells] == [[]]


def test_large_map_grid_matches_jax(large_roads):
    scene, roads = large_roads
    got = tgrid.build_collision_grid(roads, device="cpu")
    want = jgrid.build_collision_grid(
        [types.SimpleNamespace(road=r, num_roads=n) for r, n in roads])
    _assert_grids_equal(got, want)
    _assert_grids_equal(scene.grid, want)
    assert got.table.shape[-1] > 100  # a dense map: many roads per cell
    for road, n in roads:
        _, _, cells = tgrid.build_world_grid(road, n)
        assert set(np.concatenate(cells).tolist()) == set(range(n))


@pytest.fixture(scope="module")
def step_scenes():
    assert_jax_native()
    dense = build_scene(STEP_SCENES, BASE, device="cpu")
    grid = build_scene(STEP_SCENES, GRID, device="cpu")
    assert dense.grid is None and grid.grid is not None
    jgrid_scene = jcompiler.build_scene(STEP_SCENES, jax_params(GRID))
    _assert_grids_equal(grid.grid, jgrid_scene.grid)
    return dense, grid


def _actions(rng, W):
    acts = np.zeros((W, C.MAX_AGENTS, C.ACTION_DIM), np.float32)
    acts[..., 0] = rng.uniform(-4, 4, (W, C.MAX_AGENTS))
    acts[..., 1] = rng.uniform(-0.5, 0.5, (W, C.MAX_AGENTS))
    return acts


def _assert_flags(a, b, where, rtol=0.0):
    """collided and collided_road equal; positions within 1e-6, and
    within ``rtol`` of their magnitude."""
    for f in ("collided", "collided_road"):
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)),
                                      err_msg=f"{f} {where}")
    np.testing.assert_allclose(_np(a.pos), _np(b.pos), rtol=rtol,
                               atol=1e-6, err_msg=f"pos {where}")


# The port's dynamics are a few float32 ulps from the JAX package's (the
# step parity bar is 1e-3, tests/test_torch_step.py): positions of tens of
# metres, whose ulp is up to 7.6e-6, agree to 2.4e-6 of their magnitude
# after 25 steps.  Between the port's own paths (grid, top-K, dense) they
# are equal.
JAX_POS_RTOL = 1e-5


def _topk_safe(scene, state, k):
    """True when top-K cannot miss a dense hit: for every agent that hits
    a road, at most K allowed roads score at or below its best-scoring hit
    (ties included), so that hit is among the K candidates."""
    from gpudrive_lab_torch.core import obb

    roads = scene.roads
    half = collision.agent_half_extents(scene)
    d = torch.sqrt(((roads.pos[:, None, :, 0:2]
                     - state.pos[:, :, None, :]) ** 2).sum(-1))
    score = d - roads.scale[:, None, :, 0]
    allowed = (roads.valid[:, None, :]
               & collision._road_allowed(scene.agents.etype[:, :, None],
                                         roads.etype[:, None, :]))
    hit = obb.obb_overlap_sat(
        state.pos[:, :, None, :], state.yaw[:, :, None], half[:, :, None],
        roads.pos[:, None, :, 0:2], roads.yaw[:, None, :],
        roads.scale[:, None, :, 0:2]) & allowed
    best = torch.where(hit, score, torch.inf).amin(-1, keepdim=True)
    need = ((score <= best) & allowed).sum(-1)
    return bool((need[hit.any(-1)] <= k).all())


def test_grid_path_matches_jax_and_dense(step_scenes):
    dense, grid = step_scenes
    jscene = scene_to_jax(grid)
    jp = jax_params(GRID)
    jstep_fn = jax.jit(jstep.step, static_argnames="params")
    sd = stepmod.reset(dense, None, BASE)
    sg = stepmod.reset(grid, None, GRID)
    js = jax.jit(jstep.reset, static_argnames="params")(jscene, None, jp)
    rng = np.random.default_rng(0)
    hits = 0
    for t in range(STEPS):
        a = _actions(rng, dense.num_worlds)
        sd = stepmod.step(dense, sd, torch.from_numpy(a), BASE)
        sg = stepmod.step(grid, sg, torch.from_numpy(a), GRID)
        js = jstep_fn(jscene, js, a, jp)
        _assert_flags(sg, js, f"grid vs JAX, step {t}", JAX_POS_RTOL)
        _assert_flags(sg, sd, f"grid vs dense, step {t}")
        hits += int(sd.collided_road.sum())
    assert hits > 0  # the random drive hits road edges


@pytest.mark.parametrize("approx", [False, True])
def test_top_k_matches_jax_exact_and_dense(step_scenes, approx):
    dense, _ = step_scenes
    k = 32
    tp = dataclasses.replace(BASE, collision_top_k=k, approx_top_k=approx)
    jp = jax_params(dataclasses.replace(tp, approx_top_k=False))
    jscene = scene_to_jax(dense)
    jstep_fn = jax.jit(jstep.step, static_argnames="params")
    sd = stepmod.reset(dense, None, BASE)
    sk = stepmod.reset(dense, None, tp)
    js = jax.jit(jstep.reset, static_argnames="params")(jscene, None, jp)
    rng = np.random.default_rng(1)
    for t in range(STEPS):
        a = _actions(rng, dense.num_worlds)
        assert _topk_safe(dense, sk, k), f"K={k} could miss a hit at {t}"
        sd = stepmod.step(dense, sd, torch.from_numpy(a), BASE)
        sk = stepmod.step(dense, sk, torch.from_numpy(a), tp)
        js = jstep_fn(jscene, js, a, jp)
        _assert_flags(sk, js, f"top-k vs JAX, step {t}", JAX_POS_RTOL)
        _assert_flags(sk, sd, f"top-k vs dense, step {t}")


def test_top_k_below_the_hits_misses_them_as_in_jax():
    """On the large map two agents' best-scoring hit ranks second among
    their allowed roads, so K = 1 misses them: both packages miss the same
    ones, and K = 2 finds every hit."""
    from gpudrive_lab_tpu.core import collision as jcollision
    from torch_parity import state_to_jax

    scene, state, cur = large_map_scene(W=4, A=32, R=10240, n_active=24,
                                        device="cpu", seed=0)
    p = dataclasses.replace(BASE, use_tile_collision=False)
    dense = collision.collision_system(scene, state, p, cur)
    jscene, jstate = scene_to_jax(scene), state_to_jax(state)
    missed = []
    for k in (1, 2):
        tp = dataclasses.replace(p, collision_top_k=k)
        topk = collision.collision_system(scene, state, tp, cur)
        js = jcollision.collision_system(jscene, jstate, jax_params(tp),
                                         cur.numpy())
        _assert_flags(topk, js, f"top-k {k} vs JAX")
        missed.append(int(dense.collided_road.sum())
                      - int(topk.collided_road.sum()))
        assert _topk_safe(scene, state, k) == (missed[-1] == 0)
    assert missed == [2, 0]


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


@pytest.mark.parametrize("case", ["k_at_r", "grid_without_grid",
                                  "grid_without_grid_tiles", "k_at_r_tiles",
                                  "k_below_r_tiles"])
def test_dispatch_edge_cases(monkeypatch, case):
    """Which agent-road path runs, as gpudrive_lab_tpu/core/collision.py:
    171-179 selects it: K >= R is dense (also with road tiles present);
    the grid asked for on a scene without one is dense, or tiles when the
    scene has them; any K keeps the tiles off.  Flags equal the JAX
    package's in every case."""
    tiles = case.endswith("tiles")
    build = dataclasses.replace(BASE, use_tile_collision=True if tiles
                                else None)
    scene = build_scene(POOL_SCENES[40:42], build, device="cpu")
    assert scene.grid is None and (scene.rtiles is not None) == tiles
    R = scene.max_roads
    p = {"k_at_r": dataclasses.replace(build, collision_top_k=R),
         "k_at_r_tiles": dataclasses.replace(build, collision_top_k=R + 1),
         "k_below_r_tiles": dataclasses.replace(build, collision_top_k=16),
         "grid_without_grid": dataclasses.replace(build,
                                                  use_collision_grid=True),
         "grid_without_grid_tiles": dataclasses.replace(
             build, use_collision_grid=True)}[case]
    spies = {name: _Spy(getattr(collision, name)) for name in (
        "agent_road_hits_dense", "_tiled_road_hits", "_top_k_candidates",
        "_grid_candidates")}
    for name, spy in spies.items():
        monkeypatch.setattr(collision, name, spy)
    state = stepmod.reset(scene, None, p)
    a = _actions(np.random.default_rng(2), scene.num_worlds)
    state = stepmod.step(scene, state, torch.from_numpy(a), p)
    want = {"k_at_r": "agent_road_hits_dense",
            "k_at_r_tiles": "agent_road_hits_dense",
            "k_below_r_tiles": "_top_k_candidates",
            "grid_without_grid": "agent_road_hits_dense",
            "grid_without_grid_tiles": "_tiled_road_hits"}[case]
    assert {n for n, s in spies.items() if s.calls} == {want}
    jp = jax_params(p)
    jscene = scene_to_jax(scene)
    js = jstep.step(jscene, jstep.reset(jscene, None, jp), a, jp)
    _assert_flags(state, js, case)


def test_env_with_grid_matches_jax():
    """EnvConfig(use_collision_grid=True): reset, random steps, a swap to
    another batch and more steps; obs, rewards, dones and infos as the JAX
    env's, the grid carried through the swap."""
    assert_jax_native()
    kw = dict(SLICE_CONFIG, use_collision_grid=True)
    first, second = POOL_SCENES[40:42], TEST_SCENES[:2]
    env = GPUDriveTorchEnv(EnvConfig(**kw), first, device="cpu")
    jenv = GPUDriveTPUEnv(JaxEnvConfig(**kw), scene_paths=first)
    rng = np.random.default_rng(3)

    def check():
        assert env.scene.grid is not None and jenv.scene.grid is not None
        _assert_grids_equal(env.scene.grid, jenv.scene.grid)
        assert_obs_match(env, jenv, env.get_obs(), jenv.get_obs())
        np.testing.assert_array_equal(_np(env.get_rewards()),
                                      _np(jenv.get_rewards()))
        np.testing.assert_array_equal(_np(env.get_dones()),
                                      _np(jenv.get_dones()))
        for k, v in env.get_infos().items():
            np.testing.assert_array_equal(_np(v), _np(jenv.get_infos()[k]))

    def steps(n):
        for _ in range(n):
            idx = rng.integers(0, env.action_space_n,
                               (env.num_worlds, env.max_agent_count))
            env.step_dynamics(torch.from_numpy(idx))
            jenv.step_dynamics(idx)
            check()

    check()
    steps(3)
    env.swap_data_batch(second)
    jenv.swap_data_batch(second)
    check()
    steps(3)

"""Sensor parity: the port's lidar, BEV and camera, the map and absolute
self observations, frame stacking and the env's sensor getters against the
JAX package on the same inputs, on the CPU.

Bars: lidar types, BEV cell types and camera colours exact (colour within
one step), floats within 1e-4 (relative beyond 1 m, as the JAX package's
own lidar tests compare: rtol = atol = 1e-4), apart from boundary cases that
``gpudrive_lab_torch.utils.sensor_parity`` shows lie within 1e-5 m of a box
edge, the range or the radius.  The behaviour checks of test_lidar_bev.py
and test_render.py that need no reference data run here on the port, on the
JAX package's synthetic scene.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.core import bev as jbev
from gpudrive_lab_tpu.core import lidar as jlidar
from gpudrive_lab_tpu.core import observations as jobs
from gpudrive_lab_tpu.core import render as jrender
from gpudrive_lab_tpu.core import step as jstep
from gpudrive_lab_tpu.core.types import Params as JaxParams
from gpudrive_lab_tpu.env.config import EnvConfig as JaxEnvConfig
from gpudrive_lab_tpu.env.env_jax import GPUDriveTPUEnv
from gpudrive_lab_tpu.scene.synthetic import synthetic_scene
from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import observations as tobs
from gpudrive_lab_torch.core.bev import bev_observation
from gpudrive_lab_torch.core.lidar import lidar_observation
from gpudrive_lab_torch.core.render import (
    EYE_HEIGHT,
    CameraConfig,
    _pixel_dirs,
    batch_render,
    free_camera_render,
)
from gpudrive_lab_torch.core.types import Params
from gpudrive_lab_torch.env.config import EnvConfig
from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
from gpudrive_lab_torch.rollout import (
    SLICE_CONFIG,
    rollout,
    slice_env,
    slice_policy,
)
from gpudrive_lab_torch.utils import sensor_parity
from torch_parity import (
    POOL_SCENES,
    jax_params,
    python_scene_compiler,
    scene_to_jax,
    scene_to_torch,
    state_to_jax,
    state_to_torch,
)

jlidar_fn = jax.jit(jlidar.lidar_observation,
                    static_argnames=("params", "road_chunk", "world_group"))
jbev_fn = jax.jit(jbev.bev_observation,
                  static_argnames=("params", "agent_chunk"))
PARAMS = Params(observation_radius=50.0)


@pytest.fixture(scope="module")
def pool():
    """Four pool worlds with 16-row agent buckets after five random steps:
    (scene, state, params, actions [W, A, 10] from a seed) in the port,
    and the same in the JAX package."""
    env = slice_env(POOL_SCENES[100:104], device="cpu", agent_bucket="auto")
    gen = torch.Generator().manual_seed(0)
    W, A = env.num_worlds, env.max_agent_count
    for _ in range(5):
        env.step_dynamics(torch.randint(0, env.action_space_n, (W, A),
                                        generator=gen))
    acts = np.random.default_rng(0).normal(size=(W, A, C.ACTION_DIM))
    acts = torch.from_numpy(acts.astype(np.float32))
    return (env.scene, env.state, env.params, acts,
            scene_to_jax(env.scene), state_to_jax(env.state),
            jax_params(env.params), jnp.asarray(acts.numpy()))


@pytest.fixture(scope="module")
def synthetic():
    """The JAX package's straight-road scene (4 agents, road edges at
    y = +-10) after reset, in both packages."""
    js = synthetic_scene(num_worlds=1, num_agents=4, num_roads=16)
    jst = jax.jit(jstep.reset, static_argnames="params")(
        js, None, JaxParams(observation_radius=50.0))
    return scene_to_torch(js), state_to_torch(jst), js, jst


def assert_explained(report, what):
    assert not report["unexplained"], (
        f"{what}: {len(report['unexplained'])} of {report['mismatches']} "
        f"differences are not boundary cases: {report['unexplained'][:3]}")


# ---- lidar -----------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"road_chunk": 64}, {"road_chunk": 96}, {"world_group": 1},
    {"world_group": 3},
], ids=["dense", "chunk64", "chunk96", "group1", "group3"])
def test_lidar_matches_jax(pool, kw):
    scene, state, params, acts, js, jst, jp, jacts = pool
    got = lidar_observation(scene, state, params, acts, **kw)
    want = torch.from_numpy(np.array(jlidar_fn(js, jst, jp, jacts, **kw)))
    assert got.shape == want.shape == (4, scene.max_agents, 3, 50, 4)
    report = sensor_parity.lidar_diff(scene, state, acts, got, want,
                                      depth_tol=1e-4)
    assert_explained(report, "lidar")
    same = got[..., 1] == want[..., 1]
    np.testing.assert_allclose(got[same].numpy(), want[same].numpy(),
                               rtol=1e-4, atol=1e-4)
    # every grouping gives the dense result bit for bit
    assert torch.equal(got, lidar_observation(scene, state, params, acts))
    assert (got[..., 1] > 0).sum() > 100  # the rays hit something


def test_lidar_shapes_and_planes(synthetic):
    scene, state, _, _ = synthetic
    lid = lidar_observation(scene, state, PARAMS,
                            torch.zeros((1, C.MAX_AGENTS, C.ACTION_DIM)))
    assert lid.shape == (1, C.MAX_AGENTS, 3, C.NUM_LIDAR_SAMPLES, 4)
    assert (lid[0, 4:] == 0).all()  # agents not created
    assert (lid[0, :4, :, :, 0] >= 0).all()
    assert (lid[0, :4, :, :, 0] <= C.LIDAR_DISTANCE + 1e-3).all()
    # cars plane and road-line plane never report road edges
    assert C.ET_ROAD_EDGE not in set(lid[0, :4, 0, :, 1].unique().tolist())
    assert C.ET_ROAD_EDGE not in set(lid[0, :4, 2, :, 1].unique().tolist())


def test_lidar_sees_road_edge_at_cone_edge(synthetic):
    """Heading +x between edges at y = +-10: the steepest rays (+-60 deg)
    hit the nearer edge's inner face at (9.9 -+ y0) / sin(60 deg)."""
    scene, state, _, _ = synthetic
    assert abs(float(state.yaw[0, 0])) < 1e-5
    lid = lidar_observation(scene, state, PARAMS,
                            torch.zeros((1, C.MAX_AGENTS, C.ACTION_DIM)))
    y0 = float(state.pos[0, 0, 1])
    expected = min(9.9 - y0, 9.9 + y0) / np.sin(C.LIDAR_ANGLE)
    edge = lid[0, 0, 1]
    hits = edge[edge[:, 1] == C.ET_ROAD_EDGE, 0]
    assert len(hits) > 0
    assert abs(float(hits.min()) - expected) < 0.5


def test_lidar_hits_vehicle_ahead(synthetic):
    """A vehicle moved 15 m dead ahead of agent 0 is the cars plane's
    centre-ray hit, at 15 m less the half length of its 0.7-scaled box."""
    scene, state, _, _ = synthetic
    pos = state.pos.clone()
    pos[0, 1] = pos[0, 0] + torch.tensor([15.0, 0.0])
    state = state.replace(pos=pos, yaw=torch.zeros_like(state.yaw))
    lid = lidar_observation(scene, state, PARAMS,
                            torch.zeros((1, C.MAX_AGENTS, C.ACTION_DIM)))
    centre = lid[0, 0, 0, C.NUM_LIDAR_SAMPLES // 2]
    half_len = 0.5 * C.VEHICLE_LENGTH_SCALE * float(scene.agents.size[0, 1, 0])
    assert int(centre[1]) == C.ET_VEHICLE
    assert abs(float(centre[0]) - (15.0 - half_len)) < 1e-3
    assert abs(float(centre[2]) - float(centre[0])) < 1e-3  # straight ahead


def test_lidar_head_angle_turns_the_cone(pool):
    """Controlled agents' rays turn with actions[..., 2]; others' do not."""
    scene, state, params, acts, *_ = pool
    base = lidar_observation(scene, state, params, torch.zeros_like(acts))
    turned = lidar_observation(scene, state, params, acts)
    ctrl = scene.agents.controlled & scene.agents.valid
    assert not torch.equal(base[ctrl], turned[ctrl])
    still = scene.agents.valid & ~scene.agents.controlled
    assert torch.equal(base[still], turned[still])


# ---- BEV -------------------------------------------------------------------

def _first_worlds(obj, n):
    """A Scene or SimState cut to its first n worlds."""
    return type(obj)(**{
        f: _first_worlds(v, n) if dataclasses.is_dataclass(v)
        else v if v is None else v[:n]
        for f, v in vars(obj).items()})


@pytest.fixture(scope="module")
def pool_bev(pool):
    """The JAX BEV of the pool worlds: gathered (agent_chunk 8) on all
    four, dense on the first two."""
    scene, state, params, _, js, jst, jp, _ = pool
    two = [_first_worlds(x, 2) for x in (scene, state)]
    gathered = torch.from_numpy(np.array(jbev_fn(js, jst, jp)))
    dense = torch.from_numpy(np.array(jbev_fn(
        scene_to_jax(two[0]), state_to_jax(two[1]), jp, agent_chunk=0)))
    return two, gathered, dense


@pytest.mark.parametrize("agent_chunk", [None, 5, 0],
                         ids=["budget", "chunk5", "dense"])
def test_bev_matches_jax(pool, pool_bev, agent_chunk):
    scene, state, params, *_ = pool
    (scene2, state2), gathered, dense = pool_bev
    if agent_chunk == 0:  # the dense oracles, on two worlds
        scene, state, want = scene2, state2, dense
    else:
        want = gathered
    got = bev_observation(scene, state, params, agent_chunk=agent_chunk)
    assert got.shape == want.shape
    assert got.shape[2:] == (200, 200, 1)
    assert_explained(sensor_parity.bev_diff(scene, state, params, got, want),
                     "BEV")
    assert (got > 0).sum() > 1_000  # something was painted


def test_bev_dense_matches_gathered(pool, pool_bev):
    """The port's dense oracle (all R roads, no first-K gather) and its
    gathered path agree, up to boundary cases of the radius test."""
    params = pool[2]
    (scene, state), _, _ = pool_bev
    got = bev_observation(scene, state, params)
    dense = bev_observation(scene, state, params, agent_chunk=0)
    assert_explained(sensor_parity.bev_diff(scene, state, params, got,
                                            dense), "BEV dense")


def test_bev_shapes_and_contents(synthetic):
    scene, state, _, _ = synthetic
    bev = bev_observation(scene, state, PARAMS)
    assert bev.shape == (1, C.MAX_AGENTS, C.BEV_RESOLUTION,
                         C.BEV_RESOLUTION, 1)
    vals = set(bev[0, :4].unique().tolist())
    assert vals <= {0.0, float(C.ET_ROAD_EDGE), float(C.ET_VEHICLE)}
    assert float(C.ET_ROAD_EDGE) in vals and float(C.ET_VEHICLE) in vals
    assert (bev[0, 4:] == 0).all()


def test_bev_vehicle_cell_positions(synthetic):
    """Every cell painted as a vehicle lies near one partner position."""
    scene, state, _, _ = synthetic
    grid = bev_observation(scene, state, PARAMS)[0, 0, :, :, 0].numpy()
    res, radius = C.BEV_RESOLUTION, PARAMS.observation_radius
    cells = np.argwhere(grid == C.ET_VEHICLE)
    assert len(cells) > 0
    ys = cells[:, 0] * (2 * radius / res) - radius
    xs = cells[:, 1] * (2 * radius / res) - radius
    rel = (state.pos[0, 1:4] - state.pos[0, 0]).numpy()
    d = np.min(np.hypot(xs[:, None] - rel[None, :, 0],
                        ys[:, None] - rel[None, :, 1]), axis=1)
    assert d.max() < 4.0


# ---- camera ----------------------------------------------------------------

def _jax_camera(cfg):
    return jrender.CameraConfig(height=cfg.height, width=cfg.width,
                                hfov_deg=cfg.hfov_deg,
                                max_depth=cfg.max_depth)


@pytest.mark.parametrize("chunk", [None, 3], ids=["budget", "chunk3"])
def test_batch_render_matches_jax(pool, chunk):
    scene, state, _, _, js, jst, _, _ = pool
    cfg = CameraConfig(height=16, width=16, agent_chunk=chunk)
    got = batch_render(scene, state, cfg)
    want = tuple(torch.from_numpy(np.array(x))
                 for x in jrender.batch_render(js, jst, _jax_camera(cfg)))
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.float32
    assert got[0].shape == want[0].shape == (4, scene.max_agents, 16, 16, 4)
    assert got[1].shape == want[1].shape == (4, scene.max_agents, 16, 16, 1)
    assert_explained(sensor_parity.camera_diff(scene, state, cfg, got, want,
                                               depth_tol=1e-4), "camera")
    assert (got[0].int() - want[0].int()).abs().max() <= 1
    assert (got[1] > 0).sum() > 100


def test_free_camera_matches_jax(pool):
    scene, state, _, _, js, jst, _, _ = pool
    cfg = CameraConfig(height=16, width=16)
    for world, eye, yaw, pitch, excl in (
            (1, (3.0, -2.0, 12.0), 0.7, -0.4, -1),
            (2, (float(state.pos[2, 0, 0]), float(state.pos[2, 0, 1]), 2.5),
             float(state.yaw[2, 0]), 0.0, 0)):
        got = free_camera_render(scene, state, torch.tensor(eye), yaw,
                                 pitch, cfg, world=world, exclude_agent=excl)
        want = jrender.free_camera_render(
            js, jst, jnp.asarray(eye, jnp.float32), jnp.float32(yaw),
            jnp.float32(pitch), _jax_camera(cfg), world=world,
            exclude_agent=excl)
        d = (got[0].int() - torch.from_numpy(np.array(want[0])).int())
        assert d.abs().max() <= 1
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def rendered(synthetic):
    scene, state, _, _ = synthetic
    cfg = CameraConfig(height=24, width=32, agent_chunk=2)
    rgb, depth = batch_render(scene, state, cfg)
    return scene, state, cfg, rgb, depth


def test_render_exports_and_empty_views(rendered):
    scene, state, cfg, rgb, depth = rendered
    assert rgb.shape == (1, C.MAX_AGENTS, 24, 32, 4)
    assert rgb.dtype == torch.uint8
    assert depth.shape == (1, C.MAX_AGENTS, 24, 32, 1)
    invalid = ~scene.agents.valid
    assert (rgb[invalid] == 0).all() and (depth[invalid] == 0).all()
    hits = depth[scene.agents.valid]
    hits = hits[hits > 0]
    assert hits.numel() > 0 and (hits <= cfg.max_depth + 1e-3).all()


def test_free_camera_equals_batch_view_at_agent_pose(rendered):
    scene, state, cfg, rgb, depth = rendered
    eye = torch.cat([state.pos[0, 0], state.z[0, 0:1] + EYE_HEIGHT])
    frgb, fdepth = free_camera_render(scene, state, eye, state.yaw[0, 0],
                                      0.0, cfg, world=0, exclude_agent=0)
    assert torch.equal(frgb, rgb[0, 0])
    np.testing.assert_allclose(fdepth.numpy(), depth[0, 0, :, :, 0].numpy(),
                               rtol=1e-6)


def test_agent_ahead_is_seen(synthetic):
    scene, state, _, _ = synthetic
    pos, yaw = state.pos.clone(), state.yaw.clone()
    pos[0, 0], pos[0, 1] = torch.tensor([0.0, 0.0]), torch.tensor([20.0, 0.0])
    yaw[0, :2] = 0.0
    state = state.replace(pos=pos, yaw=yaw)
    _, depth = batch_render(scene, state, CameraConfig(height=32, width=32))
    centre = depth[0, 0, 14:18, 14:18, 0]
    hit = centre[centre > 0]
    assert hit.numel() > 0 and ((hit - 20.0).abs() < 5.0).all()


def test_free_camera_pitch_down_sees_roof(synthetic):
    scene, state, _, _ = synthetic
    over = torch.cat([state.pos[0, 0], torch.tensor([30.0])])
    _, depth = free_camera_render(scene, state, over, 0.0, -np.pi / 2,
                                  CameraConfig(height=17, width=17))
    box_top = float(state.z[0, 0]) + 0.7
    assert abs(float(depth[8, 8]) - (30.0 - box_top)) < 0.5


def test_sky_ground_split_and_pixel_dirs(synthetic):
    scene, state, _, _ = synthetic
    pos = state.pos.clone()
    pos[0, 0] = torch.tensor([10000.0, 10000.0])
    rgb, depth = batch_render(scene, state.replace(pos=pos),
                              CameraConfig(height=16, width=16))
    assert (depth[0, 0] == 0).all()
    assert rgb[0, 0, 0, 8, :3].tolist() == [153, 204, 255]
    assert rgb[0, 0, -1, 8, :3].tolist() == [70, 80, 70]
    d = _pixel_dirs(CameraConfig(height=16, width=16))
    np.testing.assert_array_equal(
        d, jrender._pixel_dirs(jrender.CameraConfig(height=16, width=16)))
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    assert d[:, 0, 1].mean() > 0 and d[:, -1, 1].mean() < 0
    assert d[0, :, 2].mean() > 0 and d[-1, :, 2].mean() < 0


# ---- the boundary-case check itself ----------------------------------------

def test_sensor_parity_flags_a_fault(pool):
    """A changed type, depth or colour away from any box edge is reported
    as unexplained; equal outputs report nothing."""
    scene, state, params, acts, *_ = pool
    lid = lidar_observation(scene, state, params, acts)
    assert sensor_parity.lidar_diff(scene, state, acts, lid, lid) == {
        "mismatches": 0, "unexplained": []}
    idx = (lid[..., 1] > 0).nonzero()[0].tolist()
    bad = lid.clone()
    bad[tuple(idx) + (1,)] = 9.0 if lid[tuple(idx) + (1,)] != 9 else 8.0
    bad[(0, 0, 0, 0, 0)] = 1.0 if lid[0, 0, 0, 0, 0] == 0 else 0.0
    rep = sensor_parity.lidar_diff(scene, state, acts, bad, lid)
    assert rep["mismatches"] == 2 and len(rep["unexplained"]) == 2

    bev = bev_observation(scene, state, params)
    worse = bev.clone()
    worse[0, 0, 100, 100, 0] = 42.0
    rep = sensor_parity.bev_diff(scene, state, params, worse, bev)
    assert rep["mismatches"] == 1 and len(rep["unexplained"]) == 1

    cfg = CameraConfig(height=16, width=16)
    rgb, depth = batch_render(scene, state, cfg)
    off = rgb.clone()
    off[0, 0, 3, 3, 0] = (int(rgb[0, 0, 3, 3, 0]) + 2) % 256
    rep = sensor_parity.camera_diff(scene, state, cfg, (off, depth),
                                    (rgb, depth))
    assert rep["mismatches"] == 1 and len(rep["unexplained"]) == 1


def test_sensor_parity_explains_boundary_cases(synthetic):
    """Built boundary cases: a second road box on top of the road that a
    ray sees, of another type (a tie: the first index wins), and a road
    whose BEV edge passes through a cell centre.  The tie's other winner,
    or the other side of the edge, is explained; a change elsewhere is
    not."""
    scene, state, _, _ = synthetic
    state = state.replace(yaw=torch.zeros_like(state.yaw))
    acts = torch.zeros((1, C.MAX_AGENTS, C.ACTION_DIM))
    lid = lidar_observation(scene, state, PARAMS, acts)
    a, k = (int(x) for x in
            (lid[0, :4, 1, :, 1] == C.ET_ROAD_EDGE).nonzero()[0])
    seen = _nearest_road(scene, state, a, k)

    roads = scene.roads
    pos, scale = roads.pos.clone(), roads.scale.clone()
    yaw, etype, valid = (roads.yaw.clone(), roads.etype.clone(),
                         roads.valid.clone())
    free = int((~valid[0]).nonzero()[0])
    # the tie: road `free` repeats the road the ray sees, as a stop sign
    pos[0, free], scale[0, free] = pos[0, seen], scale[0, seen]
    yaw[0, free], etype[0, free] = yaw[0, seen], C.ET_STOP_SIGN
    valid[0, free] = True
    # the edge: a road of half length 1.999 (+ the 1e-3 cover margin),
    # centred on agent 0, whose end lies on the cell centre 2 m ahead
    pos[0, free + 1, :2] = state.pos[0, 0]
    scale[0, free + 1] = torch.tensor([2 * 1.999, 0.4, 0.1])
    yaw[0, free + 1], etype[0, free + 1] = 0.0, C.ET_CROSSWALK
    valid[0, free + 1] = True
    scene = scene.replace(roads=roads.replace(
        pos=pos, scale=scale, yaw=yaw, etype=etype, valid=valid))

    lid = lidar_observation(scene, state, PARAMS, acts)
    assert int(lid[0, a, 1, k, 1]) == C.ET_ROAD_EDGE  # the first index
    other = lid.clone()
    other[0, a, 1, k, 1] = float(C.ET_STOP_SIGN)
    rep = sensor_parity.lidar_diff(scene, state, acts, other, lid)
    assert rep == {"mismatches": 1, "unexplained": []}
    other[0, a, 1, k, 0] += 0.5  # the same type, 0.5 m further: a fault
    rep = sensor_parity.lidar_diff(scene, state, acts, other, lid)
    assert rep["mismatches"] == 1 and len(rep["unexplained"]) == 1

    bev = bev_observation(scene, state, PARAMS)
    i, j = C.BEV_RESOLUTION // 2, C.BEV_RESOLUTION // 2 + 4  # (2 m, 0 m)
    cell = float(bev[0, 0, i, j, 0])
    assert cell in (0.0, float(C.ET_CROSSWALK))
    flipped = bev.clone()
    flipped[0, 0, i, j, 0] = C.ET_CROSSWALK if cell == 0.0 else 0.0
    rep = sensor_parity.bev_diff(scene, state, PARAMS, flipped, bev)
    assert rep == {"mismatches": 1, "unexplained": []}
    flipped[0, 0, i, j - 8, 0] = 3.0  # 2 m behind: no edge there
    rep = sensor_parity.bev_diff(scene, state, PARAMS, flipped, bev)
    assert rep["mismatches"] == 2 and len(rep["unexplained"]) == 1


def _nearest_road(scene, state, a, k):
    """The road that ray k of agent a (head angle 0) hits first, in
    float64."""
    from gpudrive_lab_torch.utils.sensor_parity import _slab

    S = C.NUM_LIDAR_SAMPLES
    theta = C.LIDAR_ANGLE * (2.0 * torch.tensor(float(k)) / S - 1.0)
    yaw = (state.yaw[0, a] + theta).double()
    d = torch.stack([torch.cos(yaw), torch.sin(yaw)])[None]
    roads = scene.roads
    lo, hi = _slab(state.pos[0, a].double()[None], d,
                   roads.pos[0, None, :, :2].double(),
                   roads.yaw[0, None].double(),
                   roads.scale[0, None, :, :2].double())
    hit = (hi >= lo) & (lo > 0) & roads.valid[0, None]
    return int(torch.where(hit, lo, float("inf"))[0].argmin())


# ---- map and absolute self observations ------------------------------------

def test_map_and_absolute_self_observation_match_jax(pool):
    scene, state, _, _, js, jst, _, _ = pool
    np.testing.assert_array_equal(tobs.map_observation(scene).numpy(),
                                  np.asarray(jobs.map_observation(js)))
    got = tobs.absolute_self_observation(scene, state).numpy()
    want = np.asarray(jobs.absolute_self_observation(js, jst))
    assert got.shape == want.shape == (4, scene.max_agents, 14)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    filler = tobs.map_observation(scene)[~scene.roads.valid]
    assert (filler[:, 7:] == -1).all() and (filler[:, :7] == 0).all()


# ---- the env: stacking and the sensor getters ------------------------------

PATHS = POOL_SCENES[40:42]


@pytest.fixture(scope="module")
def stacked_envs():
    kw = dict(SLICE_CONFIG, num_stack=3, lidar_obs=True, bev_obs=True,
              agent_bucket="auto")
    env = GPUDriveTorchEnv(EnvConfig(**kw), PATHS, device="cpu")
    with python_scene_compiler():
        jenv = GPUDriveTPUEnv(JaxEnvConfig(num_worlds=len(PATHS), **kw),
                              scene_paths=PATHS)
    return env, jenv


def test_stacked_obs_match_jax(stacked_envs):
    env, jenv = stacked_envs
    D = env.spec.obs_dim
    assert env.observation_dim == jenv.observation_dim == 3 * D
    obs, jobs_ = env.reset(), jenv.reset()
    gen = torch.Generator().manual_seed(3)
    prev = None
    for t in range(4):
        got, want = obs.numpy(), np.asarray(jobs_)
        assert got.shape == want.shape == (2, env.max_agent_count, 3 * D)
        # the ego and partner blocks of every stacked frame (KNN road rows
        # are compared in test_torch_env_policy.py)
        for k in range(3):
            np.testing.assert_allclose(got[..., k * D:k * D + 768],
                                       want[..., k * D:k * D + 768],
                                       rtol=1e-5, atol=1e-5)
        if t == 0:
            assert (got[..., :2 * D] == 0).all()  # zeroed at reset
        else:  # the frames shift by one, oldest first
            np.testing.assert_array_equal(got[..., :2 * D], prev[..., D:])
        prev = got
        act = torch.randint(0, env.action_space_n,
                            (2, env.max_agent_count), generator=gen)
        env.step_dynamics(act)
        jenv.step_dynamics(jnp.asarray(act.numpy()))
        obs, jobs_ = env.get_obs(), jenv.get_obs()


def test_env_sensor_getters_match_jax(stacked_envs):
    env, jenv = stacked_envs
    env.reset(), jenv.reset()
    for _ in range(3):
        act = torch.full((2, env.max_agent_count), 40)
        env.step_dynamics(act)
        jenv.step_dynamics(jnp.asarray(act.numpy()))
    scene, state = env.scene, env.state
    zeros = torch.zeros((2, env.max_agent_count, C.ACTION_DIM))
    lid = env.get_lidar_obs()
    assert_explained(sensor_parity.lidar_diff(
        scene, state, zeros, lid,
        torch.from_numpy(np.array(jenv.get_lidar_obs())), depth_tol=1e-4),
        "env lidar")
    assert_explained(sensor_parity.bev_diff(
        scene, state, env.params, env.get_bev_obs(),
        torch.from_numpy(np.array(jenv.get_bev_obs()))), "env BEV")
    cfg = CameraConfig(height=16, width=16)
    got = env.get_camera_obs(cfg)
    want = tuple(torch.from_numpy(np.array(x))
                 for x in jenv.get_camera_obs(_jax_camera(cfg)))
    assert_explained(sensor_parity.camera_diff(scene, state, cfg, got, want,
                                               depth_tol=1e-4), "env camera")
    rgb, depth = env.get_camera_obs()  # the default 64 x 64 camera
    assert rgb.shape == (2, env.max_agent_count, 64, 64, 4)
    # the head angle of lidar actions given as indices or values
    assert torch.equal(env.get_lidar_obs(act),
                       env.get_lidar_obs(env.action_values(act)))


def test_rollout_collects_sensors():
    """The rollout's sensor option: every sensor timed, each output reduced
    into the checksum, which equals the getters' sums on the same states."""
    env = slice_env(POOL_SCENES[:2], device="cpu", agent_bucket="auto")
    policy = slice_policy(device="cpu", seed=0)
    res = rollout(env, policy, 2, None, deterministic=True, sensors=True)
    assert set(res.sensor_ms) == {"lidar", "bev", "camera"}
    assert all(v > 0 for v in res.sensor_ms.values())
    assert torch.isfinite(res.sensor_sum) and float(res.sensor_sum) > 0
    # the same two steps again, summed by hand
    env.reset()
    acc = 0.0
    for t in range(2):
        act = env.action_values(res.actions[t])
        env.step_dynamics(act)
        rgb, depth = env.get_camera_obs()
        acc += (float(env.get_lidar_obs(act)[..., 0].sum())
                + float(env.get_bev_obs().sum()) + float(depth.sum())
                + float(rgb[..., 0].sum(dtype=torch.float32)))
        env.reset_worlds(env.world_done())
    assert abs(float(res.sensor_sum) - acc) <= 1e-4 * acc
    plain = rollout(slice_env(POOL_SCENES[:2], device="cpu",
                              agent_bucket="auto"), policy, 2, None,
                    deterministic=True)
    assert plain.sensor_ms is None and torch.equal(plain.actions, res.actions)

"""The port's typed views (gpudrive_lab_torch/datatypes) against the JAX
package's: the same input arrays through both, every field equal, after
each method (normalize, one-hot, restore_mean, restore_xy, pack)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.core import observations as jobs
from gpudrive_lab_tpu.datatypes import info as jinfo
from gpudrive_lab_tpu.datatypes import observation as jobsv
from gpudrive_lab_tpu.datatypes import roadgraph as jroad
from gpudrive_lab_tpu.datatypes import trajectory as jtraj
from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import observations as tobs
from gpudrive_lab_torch.core.bev import bev_observation
from gpudrive_lab_torch.core.lidar import lidar_observation
from gpudrive_lab_torch.datatypes import info as tinfo
from gpudrive_lab_torch.datatypes import observation as tobsv
from gpudrive_lab_torch.datatypes import roadgraph as troad
from gpudrive_lab_torch.datatypes import trajectory as ttraj
from gpudrive_lab_torch.rollout import slice_env
from torch_parity import POOL_SCENES, scene_to_jax, state_to_jax


@pytest.fixture(scope="module")
def world():
    """Three pool worlds after four random steps: the port's (scene,
    state, params) and the JAX package's (scene, state)."""
    env = slice_env(POOL_SCENES[200:203], device="cpu", agent_bucket="auto")
    gen = torch.Generator().manual_seed(1)
    for _ in range(4):
        env.step_dynamics(torch.randint(
            0, env.action_space_n, (env.num_worlds, env.max_agent_count),
            generator=gen))
    return (env.scene, env.state, env.params, scene_to_jax(env.scene),
            state_to_jax(env.state))


def assert_views_equal(tview, jview):
    assert type(tview).__name__ == type(jview).__name__
    for f in dataclasses.fields(jview):
        t, j = getattr(tview, f.name), np.asarray(getattr(jview, f.name))
        assert isinstance(t, torch.Tensor), f.name
        assert t.numpy().dtype == j.dtype, (f.name, t.dtype, j.dtype)
        np.testing.assert_array_equal(t.numpy(), j, err_msg=f.name)


def _both(x: np.ndarray):
    return torch.from_numpy(x.copy()), jnp.asarray(x)


@pytest.mark.parametrize("method", [None, "normalize"])
def test_local_ego_state(world, method):
    scene, state, *_ = world
    t, j = _both(tobs.self_observation(scene, state).numpy())
    mask_t, mask_j = _both(scene.agents.valid.numpy())
    views = (tobsv.LocalEgoState.from_array(t, mask_t),
             jobsv.LocalEgoState.from_array(j, mask_j))
    if method:
        views = tuple(getattr(v, method)() for v in views)
    assert_views_equal(*views)
    assert views[0].shape == views[1].shape


def test_global_ego_state(world):
    scene, state, _, js, jst = world
    t, j = _both(tobs.absolute_self_observation(scene, state).numpy())
    means = scene.means.numpy()
    tv = tobsv.GlobalEgoState.from_array(t)
    jv = jobsv.GlobalEgoState.from_array(j)
    assert_views_equal(tv, jv)
    # the quaternion's cos/sin may differ in the last bit between libraries
    np.testing.assert_allclose(
        t.numpy(), np.asarray(jobs.absolute_self_observation(js, jst)),
        rtol=0, atol=1e-6)
    assert_views_equal(
        tv.restore_mean(torch.from_numpy(means[:, 0]),
                        torch.from_numpy(means[:, 1])),
        jv.restore_mean(jnp.asarray(means[:, 0]), jnp.asarray(means[:, 1])))
    assert tv.shape == jv.shape


@pytest.mark.parametrize("method", [None, "normalize",
                                    "one_hot_encode_agent_types"])
def test_partner_obs(world, method):
    scene, state, params, *_ = world
    t, j = _both(tobs.partner_observations(scene, state, params).numpy())
    views = (tobsv.PartnerObs.from_array(t), jobsv.PartnerObs.from_array(j))
    if method:
        views = tuple(getattr(v, method)() for v in views)
    assert_views_equal(*views)


def test_lidar_obs(world):
    scene, state, params, *_ = world
    acts = torch.zeros(state.pos.shape[:2] + (C.ACTION_DIM,))
    t, j = _both(lidar_observation(scene, state, params, acts).numpy())
    assert_views_equal(tobsv.LidarObs.from_array(t),
                       jobsv.LidarObs.from_array(j))


@pytest.mark.parametrize("method", [None, "one_hot_encode_bev_map"])
def test_bev_obs(world, method):
    scene, state, params, *_ = world
    grid = bev_observation(scene, state, params).numpy()[0:1, :3]
    t, j = _both(grid)
    views = (tobsv.BevObs.from_array(t), jobsv.BevObs.from_array(j))
    if method:
        views = tuple(getattr(v, method)() for v in views)
        assert views[0].bev_segmentation_map.shape == (
            1, 3, 200, 200, C.NUM_ENTITY_TYPES)
    assert_views_equal(*views)


@pytest.mark.parametrize("method", [None, "normalize",
                                    "one_hot_encode_road_point_types"])
def test_local_road_graph_points(world, method):
    scene, state, params, *_ = world
    t, j = _both(tobs.agent_map_observations(scene, state, params).numpy())
    views = (troad.LocalRoadGraphPoints.from_array(t),
             jroad.LocalRoadGraphPoints.from_array(j))
    if method:
        views = tuple(getattr(v, method)() for v in views)
    assert_views_equal(*views)
    assert views[0].shape == views[1].shape


@pytest.mark.parametrize("method", [None, "restore_mean", "restore_xy"])
def test_global_road_graph_points(world, method):
    scene, _, _, js, _ = world
    t, j = _both(tobs.map_observation(scene).numpy())
    np.testing.assert_array_equal(t.numpy(),
                                  np.asarray(jobs.map_observation(js)))
    tv = troad.GlobalRoadGraphPoints.from_array(t)
    jv = jroad.GlobalRoadGraphPoints.from_array(j)
    if method == "restore_mean":
        m = scene.means.numpy()
        tv.restore_mean(torch.from_numpy(m[:, 0]), torch.from_numpy(m[:, 1]))
        jv.restore_mean(jnp.asarray(m[:, 0]), jnp.asarray(m[:, 1]))
    elif method == "restore_xy":
        tv.restore_xy()
        jv.restore_xy()
        # cos/sin of the two libraries may differ in the last bit
        for f in ("x", "y"):
            np.testing.assert_allclose(getattr(tv, f).numpy(),
                                       np.asarray(getattr(jv, f)),
                                       rtol=1e-6, atol=1e-5)
            setattr(tv, f, torch.from_numpy(np.array(getattr(jv, f))))
    assert_views_equal(tv, jv)


def test_map_element_ids():
    assert [(m.name, int(m)) for m in troad.MapElementIds] == [
        (m.name, int(m)) for m in jroad.MapElementIds]


def test_info_views(world):
    scene, state, _, js, jst = world
    assert_views_equal(tinfo.Info.from_state(scene, state),
                       jinfo.Info.from_state(js, jst))
    packed = np.random.default_rng(2).integers(
        0, 3, size=(3, scene.max_agents, 5)).astype(np.float32)
    assert_views_equal(tinfo.Info.from_array(torch.from_numpy(packed)),
                       jinfo.Info.from_array(jnp.asarray(packed)))
    assert_views_equal(tinfo.Metadata.from_scene(scene),
                       jinfo.Metadata.from_scene(js))
    assert_views_equal(tinfo.ResponseType.from_scene(scene),
                       jinfo.ResponseType.from_scene(js))


def test_log_trajectory(world):
    scene, _, _, js, _ = world
    W, A = scene.num_worlds, scene.max_agents
    tv = ttraj.LogTrajectory.from_scene(scene)
    jv = jtraj.LogTrajectory.from_scene(js)
    assert_views_equal(tv, jv)
    blob = tv.pack()
    assert blob.shape == (W, A, C.TRAJECTORY_EXPORT_SIZE)
    np.testing.assert_array_equal(blob.numpy(), np.asarray(jv.pack()))
    assert_views_equal(ttraj.LogTrajectory.from_blob(blob, W, A),
                       jtraj.LogTrajectory.from_blob(
                           jnp.asarray(blob.numpy()), W, A))
    assert_views_equal(ttraj.LogTrajectory.from_blob(blob, W, A), jv)


def test_views_take_no_jax():
    """The port's views import nothing of JAX (the package-wide check is
    test_torch_isolation.py); one_hot gives float32 as jax.nn.one_hot."""
    t = torch.tensor([0, 3, 10])
    np.testing.assert_array_equal(
        tobsv.one_hot(t, 11).numpy(),
        np.asarray(jax.nn.one_hot(jnp.asarray([0, 3, 10]), 11)))

"""Kernels K1 and K2 (agent-road narrow phase): the port's plain versions
against the JAX package's Pallas kernels, run in interpret mode on the CPU
as the JAX package's own tests run them.  Hits must be exactly equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpudrive_lab_tpu.core.pallas_kernels import (
    agent_road_hits_pallas,
    agent_road_hits_tiled as jax_tiled,
)
from gpudrive_lab_torch.core import kernels
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.core.collision import (
    agent_features,
    agent_half_extents,
    road_features_t,
    tile_mask_and_order,
    _skip_mask,
)
from gpudrive_lab_torch.core.types import CollisionBehaviour, Params
from gpudrive_lab_torch.scene.compiler import build_scene
from torch_parity import POOL_SCENES


def _random_features(rng, W, A, R):
    """The random construction of tests/test_pallas_kernels.py."""
    a_pos = rng.uniform(-100, 100, (W, A, 2)).astype(np.float32)
    a_yaw = rng.uniform(-3, 3, (W, A)).astype(np.float32)
    a_half = rng.uniform(0.5, 3, (W, A, 2)).astype(np.float32)
    active = rng.random((W, A)) < 0.8
    is_veh = rng.random((W, A)) < 0.7
    r_pos = rng.uniform(-100, 100, (W, R, 2)).astype(np.float32)
    r_yaw = rng.uniform(-3, 3, (W, R)).astype(np.float32)
    r_half = np.stack(
        [rng.uniform(1, 30, (W, R)), np.full((W, R), 0.1)], -1
    ).astype(np.float32)
    allow_veh = rng.random((W, R)) < 0.5
    allow_other = rng.random((W, R)) < 0.2
    agents = np.concatenate(
        [a_pos, np.cos(a_yaw)[..., None], np.sin(a_yaw)[..., None], a_half,
         active[..., None].astype(np.float32),
         is_veh[..., None].astype(np.float32)], -1,
    )
    roads = np.concatenate(
        [r_pos, np.cos(r_yaw)[..., None], np.sin(r_yaw)[..., None], r_half,
         allow_veh[..., None].astype(np.float32),
         allow_other[..., None].astype(np.float32)], -1,
    )
    return agents, np.swapaxes(roads, 1, 2).copy()


@pytest.mark.parametrize("W,A,R", [(2, 128, 512), (3, 32, 384)])
def test_dense_plain_matches_pallas(W, A, R):
    agents, roads_t = _random_features(np.random.default_rng(R), W, A, R)
    want = np.asarray(
        agent_road_hits_pallas(jnp.asarray(agents), jnp.asarray(roads_t))
    )
    before = kernels.agent_road_hits_dense.launches
    got = kernels.agent_road_hits_dense(
        torch.from_numpy(agents), torch.from_numpy(roads_t)
    )
    assert kernels.agent_road_hits_dense.launches == before  # CPU: plain
    assert got.dtype == torch.float32 and got.shape == (W, A)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("W,A,T", [(2, 128, 2), (1, 64, 3)])
def test_tiled_plain_matches_pallas(W, A, T):
    rng = np.random.default_rng(T)
    RT = 256
    agents, roads_t = _random_features(rng, W, A, T * RT)
    tiles = roads_t.reshape(W, 8, T, RT).transpose(0, 2, 1, 3).copy()
    mask = (rng.random((W, A // 16, T)) < 0.6).astype(np.int32)
    want = np.asarray(jax_tiled(
        jnp.asarray(agents), jnp.asarray(tiles), jnp.asarray(mask)
    ))
    got = kernels.agent_road_hits_tiled(
        torch.from_numpy(agents), torch.from_numpy(tiles),
        torch.from_numpy(mask),
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0
    # with every tile live, K1 equals K2 over the same roads
    full = kernels.agent_road_hits_tiled(
        torch.from_numpy(agents), torch.from_numpy(tiles),
        torch.ones((W, A // 16, T), dtype=torch.int32),
    )
    dense = kernels.agent_road_hits_dense(
        torch.from_numpy(agents), torch.from_numpy(roads_t)
    )
    np.testing.assert_array_equal(full.numpy(), dense.numpy())


def test_tile_path_matches_dense_on_scenes():
    """The whole tiled branch (Morton sort, reach mask, K1) gives exactly
    the dense branch's hits (K2) on jittered states of real scenes, at the
    padded 2048-road bucket."""
    params = Params(collision_behaviour=CollisionBehaviour.IGNORE,
                    polyline_reduction_threshold=0.1,
                    use_tile_collision=True)
    scene = build_scene(POOL_SCENES[:4], params, max_roads=2048,
                        device="cpu")
    rng = np.random.default_rng(0)
    state = stepmod.init_state(scene)
    W, A = state.pos.shape[:2]
    state = state.replace(
        pos=state.pos + torch.from_numpy(
            rng.normal(0, 8.0, (W, A, 2)).astype(np.float32)),
        yaw=state.yaw + torch.from_numpy(
            rng.uniform(-1, 1, (W, A)).astype(np.float32)),
        steps_remaining=state.steps_remaining - 1,
    )
    cur = stepmod.current_step_index(state)
    active = ~_skip_mask(scene, state, cur)
    feat = agent_features(scene, state, active, agent_half_extents(scene))
    dense = kernels.agent_road_hits_dense(feat, road_features_t(scene))
    feat_s, mask, inv_perm = tile_mask_and_order(scene, state, feat)
    assert mask.dtype == torch.int32 and 0 < mask.sum() < mask.numel()
    tiled = torch.gather(
        kernels.agent_road_hits_tiled(feat_s, scene.rtiles.feat, mask),
        1, inv_perm,
    )
    np.testing.assert_array_equal(tiled.numpy(), dense.numpy())
    assert dense.sum() > 0

    dense_params = dataclasses.replace(params, use_tile_collision=False)
    act = torch.zeros((W, A, 10))
    s_t = stepmod.step(scene, state, act, params)
    s_d = stepmod.step(scene, state, act, dense_params)
    for f in ("collided", "collided_road", "collided_vehicle",
              "collided_non_vehicle"):
        assert torch.equal(getattr(s_t, f), getattr(s_d, f)), f


def test_wrappers_reject_bad_inputs():
    a = torch.zeros((2, 32, 8))
    r = torch.zeros((2, 8, 64))
    with pytest.raises(TypeError):
        kernels.agent_road_hits_dense(a.double(), r)
    with pytest.raises(ValueError):
        kernels.agent_road_hits_dense(a[:, :, :7].contiguous(), r)
    with pytest.raises(ValueError):
        kernels.agent_road_hits_dense(a, r.transpose(1, 2))
    tiles = torch.zeros((2, 1, 8, 64))
    with pytest.raises(ValueError):  # A not a multiple of 16
        kernels.agent_road_hits_tiled(
            a[:, :24].contiguous(), tiles,
            torch.ones((2, 1, 1), dtype=torch.int32),
        )
    with pytest.raises(TypeError):
        kernels.agent_road_hits_tiled(
            a, tiles, torch.ones((2, 2, 1), dtype=torch.int64)
        )

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


def _odd_features(rng, W, A, R):
    """Random rows whose active and allow values are not 0/1 (negative,
    0.3, 2.0), with world 0 holding no active agent and world 1 no
    collidable road."""
    agents, roads_t = _random_features(rng, W, A, R)
    vals = np.array([-1.0, 0.0, 0.3, 1.0, 2.0], np.float32)
    agents[..., 6] = rng.choice(vals, (W, A))
    roads_t[:, 6] = rng.choice(vals, (W, R))
    roads_t[:, 7] = rng.choice(vals, (W, R))
    agents[0, :, 6] = 0.0
    roads_t[1, 6:8] = 0.0
    return agents, roads_t


def _skip_rule_plain(agents: torch.Tensor, roads_t: torch.Tensor):
    """The redesigned kernels' rule, plainly: per world, the SAT only over
    the agents with active != 0 and the roads with a nonzero allow value,
    each agent's max taken from +0.0; every other row is +0.0."""
    out = torch.zeros(agents.shape[:2])
    for w in range(agents.shape[0]):
        ai = torch.nonzero(agents[w, :, 6] != 0)[:, 0]
        rj = torch.nonzero((roads_t[w, 6] != 0) | (roads_t[w, 7] != 0))[:, 0]
        if len(ai) and len(rj):
            hit = kernels._sat_hits(agents[w, ai], roads_t[w][:, rj])
            out[w, ai] = torch.maximum(hit.amax(dim=-1), torch.tensor(0.0))
    return out


@pytest.mark.parametrize("W,A,R", [(3, 128, 45), (4, 37, 300), (3, 16, 1024)])
def test_skip_rule_matches_dense_plain_and_pallas(W, A, R):
    """Testing only the pairs that can hit (the redesigned K1/K2) gives the
    dense plain version's and the Pallas kernel's bits, R ragged against
    the 32-lane warp, with active/allow values other than 0/1, a world with
    no active agent and one with no collidable road."""
    agents, roads_t = _odd_features(np.random.default_rng(A + R), W, A, R)
    want = kernels.agent_road_hits_dense_plain(
        torch.from_numpy(agents), torch.from_numpy(roads_t))
    # the premise of the +0.0 start: some pair of every row is separated
    assert bool((want >= 0).all())
    got = _skip_rule_plain(torch.from_numpy(agents), torch.from_numpy(roads_t))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    pallas = np.asarray(
        agent_road_hits_pallas(jnp.asarray(agents), jnp.asarray(roads_t)))
    np.testing.assert_array_equal(got.numpy(), pallas)
    assert float(got[2:].max()) > 0 and not bool(got[:2].any())
    assert sorted(set(got.flatten().tolist())) != [0.0, 1.0]  # 0.3, 2, ...


def _numpy_live(agents, roads_t, mask=None):
    """[W, A, R] bool: the pairs whose hit can exceed +0.0, in numpy."""
    W, A, _ = agents.shape
    R = roads_t.shape[2]
    allowed = np.where(agents[:, :, None, 7] > 0.5, roads_t[:, None, 6],
                       roads_t[:, None, 7])  # [W, A, R]
    act = agents[:, :, None, 6]
    live = ((allowed > 0) & (act > 0)) | ((allowed < 0) & (act < 0))
    if mask is not None:  # roads in tiles of R / T, mask per 16 agents
        T = mask.shape[2]
        m = np.repeat(np.repeat(mask > 0, 16, axis=1), R // T, axis=2)
        live &= m
    return live


def _numpy_live_pairs(agents, roads_t, mask=None):
    """Pairs whose hit can exceed +0.0, counted pair by pair in numpy."""
    return int(_numpy_live(agents, roads_t, mask).sum())


def _numpy_live_pair_ops(agents, roads_t, mask=None):
    """The live pairs' SAT operations, pair by pair in numpy: 25 where the
    first two axis tests separate the boxes, 43 where all four run."""
    a = agents[:, :, None, :]  # [W, A, 1, 8]
    r = np.swapaxes(roads_t, 1, 2)[:, None]  # [W, 1, R, 8]
    dx, dy = r[..., 0] - a[..., 0], r[..., 1] - a[..., 1]
    ca, sa, cb, sb = a[..., 2], a[..., 3], r[..., 2], r[..., 3]
    ac = np.abs(cb * ca + sb * sa)
    asn = np.abs(sb * ca - cb * sa)
    early = ((np.abs(ca * dx + sa * dy) > a[..., 4] + r[..., 4] * ac
              + r[..., 5] * asn)
             | (np.abs(-sa * dx + ca * dy) > a[..., 5] + r[..., 4] * asn
                + r[..., 5] * ac))
    live = _numpy_live(agents, roads_t, mask)
    return int(25 * (live & early).sum() + 43 * (live & ~early).sum())


@pytest.mark.parametrize("odd", [False, True])
def test_live_pairs_match_numpy(odd):
    rng = np.random.default_rng(7)
    W, A, T, RT = 3, 32, 4, 64
    make = _odd_features if odd else _random_features
    agents, roads_t = make(rng, W, A, T * RT)
    n = kernels.live_pairs(torch.from_numpy(agents), torch.from_numpy(roads_t))
    assert n == _numpy_live_pairs(agents, roads_t) > 0
    tiles = roads_t.reshape(W, 8, T, RT).transpose(0, 2, 1, 3).copy()
    mask = (rng.random((W, A // 16, T)) < 0.5).astype(np.int32)
    nt = kernels.live_pairs_tiled(torch.from_numpy(agents),
                                  torch.from_numpy(tiles),
                                  torch.from_numpy(mask))
    assert nt == _numpy_live_pairs(agents, roads_t, mask) > 0
    assert nt < n


@pytest.mark.parametrize("odd", [False, True])
def test_live_pair_ops_match_numpy(odd):
    """The operation counts of K2's and K1's bounds against a numpy count
    pair by pair, with worlds taken a few at a time: the early stop makes
    most of them cheaper than the full SAT."""
    rng = np.random.default_rng(8)
    W, A, T, RT = 5, 32, 4, 64
    make = _odd_features if odd else _random_features
    agents, roads_t = make(rng, W, A, T * RT)
    tiles = roads_t.reshape(W, 8, T, RT).transpose(0, 2, 1, 3).copy()
    mask = (rng.random((W, A // 16, T)) < 0.5).astype(np.int32)
    ta, tr = torch.from_numpy(agents), torch.from_numpy(roads_t)
    tt, tm = torch.from_numpy(tiles), torch.from_numpy(mask)
    ops = kernels.live_pair_ops(ta, tr, worlds=2)
    pairs = kernels.live_pairs(ta, tr)
    assert ops == _numpy_live_pair_ops(agents, roads_t)
    assert kernels.SAT_EARLY_FLOPS * pairs < ops < kernels.SAT_FLOPS * pairs
    assert ops == kernels.live_pair_ops(ta, tr)  # chunking changes nothing
    assert (kernels.live_pair_ops_tiled(ta, tt, tm, worlds=2)
            == _numpy_live_pair_ops(agents, roads_t, mask) > 0)


def test_large_map_defaults_to_cuda():
    """Like the port's other builders, large_map runs on CUDA unless the
    caller names another device, and raises where there is none."""
    from gpudrive_lab_torch.scene.large_map import large_map

    kw = dict(W=1, A=16, R=256, n_active=2, side=200.0)
    if torch.cuda.is_available():
        assert large_map(**kw).agents.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            large_map(**kw)
    assert large_map(**kw, device="cpu").agents.device.type == "cpu"


def test_large_map_tiled_matches_dense():
    """The synthetic large map (tiles of 256 over 2,048 roads, the step's
    own Morton order and mask): K1's plain version after inv_perm equals
    K2's, the mask skips tiles, and some agent hits a road edge."""
    from gpudrive_lab_torch.scene.large_map import large_map

    m = large_map(W=4, A=32, R=2048, n_active=12, side=200.0, seed=3,
                  device="cpu")
    assert m.rtiles.feat.shape == (4, 8, 8, 256)
    assert 0 < int(m.mask.sum()) < m.mask.numel()
    dense = kernels.agent_road_hits_dense(m.agents, m.roads_t)
    tiled = kernels.agent_road_hits_tiled(m.agents_s, m.rtiles.feat, m.mask)
    np.testing.assert_array_equal(
        torch.gather(tiled, 1, m.inv_perm).numpy(), dense.numpy())
    assert 0 < int(dense.sum()) <= 4 * 12 and not bool(dense[:, 12:].any())
    assert (kernels.live_pairs_tiled(m.agents_s, m.rtiles.feat, m.mask)
            < kernels.live_pairs(m.agents, m.roads_t))

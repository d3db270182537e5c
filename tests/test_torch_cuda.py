"""The port's CUDA kernels against their plain versions on the card.

These need an NVIDIA GPU with nvcc (marker ``cuda``) and skip without one.
Run them on the card with (``--noconftest`` where jax is not installed,
since tests/conftest.py imports it):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

chip_smoke.py holds the same kernels at the full shapes of the main path.
"""

import os

import numpy as np
import pytest
import torch

from gpudrive_lab_torch.core import kernels
from gpudrive_lab_torch.networks import fused_embed as fe

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _features(rng, W, A, R):
    def col(*s, lo=-1.0, hi=1.0):
        return rng.uniform(lo, hi, s).astype(np.float32)

    yaw_a, yaw_r = col(W, A, lo=-3, hi=3), col(W, R, lo=-3, hi=3)
    agents = np.stack(
        [col(W, A, lo=-60, hi=60), col(W, A, lo=-60, hi=60),
         np.cos(yaw_a), np.sin(yaw_a), col(W, A, lo=0.5, hi=3),
         col(W, A, lo=0.5, hi=2), (rng.random((W, A)) < 0.8),
         (rng.random((W, A)) < 0.7)], -1).astype(np.float32)
    roads = np.stack(
        [col(W, R, lo=-60, hi=60), col(W, R, lo=-60, hi=60),
         np.cos(yaw_r), np.sin(yaw_r), col(W, R, lo=1, hi=20),
         np.full((W, R), 0.1, np.float32), (rng.random((W, R)) < 0.5),
         (rng.random((W, R)) < 0.2)], 1).astype(np.float32)
    return torch.from_numpy(agents), torch.from_numpy(roads)


@pytest.mark.parametrize("W,A,R", [(3, 128, 256), (2, 40, 700)])
def test_dense_kernel_matches_plain(dev, W, A, R):
    agents, roads = _features(np.random.default_rng(R), W, A, R)
    before = kernels.agent_road_hits_dense.launches
    got = kernels.agent_road_hits_dense(agents.to(dev), roads.to(dev))
    assert kernels.agent_road_hits_dense.launches == before + 1
    want = kernels.agent_road_hits_dense_plain(agents, roads)
    assert torch.equal(got.cpu(), want) and want.sum() > 0


def test_tiled_kernel_matches_plain(dev):
    W, A, T, RT = 2, 64, 3, 256
    rng = np.random.default_rng(1)
    agents, roads = _features(rng, W, A, T * RT)
    tiles = roads.reshape(W, 8, T, RT).transpose(1, 2).contiguous()
    mask = torch.from_numpy(
        (rng.random((W, A // 16, T)) < 0.6).astype(np.int32))
    got = kernels.agent_road_hits_tiled(agents.to(dev), tiles.to(dev),
                                        mask.to(dev))
    want = kernels.agent_road_hits_tiled_plain(agents, tiles, mask)
    assert torch.equal(got.cpu(), want) and want.sum() > 0


@pytest.mark.parametrize("B,E,F", [(37, 127, 6), (64, 200, 13), (5, 3, 1)])
@pytest.mark.parametrize("act", ["tanh", "gelu"])
def test_fused_embed_kernel_matches_plain(dev, B, E, F, act):
    g = torch.Generator().manual_seed(B + E)
    x = torch.randn(B, E, F, generator=g)
    w = [torch.randn(F, 64, generator=g) * 0.3,
         torch.randn(64, generator=g) * 0.1,
         1 + 0.1 * torch.randn(64, generator=g),
         torch.randn(64, generator=g) * 0.1,
         torch.randn(64, 64, generator=g) * 0.2,
         torch.randn(64, generator=g) * 0.1]
    pooled, arg = fe.fused_embed_pool_fwd(x.to(dev), *[t.to(dev) for t in w],
                                          act)
    want, _ = fe.reference_embed_pool_argmax(x, *w, act)
    assert (pooled.cpu() - want).abs().max() <= 1e-4
    y = fe._embed(x, *w, act)
    top2 = y.topk(2, dim=1)
    clear = (top2.values[:, 0] - top2.values[:, 1]) > 1e-5
    assert torch.equal(arg.cpu().long()[clear], top2.indices[:, 0][clear])


@pytest.mark.parametrize("B,E,F", [(37, 127, 6), (64, 200, 13), (1000, 23, 13),
                                   (5, 3, 1)])
@pytest.mark.parametrize("act", ["tanh", "gelu"])
def test_fused_embed_bwd_kernel_matches_plain(dev, B, E, F, act):
    """K4 against its plain version with the argmax K3 gave, each gradient
    to 1e-4 of its largest magnitude; the last rows carry winner -1 (no
    gradient), and two launches give the same bits."""
    g = torch.Generator().manual_seed(B * E + F)
    x = torch.randn(B, E, F, generator=g)
    w = [torch.randn(F, 64, generator=g) * 0.3,
         torch.randn(64, generator=g) * 0.1,
         1 + 0.1 * torch.randn(64, generator=g),
         torch.randn(64, generator=g) * 0.1,
         torch.randn(64, 64, generator=g) * 0.2,
         torch.randn(64, generator=g) * 0.1]
    dpool = torch.randn(B, 64, generator=g)
    wd = [t.to(dev) for t in w]
    _, arg = fe.fused_embed_pool_fwd(x.to(dev), *wd, act)
    arg[-2:] = -1
    before = fe.fused_embed_pool_bwd.launches
    got = fe.fused_embed_pool_bwd(x.to(dev), *wd, arg, dpool.to(dev), act)
    again = fe.fused_embed_pool_bwd(x.to(dev), *wd, arg, dpool.to(dev), act)
    assert fe.fused_embed_pool_bwd.launches == before + 2
    want = fe.reference_embed_pool_bwd(x, *w, arg.cpu(), dpool, act)
    for name, a, b, c in zip(("w1", "b1", "g", "be", "w2", "b2"), got,
                             again, want):
        assert a.shape == c.shape, name
        assert torch.equal(a, b), name
        scale = float(c.abs().max())
        assert float((a.cpu() - c).abs().max()) <= 1e-4 * scale, name


def test_fused_embed_autograd_on_card(dev):
    """fused_embed_pool's backward launches K4 on CUDA tensors and gives
    the plain version's gradients; x gets no gradient."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(50, 31, 13, generator=g)
    w = [torch.randn(13, 64, generator=g) * 0.3, torch.zeros(64),
         torch.ones(64), torch.zeros(64),
         torch.randn(64, 64, generator=g) * 0.2, torch.zeros(64)]
    co = torch.randn(50, 64, generator=g)
    grads = []
    for d in (dev, torch.device("cpu")):
        ps = [t.to(d).requires_grad_() for t in w]
        xd = x.to(d).requires_grad_()
        before = fe.fused_embed_pool_bwd.launches
        (fe.fused_embed_pool(xd, *ps, "tanh") * co.to(d)).sum().backward()
        assert fe.fused_embed_pool_bwd.launches == before + (d == dev)
        assert xd.grad is None
        grads.append([p.grad.cpu() for p in ps])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_train_iteration_on_card(dev):
    """One PPO iteration through build_trainer on 4 pool worlds on the card
    (flat compaction, fused embed): K4 launches twice per minibatch, the
    losses are finite and the parameters move.  A second iteration's
    rollout, GAE and update never wait on the card (no operation in them
    synchronizes with the host)."""
    from gpudrive_lab_torch.ppo.ppo import PPOConfig
    from gpudrive_lab_torch.ppo.train import build_trainer
    from gpudrive_lab_torch.rollout import pool_scene_paths, slice_env

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = slice_env(pool_scene_paths(root)[:4], device=dev)
    n = int(env.scene.agents.controlled.sum())
    cfg = PPOConfig(rollout_len=8, update_epochs=2, num_minibatches=2,
                    fused_embed=True, compact=-(-n // 64) * 64,
                    compact_mode="flat")
    ppo, carry, fresh, train_fn = build_trainer(env, cfg, seed=0)
    before = [p.detach().clone() for p in ppo.policy.parameters()]
    n4 = fe.fused_embed_pool_bwd.launches
    carry, m = train_fn(env.scene, carry, fresh, env.reward_weights)
    torch.cuda.synchronize()
    assert fe.fused_embed_pool_bwd.launches - n4 == 2 * 2 * 2
    assert all(bool(torch.isfinite(v).all()) for v in m.values())
    assert float(m["samples"]) > 0
    assert any(not torch.equal(a, b)
               for a, b in zip(ppo.policy.parameters(), before))
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, traj = ppo.rollout(env.scene, carry, fresh, env.reward_weights)
        batch = ppo.prepare(env.scene, carry, traj, env.reward_weights)
        ppo.learn(env.scene, batch, traj, env.reward_weights)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_wrapper_refuses_mixed_devices(dev):
    agents, roads = _features(np.random.default_rng(0), 1, 16, 8)
    with pytest.raises(ValueError):
        kernels.agent_road_hits_dense(agents.to(dev), roads)

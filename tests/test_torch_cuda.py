"""The port's CUDA kernels against their plain versions on the card.

These need an NVIDIA GPU with nvcc (marker ``cuda``) and skip without one.
Run them on the card with (``--noconftest`` where jax is not installed,
since tests/conftest.py imports it):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

chip_smoke.py holds the same kernels at the full shapes of the main path.
"""

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


def test_wrapper_refuses_mixed_devices(dev):
    agents, roads = _features(np.random.default_rng(0), 1, 16, 8)
    with pytest.raises(ValueError):
        kernels.agent_road_hits_dense(agents.to(dev), roads)

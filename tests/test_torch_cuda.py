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


def _dense_on_card(dev, agents, roads):
    """K2 on the card, launched twice: the launch count, the two launches'
    bits, and the result on the CPU."""
    before = kernels.agent_road_hits_dense.launches
    a, r = agents.to(dev), roads.to(dev)
    got = kernels.agent_road_hits_dense(a, r)
    again = kernels.agent_road_hits_dense(a, r)
    assert kernels.agent_road_hits_dense.launches == before + 2
    assert torch.equal(got, again)
    return got.cpu()


def _tiled_on_card(dev, agents, tiles, mask):
    before = kernels.agent_road_hits_tiled.launches
    a, t, m = agents.to(dev), tiles.to(dev), mask.to(dev)
    got = kernels.agent_road_hits_tiled(a, t, m)
    again = kernels.agent_road_hits_tiled(a, t, m)
    assert kernels.agent_road_hits_tiled.launches == before + 2
    assert torch.equal(got, again)
    return got.cpu()


@pytest.mark.parametrize("W,A,R", [(3, 128, 256), (2, 40, 700),
                                   (2, 300, 333)])
def test_dense_kernel_matches_plain(dev, W, A, R):
    agents, roads = _features(np.random.default_rng(R), W, A, R)
    got = _dense_on_card(dev, agents, roads)
    want = kernels.agent_road_hits_dense_plain(agents, roads)
    assert torch.equal(got, want) and want.sum() > 0


@pytest.mark.parametrize("R", [1, 33, 257, 2048, 10240])
@pytest.mark.parametrize("A", [1, 37, 128])
def test_dense_kernel_shapes(dev, A, R):
    """K2 at ragged A and R (one road; one warp and one more; more roads
    than a chunk; the tiled buckets' 2,048 and 10,240)."""
    agents, roads = _features(np.random.default_rng(A * R), 2, A, R)
    got = _dense_on_card(dev, agents, roads)
    assert torch.equal(got, kernels.agent_road_hits_dense_plain(agents, roads))


def test_dense_kernel_nothing_to_test(dev):
    """No active agent, or no collidable road: every row +0.0."""
    agents, roads = _features(np.random.default_rng(3), 2, 64, 300)
    idle = agents.clone()
    idle[..., 6] = 0.0
    blind = roads.clone()
    blind[:, 6:8] = 0.0
    for a, r in ((idle, roads), (agents, blind)):
        got = _dense_on_card(dev, a, r)
        assert torch.equal(got, torch.zeros_like(got))
        assert torch.equal(got, kernels.agent_road_hits_dense_plain(a, r))


def test_dense_kernel_touching_pairs(dev):
    """Boxes on a quarter-metre grid, axis-aligned or turned by a right
    angle (cos and sin exactly 0 or +-1): many pairs touch exactly, where
    the SAT's <= decides.  Bitwise equal to the plain version."""
    rng = np.random.default_rng(5)
    W, A, R = 4, 128, 512
    quarter = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], np.float32)

    def rows(n, lead):
        cs = quarter[rng.integers(0, 4, (W, n))]
        return np.concatenate([
            rng.integers(-24, 24, (W, n, 2)).astype(np.float32) / 4, cs,
            rng.integers(1, 9, (W, n, 2)).astype(np.float32) / 4, lead], -1)

    agents = rows(A, np.stack([rng.random((W, A)) < 0.8,
                               rng.random((W, A)) < 0.7], -1))
    roads = rows(R, np.stack([rng.random((W, R)) < 0.5,
                              rng.random((W, R)) < 0.2], -1))
    agents = torch.from_numpy(agents.astype(np.float32))
    roads = torch.from_numpy(roads.astype(np.float32).transpose(0, 2, 1)
                             .copy())
    # exact contact: some |offset| equals its bound
    hit = kernels._sat_hits(agents, roads)
    assert hit.sum() > 0
    got = _dense_on_card(dev, agents, roads)
    assert torch.equal(got, kernels.agent_road_hits_dense_plain(agents, roads))


def test_dense_kernel_nonfinite_inputs(dev):
    """NaN and inf in positions, extents and allow/active values: fmaxf
    drops a NaN pair where torch.amax keeps it, so the kernel is compared,
    after > 0.5 (all collision_system reads), with the plain pair hits'
    max over the pairs that are not NaN."""
    rng = np.random.default_rng(9)
    agents, roads = _features(rng, 3, 64, 300)
    for t, shape in ((agents, (3, 64)), (roads, (3, 300))):
        for v in (float("nan"), float("inf"), -float("inf")):
            idx = tuple(torch.from_numpy(rng.integers(0, n, 12))
                        for n in shape)
            f = torch.from_numpy(rng.integers(0, 8, 12))
            if t is agents:
                t[idx[0], idx[1], f] = v
            else:
                t[idx[0], f, idx[1]] = v
    hit = kernels._sat_hits(agents, roads)
    want = torch.where(hit.isnan(), 0.0, hit).amax(dim=-1)
    got = _dense_on_card(dev, agents, roads)
    assert torch.equal(got > 0.5, want > 0.5) and bool((want > 0.5).any())


def _tiles(rng, W, A, T, RT=256):
    agents, roads = _features(rng, W, A, T * RT)
    return agents, roads.reshape(W, 8, T, RT).transpose(1, 2).contiguous()


@pytest.mark.parametrize("masks", ["random", "all", "none"])
@pytest.mark.parametrize("W,A,T", [(2, 64, 3), (2, 128, 40), (2, 256, 17)])
def test_tiled_kernel_matches_plain(dev, W, A, T, masks):
    """K1 with random, all-live and all-dead masks, at the large maps' 40
    tiles, and with more agents than threads; every row is written (the
    output is not pre-zeroed)."""
    rng = np.random.default_rng(T)
    agents, tiles = _tiles(rng, W, A, T)
    p = {"random": 0.6, "all": 1.0, "none": 0.0}[masks]
    mask = torch.from_numpy((rng.random((W, A // 16, T)) < p)
                            .astype(np.int32))
    # leave a NaN-filled block in the allocator's cache for K1's output
    torch.full((W, A), float("nan"), device=dev)
    got = _tiled_on_card(dev, agents, tiles, mask)
    want = kernels.agent_road_hits_tiled_plain(agents, tiles, mask)
    assert torch.equal(got, want)
    assert (want.sum() > 0) == (masks != "none")
    if masks == "all":  # every tile live: K1 equals K2 over the same roads
        roads = tiles.transpose(1, 2).reshape(W, 8, -1).contiguous()
        assert torch.equal(got, _dense_on_card(dev, agents, roads))


def test_tiled_kernel_unaligned_tiles(dev):
    """Tiles that start 4 bytes past a 16-byte boundary are staged with
    4-byte copies and give the same bits."""
    rng = np.random.default_rng(11)
    W, A, T = 2, 64, 5
    agents, tiles = _tiles(rng, W, A, T)
    mask = torch.from_numpy((rng.random((W, A // 16, T)) < 0.6)
                            .astype(np.int32))
    flat = torch.empty(tiles.numel() + 1, device=dev)
    shifted = flat[1:].view(tiles.shape)
    shifted.copy_(tiles.to(dev))
    assert shifted.data_ptr() % 16 == 4
    got = _tiled_on_card(dev, agents, shifted, mask)
    assert torch.equal(got, kernels.agent_road_hits_tiled_plain(
        agents, tiles, mask))
    assert got.sum() > 0


def test_tiled_kernel_on_large_map(dev):
    """The synthetic large map at 32 worlds (10,240 roads, 40 tiles): K1
    after inv_perm equals K2 over the same roads, and both their plain
    versions."""
    from gpudrive_lab_torch.scene.large_map import large_map

    m = large_map(W=32, A=128, R=10240, n_active=24, seed=1, device="cpu")
    dense = _dense_on_card(dev, m.agents, m.roads_t)
    tiled = _tiled_on_card(dev, m.agents_s, m.rtiles.feat, m.mask)
    assert torch.equal(torch.gather(tiled, 1, m.inv_perm), dense)
    assert torch.equal(dense, kernels.agent_road_hits_dense_plain(
        m.agents, m.roads_t))
    assert torch.equal(tiled, kernels.agent_road_hits_tiled_plain(
        m.agents_s, m.rtiles.feat, m.mask))
    assert dense.sum() > 0


def _embed_params(g, F):
    return [torch.randn(F, 64, generator=g) * 0.3,
            torch.randn(64, generator=g) * 0.1,
            1 + 0.1 * torch.randn(64, generator=g),
            torch.randn(64, generator=g) * 0.1,
            torch.randn(64, 64, generator=g) * 0.2,
            torch.randn(64, generator=g) * 0.1]


def _check_k3(x_dev, x, w, act):
    """K3 on the card against the float64 evaluation of its plain version:
    pooled within 1e-4, the argmax equal where the top two differ by more
    than 1e-5, and a second launch bitwise equal to the first.  The plain
    version in float32 on the host CPU is a reading, printed beside: on
    some hosts the CPU's float32 products are themselves 1.26e-4 from
    float64 (scripts/cpu_gemm_precision.py measures it), more than the
    kernel's 2.4e-6, so it is not the reference."""
    wd = [t.to(x_dev.device) for t in w]
    before = fe.fused_embed_pool_fwd.launches
    pooled, arg = fe.fused_embed_pool_fwd(x_dev, *wd, act)
    pooled2, arg2 = fe.fused_embed_pool_fwd(x_dev, *wd, act)
    assert fe.fused_embed_pool_fwd.launches == before + 2
    assert torch.equal(pooled, pooled2) and torch.equal(arg, arg2)
    y64 = fe._embed(x.double(), *[t.double() for t in w], act)
    top2 = y64.topk(min(2, y64.shape[1]), dim=1)
    want64 = top2.values[:, 0]
    plain, _ = fe.reference_embed_pool_argmax(x, *w, act)
    err = float((pooled.cpu().double() - want64).abs().max())
    plain_err = float((plain.double() - want64).abs().max())
    print(f"K3 {tuple(x.shape)} {act}: kernel {err:.3g} from float64, "
          f"plain float32 on the CPU {plain_err:.3g}")
    b, j = divmod(int((pooled.cpu().double() - want64).abs().argmax()), 64)
    assert err <= 1e-4, (
        f"pooled max abs err {err} > 1e-4 from float64 (plain float32 on "
        f"the CPU {plain_err}); worst at row {b} unit {j}: kernel "
        f"{float(pooled[b, j])} (entity {int(arg[b, j])}), float64 top "
        f"{top2.values[b, :, j].tolist()} (entities "
        f"{top2.indices[b, :, j].tolist()})")
    if y64.shape[1] < 2:
        assert torch.equal(arg.cpu(), torch.zeros_like(arg.cpu()))
        return pooled, arg
    clear = (top2.values[:, 0] - top2.values[:, 1]) > 1e-5
    assert torch.equal(arg.cpu().long()[clear], top2.indices[:, 0][clear])
    return pooled, arg


@pytest.mark.parametrize("B,E,F", [(37, 127, 6), (64, 200, 13), (5, 3, 1),
                                   (20, 1, 6), (33, 17, 13), (9, 200, 6),
                                   (4416, 200, 13)])
@pytest.mark.parametrize("act", ["tanh", "gelu"])
def test_fused_embed_kernel_matches_plain(dev, B, E, F, act):
    """K3 against its plain version, ragged E (1, 17, 200: partial and
    single m-tiles) and the PPO rollout's 4,416 rows included; two launches
    give the same bits."""
    g = torch.Generator().manual_seed(B + E)
    x = torch.randn(B, E, F, generator=g)
    _check_k3(x.to(dev), x, _embed_params(g, F), act)


def test_fused_embed_kernel_reads_partner_slice_in_place(dev):
    """The partner block read in place from [B, 3368] observation rows: it
    starts 24 bytes into each row (8-byte, not 16-byte aligned).  The
    result equals the kernel's on a contiguous copy, bit for bit, and the
    plain version's within K3's bars."""
    B = 300
    g = torch.Generator().manual_seed(11)
    obs = torch.randn(B, 3368, generator=g)
    w = _embed_params(g, 6)
    view = obs.to(dev)[:, 6:768].unflatten(-1, (127, 6))
    assert view.data_ptr() % 16 == 8 and not view.is_contiguous()
    x = obs[:, 6:768].unflatten(-1, (127, 6)).contiguous()
    pooled, arg = _check_k3(view, x, w, "tanh")
    copy = fe.fused_embed_pool_fwd(x.to(dev), *[t.to(dev) for t in w])
    assert torch.equal(pooled, copy[0]) and torch.equal(arg, copy[1])


@pytest.mark.parametrize("B,E,F", [(37, 127, 6), (64, 200, 13), (1000, 23, 13),
                                   (5, 3, 1), (20, 1, 6), (4416, 200, 13)])
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


# K3 and K4 in compute dtype bfloat16 against their plain bf16 versions.
# Both sum exact bf16 products in float32, in another order; the float32
# values then round to bf16 (the activation output t before layer 2) the
# same way except where they lie within a few ulps of a bf16 rounding
# boundary.  Bars: every pooled entry within BF16_FLIPS flips of t
# (fe.bf16_flip_bound each), at most 1% of entries beyond 1e-5 (sum order
# alone moves an entry by ~1e-6), the kernel's winner within the same bar
# of the plain maximum, and the argmax equal where the top two differ by
# more than twice the bar.
BF16_FLIPS = 4


def _check_k3_bf16(x_dev, x, w, act):
    """K3 in compute dtype bfloat16 on the card (x as stored, float32 or
    bf16) against its plain bf16 version at the bars above, two launches
    bitwise equal."""
    bf = torch.bfloat16
    wd = [t.to(x_dev.device) for t in w]
    before = fe.fused_embed_pool_fwd.launches
    pooled, arg = fe.fused_embed_pool_fwd(x_dev, *wd, act, bf)
    pooled2, arg2 = fe.fused_embed_pool_fwd(x_dev, *wd, act, bf)
    assert fe.fused_embed_pool_fwd.launches == before + 2
    assert torch.equal(pooled, pooled2) and torch.equal(arg, arg2)
    y = fe._embed(x, *w, act, bf)
    want = y.amax(dim=1)
    bar = BF16_FLIPS * fe.bf16_flip_bound(act, w[2], w[3], w[4])
    err = (pooled.cpu() - want).abs()
    assert float(err.max()) <= bar, (float(err.max()), bar)
    assert float((err > 1e-5).float().mean()) <= 0.01
    picked = torch.gather(y, 1, arg.cpu().long()[:, None]).squeeze(1)
    assert float((want - picked).abs().max()) <= bar
    if y.shape[1] > 1:
        top2 = y.topk(2, dim=1)
        clear = (top2.values[:, 0] - top2.values[:, 1]) > 2 * bar
        assert torch.equal(arg.cpu().long()[clear], top2.indices[:, 0][clear])
    return pooled, arg


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,E,F", [(37, 127, 6), (64, 200, 13), (20, 1, 6),
                                   (33, 17, 13), (4416, 200, 13), (1, 1, 6),
                                   (5, 200, 13)])
@pytest.mark.parametrize("act", ["tanh", "gelu"])
def test_fused_embed_bf16_kernel_matches_plain(dev, B, E, F, act, x_dtype):
    """K3's bf16 compute mode against its plain version, x stored in
    float32 or bf16, ragged E and the PPO rollout's 4,416 rows included.
    B = 1 and B = 5 leave warps of a block's last group of 4 rows without a
    row; E = 1 and E = 200 give a block an odd number of tiles, so its
    two-tile pipeline ends on a tile of no row."""
    g = torch.Generator().manual_seed(B + E + 1)
    x = torch.randn(B, E, F, generator=g).to(getattr(torch, x_dtype))
    _check_k3_bf16(x.to(dev), x, _embed_params(g, F), act)


def test_fused_embed_bf16_kernel_reads_bf16_rows_in_place(dev):
    """The partner and road blocks read in place from [B, 3368] bf16
    observation rows (road entities of 26 bytes, every other one at an odd
    2-byte offset), and a block starting one element off: the same bits as
    the kernel on contiguous copies."""
    B = 300
    g = torch.Generator().manual_seed(12)
    obs = torch.randn(B, 3370, generator=g).to(torch.bfloat16)
    for lo, E, F in ((6, 127, 6), (768, 200, 13), (769, 200, 13)):
        w = _embed_params(g, F)
        view = obs.to(dev)[:, lo:lo + E * F].unflatten(-1, (E, F))
        x = obs[:, lo:lo + E * F].unflatten(-1, (E, F)).contiguous()
        pooled, arg = _check_k3_bf16(view, x, w, "tanh")
        copy = fe.fused_embed_pool_fwd(x.to(dev), *[t.to(dev) for t in w],
                                       "tanh", torch.bfloat16)
        assert torch.equal(pooled, copy[0]) and torch.equal(arg, copy[1])


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,E,F", [(37, 127, 6), (64, 200, 13), (1000, 23, 13),
                                   (20, 1, 6), (4416, 200, 13), (5, 200, 13)])
@pytest.mark.parametrize("act", ["tanh", "gelu"])
def test_fused_embed_bwd_bf16_kernel_matches_plain(dev, B, E, F, act,
                                                   x_dtype):
    """K4's bf16 compute mode against its plain version with the argmax
    K3's bf16 mode gave (the last rows carry winner -1).  db1, dg, dbe and
    db2 sum unrounded float32 values: 1e-4 of each one's largest magnitude,
    K4's float32 bar.  dw1 and dw2 sum products of operands rounded to
    bf16 (dpre and t), which the two versions can round apart where a
    float32 value lies within a few ulps of a rounding boundary: their
    error as a share of the terms' root-sum-square is held at
    fused_embed.BF16_PRODUCT_BAR (2^-12, derived there).  The control:
    K4's float32 mode on the same inputs skips those roundings and must
    exceed the bar on both.  Two launches give the same bits."""
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(B * E + F + 1)
    x = torch.randn(B, E, F, generator=g).to(getattr(torch, x_dtype))
    w = _embed_params(g, F)
    dpool = torch.randn(B, 64, generator=g)
    wd = [t.to(dev) for t in w]
    _, arg = fe.fused_embed_pool_fwd(x.to(dev), *wd, act, bf)
    arg[-2:] = -1
    before = fe.fused_embed_pool_bwd.launches
    got = fe.fused_embed_pool_bwd(x.to(dev), *wd, arg, dpool.to(dev), act, bf)
    again = fe.fused_embed_pool_bwd(x.to(dev), *wd, arg, dpool.to(dev), act,
                                    bf)
    assert fe.fused_embed_pool_bwd.launches == before + 2
    control = fe.fused_embed_pool_bwd(x.float().to(dev), *wd, arg,
                                      dpool.to(dev), act)
    want = fe.reference_embed_pool_bwd(x, *w, arg.cpu(), dpool, act, bf)
    rss = fe.bwd_product_rss(x, *w, arg.cpu(), dpool, act, bf)
    for name, a, b, c, k in zip(("w1", "b1", "g", "be", "w2", "b2"), got,
                                again, want, control):
        assert a.shape == c.shape and a.dtype == torch.float32, name
        assert torch.equal(a, b), name
        if name in ("w1", "w2"):
            s = rss[name == "w2"]
            assert fe.bf16_product_error(a.cpu(), c, s) <= \
                fe.BF16_PRODUCT_BAR, name
            assert fe.bf16_product_error(k.cpu(), c, s) > \
                fe.BF16_PRODUCT_BAR, name
        else:
            assert float((a.cpu() - c).abs().max()) <= 1e-4 * float(
                c.abs().max()), name


def test_fused_embed_bwd_bf16_kernel_reads_bf16_rows_in_place(dev):
    """K4's bf16 mode on the partner and road blocks read in place from
    [B, 3368] bf16 observation rows (road entities at odd 2-byte offsets)
    and on a block starting one element off: the same bits as on
    contiguous copies, and the plain version's gradients at the bars of
    the test above."""
    bf = torch.bfloat16
    B = 300
    g = torch.Generator().manual_seed(13)
    obs = torch.randn(B, 3370, generator=g).to(bf)
    dpool = torch.randn(B, 64, generator=g)
    for lo, E, F in ((6, 127, 6), (768, 200, 13), (769, 200, 13)):
        w = _embed_params(g, F)
        wd = [t.to(dev) for t in w]
        view = obs.to(dev)[:, lo:lo + E * F].unflatten(-1, (E, F))
        x = obs[:, lo:lo + E * F].unflatten(-1, (E, F)).contiguous()
        _, arg = fe.fused_embed_pool_fwd(view, *wd, "tanh", bf)
        got = fe.fused_embed_pool_bwd(view, *wd, arg, dpool.to(dev), "tanh",
                                      bf)
        copy = fe.fused_embed_pool_bwd(x.to(dev), *wd, arg, dpool.to(dev),
                                       "tanh", bf)
        want = fe.reference_embed_pool_bwd(x, *w, arg.cpu(), dpool, "tanh",
                                           bf)
        rss = fe.bwd_product_rss(x, *w, arg.cpu(), dpool, "tanh", bf)
        for name, a, b, c in zip(("w1", "b1", "g", "be", "w2", "b2"), got,
                                 copy, want):
            assert torch.equal(a, b), (lo, name)
            if name in ("w1", "w2"):
                assert fe.bf16_product_error(a.cpu(), c, rss[name == "w2"]) \
                    <= fe.BF16_PRODUCT_BAR, (lo, name)
            else:
                assert float((a.cpu() - c).abs().max()) <= 1e-4 * float(
                    c.abs().max()), (lo, name)


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


def test_fused_embed_bf16_autograd_on_card(dev):
    """In compute dtype bfloat16, fused_embed_pool's backward launches K4's
    bf16 mode on CUDA tensors (x stored in bf16) and gives the plain
    version's gradients at the bf16 bars of K4 above (dw1 and dw2 as a
    share of their terms' root-sum-square)."""
    bf = torch.bfloat16
    g = torch.Generator().manual_seed(6)
    x = torch.randn(50, 31, 13, generator=g).to(bf)
    w = _embed_params(g, 13)
    co = torch.randn(50, 64, generator=g)
    grads = []
    for d in (dev, torch.device("cpu")):
        ps = [t.to(d).requires_grad_() for t in w]
        before = fe.fused_embed_pool_bwd.launches
        (fe.fused_embed_pool(x.to(d), *ps, "tanh", bf) * co.to(d)).sum(
        ).backward()
        assert fe.fused_embed_pool_bwd.launches == before + (d == dev)
        grads.append([p.grad.cpu() for p in ps])
    xc = x.float()
    _, arg = fe.reference_embed_pool_argmax(xc, *w, "tanh", bf)
    rss = fe.bwd_product_rss(xc, *w, arg, co, "tanh", bf)
    for name, a, b in zip(("w1", "b1", "g", "be", "w2", "b2"), *grads):
        if name in ("w1", "w2"):
            assert fe.bf16_product_error(a, b, rss[name == "w2"]) <= \
                fe.BF16_PRODUCT_BAR, name
        else:
            assert float((a - b).abs().max()) <= 1e-4 * float(
                b.abs().max()), name


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


def test_bf16_train_iteration_on_card(dev):
    """One PPO iteration with the bf16 policy on 4 pool worlds on the card,
    in the JAX package's production pairing (split bf16 obs store, fused
    embed): K3 and K4 run their bf16 mode on bf16 x, K4 twice per
    minibatch; the losses are finite and the parameters move and stay
    float32."""
    from gpudrive_lab_torch.ppo.ppo import PPOConfig
    from gpudrive_lab_torch.ppo.train import build_trainer
    from gpudrive_lab_torch.rollout import pool_scene_paths, slice_env

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = slice_env(pool_scene_paths(root)[:4], device=dev)
    n = int(env.scene.agents.controlled.sum())
    cfg = PPOConfig(rollout_len=8, update_epochs=2, num_minibatches=2,
                    fused_embed=True, compact=-(-n // 64) * 64,
                    compact_mode="flat", policy_dtype="bfloat16",
                    remat_obs=False, obs_store="split",
                    obs_store_dtype="bfloat16")
    ppo, carry, fresh, train_fn = build_trainer(env, cfg, seed=0)
    assert ppo.policy.config.dtype == torch.bfloat16
    before = [p.detach().clone() for p in ppo.policy.parameters()]
    n4 = fe.fused_embed_pool_bwd.launches
    carry, m = train_fn(env.scene, carry, fresh, env.reward_weights)
    torch.cuda.synchronize()
    assert fe.fused_embed_pool_bwd.launches - n4 == 2 * 2 * 2
    assert all(bool(torch.isfinite(v).all()) for v in m.values())
    params = list(ppo.policy.parameters())
    assert all(p.dtype == torch.float32 for p in params)
    assert any(not torch.equal(a, b) for a, b in zip(params, before))


def _pool_dir():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(root, "data", "pool_v3")


def test_swap_on_card_then_kernels_match_plain(dev):
    """A loader's env on the card swaps in its next batch (another
    controlled count); K2 and K3 then hold against their plain versions on
    the new batch's state and observation rows."""
    from gpudrive_lab_torch.core import collision
    from gpudrive_lab_torch.core import step as stepmod
    from gpudrive_lab_torch.env.dataset import SceneDataLoader
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.rollout import SLICE_CONFIG, slice_policy

    loader = SceneDataLoader(_pool_dir(), 8, 1000,
                             sample_with_replacement=True, seed=1)
    env = GPUDriveTorchEnv(EnvConfig(**SLICE_CONFIG), data_loader=loader,
                           device=dev)
    n0 = int(env.cont_agent_mask.sum())
    env.swap_data_batch()
    ctrl = env.cont_agent_mask
    assert int(ctrl.sum()) != n0
    for _ in range(3):
        env.step_dynamics(torch.randint(0, env.action_space_n,
                                        ctrl.shape, device=dev))
    s, scene = env.state, env.scene
    active = ~collision._skip_mask(scene, s, stepmod.current_step_index(s))
    feat = collision.agent_features(scene, s, active,
                                    collision.agent_half_extents(scene))
    roads_t = collision.road_features_t(scene)
    got = _dense_on_card(dev, feat, roads_t)
    assert torch.equal(got, kernels.agent_road_hits_dense_plain(
        feat.cpu(), roads_t.cpu()))
    policy = slice_policy(device=dev, seed=0)
    rows = env.get_obs()[ctrl]
    for emb, x in ((policy.partner_embed,
                    rows[:, 6:768].unflatten(-1, (127, 6))),
                   (policy.road_map_embed,
                    rows[:, 768:].unflatten(-1, (200, 13)))):
        lin1, ln, _, _, lin2 = emb
        w = [t.detach().cpu() for t in (
            lin1.weight.t().contiguous(), lin1.bias, ln.weight, ln.bias,
            lin2.weight.t().contiguous(), lin2.bias)]
        _check_k3(x.contiguous(), x.cpu().contiguous(), w, "tanh")


def test_vec_env_on_card_matches_cpu(dev):
    """VecGPUDriveEnv over 4 worlds on the card against itself on the CPU:
    20 steps of the same actions and a resample, rewards, terminals and
    episode returns equal, obs within 1e-4."""
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.dataset import SceneDataLoader
    from gpudrive_lab_torch.env.env_vec import VecGPUDriveEnv
    from gpudrive_lab_torch.rollout import SLICE_CONFIG

    def vec(device):
        return VecGPUDriveEnv(
            EnvConfig(**SLICE_CONFIG),
            SceneDataLoader(_pool_dir(), 4, 1000, seed=2,
                            sample_with_replacement=True), device=device)

    gv, cv = vec(dev), vec("cpu")
    assert torch.equal(gv.flat_ids.cpu(), cv.flat_ids)
    gobs, cobs = gv.reset(), cv.reset()
    rng = np.random.default_rng(0)
    for t in range(20):
        if t == 10:
            gv.resample_scenario_batch()
            cv.resample_scenario_batch()
            gobs, cobs = gv.reset(), cv.reset()
        # the ego and partner blocks are ordered; road rows may tie
        assert float((gobs.cpu()[:, :768] - cobs[:, :768]).abs().max()) \
            <= 1e-4
        acts = torch.from_numpy(rng.integers(0, 91, cv.num_agents))
        gobs, grew, gterm, _, ginfo = gv.step(acts.to(dev))
        cobs, crew, cterm, _, cinfo = cv.step(acts)
        assert torch.equal(grew.cpu(), crew)
        assert torch.equal(gterm.cpu(), cterm)
        assert ginfo == cinfo
        assert torch.equal(gv.episode_returns.cpu(), cv.episode_returns)
    assert gv.data_coverage == cv.data_coverage


def test_wrapper_refuses_mixed_devices(dev):
    agents, roads = _features(np.random.default_rng(0), 1, 16, 8)
    with pytest.raises(ValueError):
        kernels.agent_road_hits_dense(agents.to(dev), roads)


def _rnn_trainers(dev, n_worlds=4, T=8):
    """The recurrent trainer in the flat layout on the card and on the CPU
    over the same pool worlds, with the same weights."""
    from gpudrive_lab_torch.networks.late_fusion import (
        LateFusionLSTMPolicy,
        PolicyConfig,
    )
    from gpudrive_lab_torch.ppo.ppo import PPOConfig
    from gpudrive_lab_torch.ppo.ppo_rnn import RnnPPO
    from gpudrive_lab_torch.rollout import pool_scene_paths, slice_env

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for device in (dev, torch.device("cpu")):
        env = slice_env(pool_scene_paths(root)[:n_worlds], device=device)
        n = int(env.scene.agents.controlled.sum())
        cfg = PPOConfig(rollout_len=T, update_epochs=2, num_minibatches=2,
                        compact=-(-n // 64) * 64, compact_mode="flat")
        pol = LateFusionLSTMPolicy(PolicyConfig(), device=device,
                                   generator=torch.Generator().manual_seed(0))
        out.append((env, RnnPPO(pol, env.params, env.spec, env.action_keys,
                                env.config.reward_type, cfg)))
    return out


def test_lstm_policy_step_on_card_matches_cpu(dev):
    """The LSTM policy step (default widths, lstm_hidden 128) on 512 rows
    from a random carry, some rows reset: logits, value and both carries
    within 1e-4 of the CPU's."""
    from gpudrive_lab_torch.networks.late_fusion import (
        LateFusionLSTMPolicy,
        PolicyConfig,
    )

    rng = np.random.default_rng(0)
    obs = torch.from_numpy(rng.standard_normal((512, 3368)).astype(
        np.float32))
    carry = tuple(torch.from_numpy(x) for x in (
        0.5 * rng.standard_normal((2, 512, 128))).astype(np.float32))
    done = torch.from_numpy((rng.random(512) < 0.2).astype(np.float32))
    outs = []
    for device in (dev, "cpu"):
        pol = LateFusionLSTMPolicy(PolicyConfig(), device=device,
                                   generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            (c, h), logits, value = pol(obs.to(device),
                                        tuple(x.to(device) for x in carry),
                                        done.to(device))
        outs.append([t.cpu() for t in (c, h, logits, value)])
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_rnn_update_on_card_matches_cpu(dev):
    """One recurrent rollout (the same actions) and update (the same
    minibatch order) in the flat layout on 4 pool worlds, card against
    CPU: the trajectory's rewards, dones and masks equal, values within
    1e-4, the losses within 1e-4 and every parameter within 2 lr per
    Adam step (the most a sign flip of a near-zero gradient can move an
    entry apart).  The rollout launches K2 once per step."""
    (genv, grnn), (cenv, crnn) = _rnn_trainers(dev)
    T = grnn.config.rollout_len
    rows = grnn.config.compact
    actions = torch.from_numpy(np.random.default_rng(2).integers(
        0, 91, (T, rows)))
    perms = [torch.randperm(rows, generator=torch.Generator().manual_seed(e))
             .reshape(2, rows // 2).tolist() for e in range(2)]
    from gpudrive_lab_torch.core import step as stepmod
    from gpudrive_lab_torch.ppo.ppo_rnn import start_carry

    res = []
    for env, rnn in ((genv, grnn), (cenv, crnn)):
        fresh = stepmod.reset(env.scene, None, env.params)
        carry = start_carry(rnn, env.scene, fresh, env.world_time_steps,
                            torch.Generator(device=env.device).manual_seed(0))
        n2 = kernels.agent_road_hits_dense.launches
        carry2, traj = rnn.rollout(env.scene, carry, fresh,
                                   env.reward_weights,
                                   actions=actions.to(env.device))
        launches = kernels.agent_road_hits_dense.launches - n2
        m = rnn.update(env.scene, carry2, traj, env.reward_weights,
                       carry.lstm, perms=perms)
        res.append((traj, {k: float(v) for k, v in m.items()},
                    {k: v.detach().cpu() for k, v in
                     rnn.policy.state_dict().items()}, launches))
    (gt, gm, gp, gl), (ct, cm, cp, _) = res
    assert gl == T
    for name in ("reward", "done", "mask", "reset_pre"):
        assert torch.equal(getattr(gt, name).cpu(), getattr(ct, name)), name
    torch.testing.assert_close(gt.value.cpu(), ct.value, rtol=0, atol=1e-4)
    for k in ("pg_loss", "v_loss", "entropy", "approx_kl"):
        assert abs(gm[k] - cm[k]) <= 1e-4, (k, gm[k], cm[k])
    bar = 2 * grnn.config.learning_rate * 4
    for k in gp:
        assert float((gp[k] - cp[k]).abs().max()) <= bar, k


def test_bc_net_and_step_on_card_match_cpu(dev):
    """The BC net (default widths) on 64 rows, two with every partner
    masked, card against CPU: context and GMM outputs within 1e-4,
    recorded attention within 1e-5 (uniform on the masked rows); one AdamW
    step: loss within 1e-4, parameters within 2 lr of each other."""
    from gpudrive_lab_torch.il.networks import BCConfig, EarlyFusionAttnBCNet
    from gpudrive_lab_torch.il.train import BCTrainConfig, make_bc_train_step

    cfg = BCConfig(num_stack=2)
    rng = np.random.default_rng(3)
    batch = {
        "obs": torch.from_numpy(rng.standard_normal(
            (64, cfg.obs_dim)).astype(np.float32)),
        "partner_mask": torch.from_numpy(rng.random((64, 127)) < 0.8),
        "road_mask": torch.from_numpy(rng.random((64, 200)) < 0.5),
        "actions": torch.from_numpy(rng.normal(
            scale=0.5, size=(64, 1, 3)).astype(np.float32)),
    }
    batch["partner_mask"][:2] = True
    outs = []
    for device in (dev, torch.device("cpu")):
        net = EarlyFusionAttnBCNet(cfg, device=device,
                                   generator=torch.Generator().manual_seed(4))
        b = {k: v.to(device) for k, v in batch.items()}
        with torch.no_grad():
            ctx, gmm, rec = net(b["obs"], b["partner_mask"],
                                b["road_mask"], record=True)
        _, step = make_bc_train_step(net, BCTrainConfig())
        loss = step(b)
        outs.append(dict(
            ctx=ctx.cpu(), gmm=[g.cpu() for g in gmm],
            attn={k: v.cpu() for k, v in rec["attn"].items()},
            loss=float(loss),
            params={k: v.detach().cpu() for k, v in
                    net.state_dict().items()}))
    g, c = outs
    torch.testing.assert_close(g["ctx"], c["ctx"], rtol=0, atol=1e-4)
    for a, b in zip(g["gmm"], c["gmm"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for k in c["attn"]:
        torch.testing.assert_close(g["attn"][k], c["attn"][k], rtol=0,
                                   atol=1e-5)
    uniform = g["attn"]["ego_ro_cross.attn"][:2]
    torch.testing.assert_close(uniform, torch.full_like(uniform, 1 / 127))
    assert abs(g["loss"] - c["loss"]) <= 1e-4
    for k in c["params"]:
        assert float((g["params"][k] - c["params"][k]).abs().max()) \
            <= 2 * 3e-4, k


def test_il_data_generation_on_card_matches_cpu(dev):
    """Expert data of 2 pool worlds on the card against the CPU: masks,
    actions and action indices equal, positions within 1e-3; K2 launches
    on every replay step."""
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.il.data_generation import (
        generate_state_action_pairs,
    )
    from gpudrive_lab_torch.rollout import pool_scene_paths

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = EnvConfig(dynamics_model="delta_local",
                    collision_behavior="ignore", max_controlled_agents=0)
    out = []
    for device in (dev, "cpu"):
        env = GPUDriveTorchEnv(cfg, pool_scene_paths(root)[:2],
                               device=device)
        n2 = kernels.agent_road_hits_dense.launches
        data = generate_state_action_pairs(env)
        out.append(({k: v.cpu() for k, v in data.items()},
                    kernels.agent_road_hits_dense.launches - n2))
    (g, launches), (c, _) = out
    assert launches >= 91
    for k in ("dead_mask", "partner_mask", "road_mask", "actions",
              "action_idx", "controlled_mask", "valid_mask"):
        assert torch.equal(g[k], c[k]), k
    torch.testing.assert_close(g["positions"], c["positions"], rtol=0,
                               atol=1e-3)


def _rel(got, want) -> float:
    return float((got.cpu() - want).abs().max() / want.abs().max())


def test_vbd_env_on_card_matches_cpu(dev):
    """The VBD env of 2 pool worlds on the card against the CPU: an
    OfficialVBDSource (1 layer, 3 diffusion steps, the same seeded weights
    and given draws) within 1e-4 of the trajectories' largest magnitude,
    then 5 steps with the VBD obs block and reward within 1e-4; K2 launches
    on every step."""
    from gpudrive_lab_torch.env.config import EnvConfig
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.rollout import SLICE_CONFIG, pool_scene_paths
    from gpudrive_lab_torch.vbd.integration import OfficialVBDSource
    from gpudrive_lab_torch.vbd.model_official import (
        OfficialVBD,
        OfficialVBDConfig,
    )

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = EnvConfig(**dict(SLICE_CONFIG, use_vbd=True, vbd_in_obs=True,
                           reward_type="distance_to_vdb_trajs"))
    ocfg = OfficialVBDConfig(encoder_layers=1, diffusion_steps=3)
    rng = np.random.default_rng(0)
    draws = [rng.standard_normal((2, 32, 16, 2)).astype(np.float32)
             for _ in range(4)]
    acts = rng.integers(0, 91, (5, 2, 128))
    out = []
    for device in (dev, "cpu"):
        env = GPUDriveTorchEnv(cfg, pool_scene_paths(root)[:2],
                               device=device)
        model = OfficialVBD(ocfg, device=device, generator=torch.Generator()
                            .manual_seed(0)).eval()
        source = OfficialVBDSource(model)
        source.noise = draws
        env.set_vbd_trajectories(source)
        n2 = kernels.agent_road_hits_dense.launches
        obs, rew = [], []
        for t in range(5):
            env.step_dynamics(torch.from_numpy(acts[t]).to(device))
            obs.append(env.get_obs()[..., -455:].cpu())
            rew.append(env.get_rewards().cpu())
        out.append((env.vbd_trajectories.cpu(), torch.stack(obs),
                    torch.stack(rew), kernels.agent_road_hits_dense.launches
                    - n2))
    (gt, go, gr, launches), (ct, co, cr, _) = out
    assert launches == 5
    assert ct.abs().sum() > 0
    assert _rel(gt, ct) <= 1e-4
    assert _rel(go, co) <= 1e-4
    torch.testing.assert_close(gr, cr, rtol=0, atol=1e-4)


def test_vbd_guidance_and_loss_on_card_match_cpu(dev):
    """The TPU-first VBD model (hidden 64) on the card against the CPU:
    waymo-guided sampling with the same draws, and denoise_loss with its
    gradient, within 1e-4 of the largest magnitude."""
    from gpudrive_lab_torch.vbd import guidance, guidance_metrics as gm
    from gpudrive_lab_torch.vbd import model as vmodel

    cfg = vmodel.VBDConfig(future_len=20, agents_len=4, diffusion_steps=3,
                           encoder_layers=1, hidden_dim=64, num_heads=4)
    rng = np.random.default_rng(1)
    batch = {"agents_history": rng.normal(size=(2, 4, 11, 8)) * 5,
             "agents_id": np.tile(np.arange(4), (2, 1)),
             "agents_interested": np.ones((2, 4), np.int32),
             "polylines": rng.normal(size=(2, 6, 10, 5)) * 10}
    batch["agents_history"][..., 5:7] = [4.5, 2.0]
    batch["polylines"][..., 4] = 1
    batch = {k: torch.from_numpy(np.asarray(v, np.float32 if v.dtype.kind
                                            == "f" else v.dtype))
             for k, v in batch.items()}
    draws = [rng.standard_normal((2, 4, 4, 2)).astype(np.float32)
             for _ in range(4)]
    loss_draws = [rng.integers(0, 3, (2, 4)),
                  rng.standard_normal((2, 4, 4, 2)).astype(np.float32)]
    gt = torch.from_numpy(rng.normal(size=(2, 4, 4, 2)).astype(np.float32))
    out = []
    for device in (dev, "cpu"):
        m = vmodel.VBDModel(cfg, device=device,
                            generator=torch.Generator().manual_seed(2))
        b = {k: v.to(device) for k, v in batch.items()}
        res = guidance.sample_denoiser_waymo(
            m, vmodel.DDPMScheduler(3), b, cfg, draws,
            rewards=[gm.overlap_reward(clip=30.0), gm.onroad_reward()],
            guidance_iter=2, gradient_scale=0.05)
        loss = vmodel.denoise_loss(m, vmodel.DDPMScheduler(3), b,
                                   gt.to(device), cfg, loss_draws)
        loss.backward()
        grads = torch.cat([p.grad.flatten().cpu() for p in m.parameters()
                           if p.grad is not None])
        out.append(({k: v.cpu() for k, v in res.items()}, loss.detach().cpu(),
                    grads))
    (g, gl, gg), (c, cl, cg) = out
    for k in ("denoised_actions", "denoised_trajs", "reward_history"):
        assert _rel(g[k], c[k]) <= 1e-4, k
    assert _rel(gl, cl) <= 1e-4
    assert _rel(gg, cg) <= 1e-4


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_vbd_compute_dtypes_on_card_match_cpu(dev, dtype):
    """The TPU-first VBD model (hidden 64) in compute dtype bf16 and
    float16 on the card against the CPU: waymo-guided sampling (its reward
    gradients flow through the mixed-precision denoiser) with the same
    draws, and denoise_loss with its gradient, within 6 units of the
    dtype's roundoff of the largest magnitude (tests/test_torch_vbd_dtype.py
    states why: a sum in another order flips a rounding to the dtype)."""
    from gpudrive_lab_torch.vbd import guidance, guidance_metrics as gm
    from gpudrive_lab_torch.vbd import model as vmodel

    cd = getattr(torch, dtype)
    bar = 6 * {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -11}[dtype]
    cfg = vmodel.VBDConfig(future_len=20, agents_len=4, diffusion_steps=3,
                           encoder_layers=1, hidden_dim=64, num_heads=4,
                           dtype=cd)
    rng = np.random.default_rng(1)
    batch = {"agents_history": rng.normal(size=(2, 4, 11, 8)) * 5,
             "agents_id": np.tile(np.arange(4), (2, 1)),
             "agents_interested": np.ones((2, 4), np.int32),
             "polylines": rng.normal(size=(2, 6, 10, 5)) * 10}
    batch["agents_history"][..., 5:7] = [4.5, 2.0]
    batch["polylines"][..., 4] = 1
    batch = {k: torch.from_numpy(np.asarray(v, np.float32 if v.dtype.kind
                                            == "f" else v.dtype))
             for k, v in batch.items()}
    draws = [rng.standard_normal((2, 4, 4, 2)).astype(np.float32)
             for _ in range(4)]
    loss_draws = [rng.integers(0, 3, (2, 4)),
                  rng.standard_normal((2, 4, 4, 2)).astype(np.float32)]
    gt = torch.from_numpy(rng.normal(size=(2, 4, 4, 2)).astype(np.float32))
    out = []
    for device in (dev, "cpu"):
        m = vmodel.VBDModel(cfg, device=device,
                            generator=torch.Generator().manual_seed(2))
        b = {k: v.to(device) for k, v in batch.items()}
        res = guidance.sample_denoiser_waymo(
            m, vmodel.DDPMScheduler(3), b, cfg, draws,
            rewards=[gm.overlap_reward(clip=30.0), gm.onroad_reward()],
            guidance_iter=2, gradient_scale=0.05)
        loss = vmodel.denoise_loss(m, vmodel.DDPMScheduler(3), b,
                                   gt.to(device), cfg, loss_draws)
        loss.backward()
        grads = torch.cat([p.grad.flatten().cpu() for p in m.parameters()
                           if p.grad is not None])
        assert grads.dtype == torch.float32 and bool(grads.isfinite().all())
        out.append(({k: v.cpu() for k, v in res.items()}, loss.detach().cpu(),
                    grads))
    (g, gl, gg), (c, cl, cg) = out
    errs = {k: _rel(g[k], c[k]) for k in ("denoised_actions",
                                          "denoised_trajs", "reward_history")}
    errs.update(loss=_rel(gl, cl), grad=_rel(gg, cg))
    print(f"VBD {dtype} card against CPU, of the largest magnitude: {errs} "
          f"(bar {bar:.3g})")
    for k, v in errs.items():
        assert v <= bar, (k, v)


def _on(obj, device):
    """A Scene or SimState with every tensor moved to ``device``."""
    import dataclasses

    return type(obj)(**{
        f.name: None if v is None
        else _on(v, device) if dataclasses.is_dataclass(v)
        else v.to(device)
        for f in dataclasses.fields(obj)
        for v in (getattr(obj, f.name),)})


def test_render_on_card_matches_host_render(dev):
    """env.render of a card env's state (2-D and 3-D, zoomed) equals the
    CPU visualizer's figure of the same scene and state copied to the
    host, pixel for pixel.  Needs matplotlib."""
    pytest.importorskip("matplotlib")
    from gpudrive_lab_torch.env.config import EnvConfig, RenderConfig
    from gpudrive_lab_torch.env.env_torch import GPUDriveTorchEnv
    from gpudrive_lab_torch.rollout import SLICE_CONFIG, pool_scene_paths
    from gpudrive_lab_torch.visualize.core import MatplotlibVisualizer

    paths = pool_scene_paths(os.path.dirname(os.path.dirname(_pool_dir())))
    env = GPUDriveTorchEnv(EnvConfig(**SLICE_CONFIG), paths[:4], device=dev,
                           render_config=RenderConfig())
    g = torch.Generator(device=dev).manual_seed(0)
    for _ in range(5):
        env.step_dynamics(torch.randint(0, env.action_space_n,
                                        (4, env.max_agent_count),
                                        generator=g, device=dev))
    scene, state = _on(env.scene, "cpu"), _on(env.state, "cpu")
    for render_3d in (False, True):
        env.render_config.render_3d = render_3d
        host = MatplotlibVisualizer(scene, RenderConfig(render_3d=render_3d))
        for w in range(4):
            got = env.render(w, zoom_radius=60.0)
            want = host.plot_simulator_state(state, [w],
                                             zoom_radius=60.0)[0]
            assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_load_pretrained_on_card_matches_cpu(dev, tmp_path):
    """A reference NeuralNet state dict (chip_smoke's, seeded) loaded with
    load_pretrained(device="cuda"), then with fused_embed through
    dataclasses.replace: its logits and values on 4 pool worlds' first
    observation within 1e-4 of the same weights on the CPU (plain embed),
    K3 launched."""
    import dataclasses

    from chip_smoke import reference_state_dict
    from gpudrive_lab_torch.networks.convert import load_pretrained
    from gpudrive_lab_torch.networks.late_fusion import LateFusionPolicy
    from gpudrive_lab_torch.rollout import pool_scene_paths, slice_env

    sd = reference_state_dict(3)
    torch.save(sd, tmp_path / "model.pt")
    policy, cfg = load_pretrained(str(tmp_path), device="cuda")
    assert next(policy.parameters()).device.type == "cuda"
    fused = LateFusionPolicy(dataclasses.replace(cfg, fused_embed=True),
                             device=dev)
    fused.load_state_dict(policy.state_dict())
    cpu, _ = load_pretrained(str(tmp_path), device="cpu")
    paths = pool_scene_paths(os.path.dirname(os.path.dirname(_pool_dir())))
    obs = slice_env(paths[:4], device="cpu").get_obs()
    before = fe.fused_embed_pool_fwd.launches
    with torch.no_grad():
        got = [t.cpu() for t in fused(obs.to(dev))]
        want = cpu(obs)
    assert fe.fused_embed_pool_fwd.launches > before
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-4


def test_grid_and_top_k_on_card_match_cpu(dev):
    """One collision pass on a small large map (4 worlds x 10,240 roads)
    under the grid and top-K (K = 32 and 2) on the card, against the same
    pass on the CPU, and against K1 and K2 on the card; neither launches
    K1 or K2."""
    import dataclasses

    from gpudrive_lab_torch.core.collision import collision_system
    from gpudrive_lab_torch.core.types import CollisionBehaviour, Params
    from gpudrive_lab_torch.scene.large_map import large_map_scene

    kw = dict(W=4, A=32, R=10240, n_active=24, seed=0)
    base = Params(collision_behaviour=CollisionBehaviour.IGNORE)
    card = large_map_scene(**kw, device=dev)
    cpu = large_map_scene(**kw, device="cpu")
    want = collision_system(*card[:2], base, card[2]).collided_road
    dense = collision_system(*card[:2], dataclasses.replace(
        base, use_tile_collision=False), card[2]).collided_road
    assert torch.equal(want, dense)
    for p in (dataclasses.replace(base, use_collision_grid=True),
              dataclasses.replace(base, collision_top_k=32),
              dataclasses.replace(base, collision_top_k=2)):
        before = (kernels.agent_road_hits_dense.launches,
                  kernels.agent_road_hits_tiled.launches)
        got = collision_system(*card[:2], p, card[2]).collided_road
        assert (kernels.agent_road_hits_dense.launches,
                kernels.agent_road_hits_tiled.launches) == before
        assert torch.equal(got.cpu(), collision_system(*cpu[:2], p,
                                                       cpu[2]).collided_road)
        assert torch.equal(got, want)


def test_sharded_learners_on_card_match_one_process(dev):
    """The three learner configurations of parallel/dryrun.py on 2 gloo
    ranks sharing the card, 2 pool worlds each, a narrow head: at the
    dryrun's bars, the ranks' parameters bitwise equal, K2 launched on
    every rank and K3/K4 (and their bf16 modes) in configurations 1 and
    2."""
    from gpudrive_lab_torch.parallel.dryrun import dryrun_multiprocess

    report = dryrun_multiprocess(2, dev, worlds_per_rank=2,
                                 widths=dict(hidden_dim=32), lstm_hidden=16,
                                 backend="gloo", timeout=300)
    assert report["backend"] == "gloo"
    for name in ("dense", "flat+bf16+dot+swap", "rnn-flat"):
        for n in report[name]["launches"]:
            assert n["K2"] > 0
            if name == "dense":
                assert n["K3"] > 0 and n["K4"] > 0
            if name.startswith("flat"):
                assert n["K3-bf16"] > 0 and n["K4-bf16"] > 0


# ---- K6 over stacked times: the update's observation recompute -----------

# the benchmark's train cell (benchmark/configs/ppo_late_fusion.json)
TRAIN_PPO = dict(rollout_len=32, update_epochs=4, num_minibatches=4,
                 compact=4416, compact_mode="flat", fused_embed=True)


def _bits_equal(got, want, what):
    """Bit for bit, with the count and size of any difference."""
    assert got.shape == want.shape, what
    diff = got.view(torch.int32) != want.view(torch.int32)
    n = int(diff.sum())
    assert n == 0, (f"{what}: {n} of {diff.numel()} floats differ, max abs "
                    f"{float((got - want).abs().nan_to_num(1e30).max())}")


@pytest.fixture(scope="module", params=["linear", "k_nearest_roadpoints"])
def train_pool(request):
    """The 512 pool worlds on the card, the train cell's trainer with roads
    selected either way (the cell's LINEAR, and KNEAREST) and one 32-step
    rollout of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from gpudrive_lab_torch.ppo.ppo import PPOConfig
    from gpudrive_lab_torch.ppo.train import build_trainer
    from gpudrive_lab_torch.rollout import pool_scene_paths, slice_env

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = slice_env(pool_scene_paths(root), device="cuda",
                    road_obs_algorithm=request.param, obs_radius=50.0)
    ppo, carry, fresh, train_fn = build_trainer(env, PPOConfig(**TRAIN_PPO),
                                                seed=0)
    carry, traj = ppo.rollout(env.scene, carry, fresh, env.reward_weights)
    return env, ppo, carry, fresh, train_fn, traj


def _rows_check(scene, states, t_idx, ego, params, what: str) -> None:
    """K6's rows path (``flat_obs_rows``) launched twice into memory that
    held NaN: one launch pair per 32 time indices a call, both calls' bits
    equal, no float left unwritten.  Against ``flat_obs_rows_plain`` on the
    card: LINEAR bit for bit; KNEAREST bit for bit but in the rows where
    two of the ego's 201 nearest roads share a d2, and every row bit for
    bit against the plain code with its road rows at K6's rule's indices
    (road_order.py)."""
    from unittest import mock

    from gpudrive_lab_torch.core import observations as obsmod
    from gpudrive_lab_torch.core.types import RoadObsAlgorithm
    from gpudrive_lab_torch.env import flat_obs_kernel as k6
    from gpudrive_lab_torch.env.env_torch import ObsSpec

    import road_order

    W, A = scene.agents.valid.shape
    n = len(road_order.ego_pairs(ego, W, A, "cuda")[0])
    # the caching allocator hands this block to K6's output next
    junk = torch.full((len(t_idx) * n, k6.OBS_DIM), float("nan"),
                      device="cuda")
    del junk
    args = (scene, states, t_idx, ego, params, ObsSpec(), None)
    before = k6.flat_obs_step.launches
    got = k6.flat_obs_rows(*args)
    again = k6.flat_obs_rows(*args)
    torch.cuda.synchronize()
    pairs = -(-len(t_idx) // k6.MAX_TIMES)
    assert k6.flat_obs_step.launches == before + 2 * pairs, what
    assert got.shape == (len(t_idx) * n, k6.OBS_DIM), what
    assert not bool(got.isnan().any()), what
    _bits_equal(got, again, f"{what}: two launches")
    want = k6.flat_obs_rows_plain(*args)
    if params.road_obs_algorithm == RoadObsAlgorithm.LINEAR:
        _bits_equal(got, want, what)
        return
    ties, rule = [], []
    for t in t_idx:
        state = k6.state_at(states, t)
        idx, count, tie = road_order.nearest_first(scene, state, params, ego)
        rows = road_order.road_rows_at(scene, state, params, ego, idx, count)
        with mock.patch.object(obsmod, "agent_map_observations",
                               lambda *a: rows):
            rule.append(k6.flat_obs_rows_plain(
                scene, states, [t], ego, params, ObsSpec(), None))
        ties.append(tie)
    ties = torch.cat(ties)
    same = _row_bits_equal(got, want)
    assert bool((same | ties).all()), (
        f"{what}: {int((~same & ~ties).sum())} rows differ")
    _bits_equal(got, torch.cat(rule), f"{what}: K6's road order")
    print(f"[K6 rows] {what}: {len(got)} rows, {int(ties.sum())} with two "
          "of the 201 nearest at one d2")


def test_k6_rows_match_plain_on_the_pool(train_pool):
    """4,416 flat rows x 8 time steps of the train cell."""
    env, ppo, _, _, _, traj = train_pool
    _rows_check(env.scene, traj.env_state, [5, 0, 31, 12, 7, 20, 3, 26],
                ppo.ctrl_slots(env.scene), env.params,
                f"pool, {env.params.road_obs_algorithm.name}, flat rows")


def test_k6_rows_match_plain_for_world_and_dense_rows(train_pool):
    """[W, 9] slots at 33 time indices (two launch pairs) and every agent
    row at 2."""
    env, _, _, _, _, traj = train_pool
    W, A = env.scene.agents.valid.shape
    g = torch.Generator().manual_seed(0)
    world = torch.stack([torch.randperm(A, generator=g)[:9]
                         for _ in range(W)]).cuda()
    for what, ego, t_idx in (("world", world, list(range(31, -1, -1)) + [9]),
                             ("dense", None, [17, 4])):
        _rows_check(env.scene, traj.env_state, t_idx, ego, env.params,
                    f"pool, {env.params.road_obs_algorithm.name}, {what}")


@pytest.mark.parametrize("roads", ["LINEAR", "KNEAREST"])
def test_k6_rows_match_plain_on_a_large_map(dev, roads):
    """10,240-road worlds, where egos see more than 200 roads in the
    radius: every agent row at 3 time steps."""
    import dataclasses

    from gpudrive_lab_torch.core.types import (
        Params,
        RoadObsAlgorithm,
        SimState,
    )
    from gpudrive_lab_torch.scene.large_map import LARGE_MAP, large_map_scene

    cfg = dict(LARGE_MAP, W=16)
    scene, state, _ = large_map_scene(**cfg, seed=3, device=dev, grid=False)
    g = torch.Generator(device=dev).manual_seed(1)
    states = [dataclasses.replace(
        state, pos=state.pos + i * torch.randn(state.pos.shape, generator=g,
                                               device=dev),
        yaw=state.yaw + 0.3 * i,
        vel=torch.randn(state.vel.shape, generator=g, device=dev),
        collided=(torch.rand(state.yaw.shape, generator=g, device=dev)
                  < 0.3).int()) for i in range(3)]
    stacked = SimState(**{f.name: torch.stack([getattr(s, f.name)
                                               for s in states])
                          for f in dataclasses.fields(SimState)})
    params = Params(road_obs_algorithm=RoadObsAlgorithm[roads],
                    observation_radius=50.0)
    d = scene.roads.pos[:, None, :, :2] - state.pos[:, :, None]
    assert int(((d * d).sum(-1) <= 2500.0).sum(-1).max()) > 200
    _rows_check(scene, stacked, [2, 0, 1], None, params,
                f"large map, {roads}, dense rows")


def test_k6_rows_launch_once_a_minibatch(train_pool):
    """One iteration of the train cell's settings: a launch pair per
    rollout step (32) and per minibatch of the update (16)."""
    from gpudrive_lab_torch.env import flat_obs_kernel as k6

    env, ppo, carry, fresh, train_fn, _ = train_pool
    rw = env.reward_weights
    before = k6.flat_obs_step.launches
    carry, traj = ppo.rollout(env.scene, carry, fresh, rw)
    torch.cuda.synchronize()
    assert k6.flat_obs_step.launches - before == 32
    batch = ppo.prepare(env.scene, carry, traj, rw)
    before = k6.flat_obs_step.launches
    ppo.learn(env.scene, batch, traj, rw)
    torch.cuda.synchronize()
    assert k6.flat_obs_step.launches - before == 16


def test_update_recomputes_the_rollouts_rows(train_pool, monkeypatch):
    """Every minibatch's recomputed rows equal, bit for bit, the rows the
    rollout's policy acted on (``flat_observation`` of each stored state),
    with either road selection: one kernel for both."""
    from gpudrive_lab_torch.env import flat_obs_kernel as k6
    from gpudrive_lab_torch.env.env_torch import flat_observation

    env, ppo, carry, fresh, _, _ = train_pool
    rows = k6.flat_obs_rows
    checked = []

    def check(scene, states, t_idx, ego, params, spec, rw):
        got = rows(scene, states, t_idx, ego, params, spec, rw)
        want = torch.cat([flat_observation(
            scene, k6.state_at(states, t), params, spec, rw, ego)[0]
            .reshape(-1, k6.OBS_DIM) for t in t_idx])
        _bits_equal(got, want, f"minibatch {len(checked)}")
        checked.append(len(t_idx))
        return got

    monkeypatch.setattr(k6, "flat_obs_rows", check)
    rw = env.reward_weights
    carry, traj = ppo.rollout(env.scene, carry, fresh, rw)
    ppo.learn(env.scene, ppo.prepare(env.scene, carry, traj, rw), traj, rw)
    assert checked == [8] * 16


# ---- K6: flat_observation of one state in two launches ---------------------

def _k6_selection(scene, sel: str):
    """Every ego selection K6 takes: every row, [W, 9] slots drawn per
    world (padded egos among them), or flat pairs of every created agent
    and 7 padded rows, shuffled across worlds."""
    W, A = scene.agents.valid.shape
    g = torch.Generator().manual_seed(2)
    if sel == "dense":
        return None
    if sel == "world":
        return torch.stack([torch.randperm(A, generator=g)[:9]
                            for _ in range(W)]).cuda()
    valid = scene.agents.valid
    pairs = torch.cat([valid.nonzero(), (~valid).nonzero()[:7]])
    pairs = pairs[torch.randperm(len(pairs), generator=g).cuda()]
    return pairs[:, 0], pairs[:, 1]


def _row_bits_equal(got, want) -> torch.Tensor:
    """[N] whether each row (the last axis) of got and want is equal bit
    for bit."""
    as_int = torch.uint8 if got.dtype == torch.bool else torch.int32
    return (got.flatten(0, -2).view(as_int)
            == want.flatten(0, -2).view(as_int)).all(-1)


def _k6_check(scene, state, params, ego, what: str) -> int:
    """K6 through flat_observation, twice, into memory that held NaN and
    out-of-range masks: one launch pair a call, both calls' bits equal,
    nothing left unwritten.  Against flat_observation_plain on the card,
    bit for bit: the partner mask everywhere, the rows and the road mask
    wherever no two of the ego's 201 nearest roads share a d2 (there
    torch.topk orders as it likes); and every row against the plain code
    with its road rows at K6's rule's indices (road_order.py: nearest
    first, ties to the lower index).  Returns the rows with such a tie."""
    from unittest import mock

    from gpudrive_lab_torch.core import observations as obsmod
    from gpudrive_lab_torch.env import flat_obs_kernel as k6
    from gpudrive_lab_torch.env.env_torch import (
        ObsSpec,
        flat_observation,
        flat_observation_plain,
    )

    import road_order

    W, A = scene.agents.valid.shape
    n = len(road_order.ego_pairs(ego, W, A, "cuda")[0])
    # the caching allocator hands these blocks to K6's outputs next
    junk = [torch.full((n, k6.OBS_DIM), float("nan"), device="cuda"),
            torch.full((n, 127), 7, dtype=torch.int32, device="cuda"),
            torch.full((n, 200), 7, dtype=torch.uint8, device="cuda")]
    del junk
    spec = ObsSpec()
    before = k6.flat_obs_step.launches
    got = flat_observation(scene, state, params, spec, None, ego)
    again = flat_observation(scene, state, params, spec, None, ego)
    torch.cuda.synchronize()
    assert k6.flat_obs_step.launches == before + 2
    obs, pmask, rmask = got
    assert not bool(obs.isnan().any()), what
    assert bool(((pmask >= 0) & (pmask <= 2)).all()), what
    assert bool((rmask.view(torch.uint8) <= 1).all()), what
    _bits_equal(obs, again[0], f"{what}: two launches")
    assert torch.equal(pmask, again[1]) and torch.equal(rmask, again[2])
    want = flat_observation_plain(scene, state, params, spec, None, ego)
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype, what
    assert torch.equal(pmask, want[1]), f"{what}: partner_mask"
    idx, count, ties = road_order.nearest_first(scene, state, params, ego)
    same = _row_bits_equal(obs, want[0]) & _row_bits_equal(rmask, want[2])
    assert bool((same | ties).all()), (
        f"{what}: {int((~same & ~ties).sum())} rows differ")
    rows = road_order.road_rows_at(scene, state, params, ego, idx, count)
    with mock.patch.object(obsmod, "agent_map_observations",
                           lambda *args: rows):
        rule = flat_observation_plain(scene, state, params, spec, None, ego)
    _bits_equal(obs, rule[0], f"{what}: K6's road order")
    assert torch.equal(rmask, rule[2]), f"{what}: K6's road mask"
    n_ties = int(ties.sum())
    print(f"[K6] {what}: {n} rows, {int((count == 200).sum())} at 200 "
          f"roads, {n_ties} with two of the 201 nearest at one d2")
    return n_ties


@pytest.fixture(scope="module", params=["k_nearest_roadpoints", "linear"])
def k6_pool(request):
    """The 512 pool worlds on the card (agent bucket 32), roads selected
    either way, after 5 random steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from gpudrive_lab_torch.rollout import pool_scene_paths, slice_env

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = slice_env(pool_scene_paths(root), device="cuda",
                    agent_bucket="auto", road_obs_algorithm=request.param,
                    obs_radius=50.0)
    g = torch.Generator(device="cuda").manual_seed(3)
    for _ in range(5):
        env.step_dynamics(torch.randint(
            0, env.action_space_n, env.scene.agents.valid.shape,
            generator=g, device="cuda"))
    return env


@pytest.mark.parametrize("sel", ["dense", "world", "flat"])
def test_k6_matches_flat_observation_on_the_pool(k6_pool, sel):
    env = k6_pool
    _k6_check(env.scene, env.state, env.params,
              _k6_selection(env.scene, sel),
              f"pool, {env.params.road_obs_algorithm.name}, {sel}")


@pytest.fixture(scope="module")
def k6_large_map():
    """16 synthetic worlds of 10,240 roads (the large-map cell's agent
    bucket of 32, 24 vehicles), the state moved off the generated one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    import dataclasses

    from gpudrive_lab_torch.scene.large_map import LARGE_MAP, large_map_scene

    scene, state, _ = large_map_scene(**dict(LARGE_MAP, W=16, A=32), seed=3,
                                      device="cuda", grid=False)
    g = torch.Generator(device="cuda").manual_seed(1)
    state = dataclasses.replace(
        state, pos=state.pos + torch.randn(state.pos.shape, generator=g,
                                           device="cuda"),
        yaw=state.yaw + 0.3,
        vel=torch.randn(state.vel.shape, generator=g, device="cuda"),
        collided=(torch.rand(state.yaw.shape, generator=g, device="cuda")
                  < 0.3).int())
    return scene, state


@pytest.mark.parametrize("sel", ["dense", "world", "flat"])
@pytest.mark.parametrize("roads", ["KNEAREST", "LINEAR"])
def test_k6_matches_flat_observation_on_a_large_map(k6_large_map, roads,
                                                   sel):
    """More than 200 roads in the radius of most egos."""
    from gpudrive_lab_torch.core.types import Params, RoadObsAlgorithm

    scene, state = k6_large_map
    params = Params(road_obs_algorithm=RoadObsAlgorithm[roads],
                    observation_radius=50.0)
    d = scene.roads.pos[:, None, :, :2] - state.pos[:, :, None]
    assert int(((d * d).sum(-1) <= 2500.0).sum(-1).max()) > 200
    _k6_check(scene, state, params, _k6_selection(scene, sel),
              f"large map, {roads}, {sel}")


def test_k6_breaks_d2_ties_at_the_200th_place_by_index(k6_large_map):
    """600 roads of world 0 stacked on one point 10 m from its first
    vehicle: the bin of the 200th holds more than the kernel ranks in
    place, so the radix select runs, and ties go to the lower index, in
    the block's order too."""
    import dataclasses

    from gpudrive_lab_torch.core.types import Params, RoadObsAlgorithm

    scene, state = k6_large_map
    pos = scene.roads.pos.clone()
    pos[0, 2000:2600, 0] = state.pos[0, 0, 0] + 6.0
    pos[0, 2000:2600, 1] = state.pos[0, 0, 1] + 8.0
    scene = dataclasses.replace(
        scene, roads=dataclasses.replace(scene.roads, pos=pos))
    params = Params(road_obs_algorithm=RoadObsAlgorithm.KNEAREST,
                    observation_radius=50.0)
    assert _k6_check(scene, state, params, None, "stacked roads") > 0

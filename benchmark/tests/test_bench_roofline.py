"""The frozen roofline counts and the late-fusion FLOP count on known
shapes."""

import pytest
import torch

from gdbench import roofline
from gdbench.reference import sat


def test_late_fusion_forward_flops_at_the_published_widths():
    f = roofline.late_fusion_forward_flops(6, 127, 6, 200, 13, 128, 91)
    # embeds 2*(6*64+64*64) + 127*2*(6*64+64*64) + 200*2*(13*64+64*64),
    # shared 2*192*128, actor 2*128*91, critic 2*128
    assert f == 8960 + 127 * 8960 + 200 * 9856 + 49152 + 23296 + 256
    assert f == pytest.approx(3.19e6, rel=2e-3)


def test_k2_bound_of_the_slice_is_its_bytes():
    # 512 worlds x 128 agent rows x 256 roads: 6.55 MB at 3.35 TB/s,
    # the 0.00196 ms of the port's kernel table
    t = roofline.k2_bound(512, 128, 256, ops=0)
    assert t * 1e3 == pytest.approx(0.00196, abs=5e-6)


def test_k3_bound_at_65536_rows_matches_the_kernel_table():
    # both blocks at 65,536 rows: 1.2349 ms in PERF.md's kernel table
    t = roofline.k3_bound(65536, 127, 6) + roofline.k3_bound(65536, 200, 13)
    assert t * 1e3 == pytest.approx(1.2349, rel=1e-3)


def test_k4_bound_grows_with_the_winners():
    a = roofline.k4_bound(35328, 13, 35328 * 10)
    b = roofline.k4_bound(35328, 13, 35328 * 40)
    assert 0 < a < b


def _pair(dx: float, dy: float, allow: float = 1.0):
    agents = torch.tensor([[[0.0, 0.0, 1.0, 0.0, 2.0, 1.0, 1.0, 1.0]]])
    roads = torch.tensor([[[dx], [dy], [1.0], [0.0], [2.0], [0.1],
                           [allow], [allow]]])
    return agents, roads


@pytest.mark.parametrize("dx,dy,allow,ops", [
    (1.0, 0.0, 1.0, sat.SAT_FLOPS),       # overlapping: the whole SAT
    (10.0, 0.0, 1.0, sat.SAT_EARLY_FLOPS),  # separated on the first axis
    (1.0, 0.0, 0.0, 0),                   # a pair its class may not hit
])
def test_live_pair_ops_of_one_pair(dx, dy, allow, ops):
    agents, roads = _pair(dx, dy, allow)
    assert sat.live_pair_ops(agents, roads) == ops
    assert sat.live_pairs(agents, roads) == (1 if allow else 0)


def test_k1_live_work_is_the_dense_work_inside_live_tiles():
    g = torch.Generator().manual_seed(0)
    W, A, T, RT = 2, 16, 3, 8
    agents = torch.rand((W, A, 8), generator=g)
    agents[..., 6:] = 1.0
    tiles = torch.rand((W, T, 8, RT), generator=g)
    tiles[:, :, 6:] = 1.0
    every = torch.ones((W, 1, T), dtype=torch.int32)
    dense = sum(sat.live_pair_ops(agents[w:w + 1], tiles[w].permute(
        1, 0, 2).reshape(1, 8, T * RT)) for w in range(W))
    assert sat.live_pair_ops_tiled(agents, tiles, every) == dense
    none = torch.zeros_like(every)
    assert sat.live_pair_ops_tiled(agents, tiles, none) == 0

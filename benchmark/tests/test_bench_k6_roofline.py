"""The reader of ``k6_roofline.sim``: silent without a trace, in a train
cell and unless each of K6's two kernels ran once a traced step; a fixed
share from a synthetic trace summary and a two-world scene whose roads in
the radius are counted by hand."""

from types import SimpleNamespace

import pytest
import torch

from gdbench import registry
from gdbench.trace import TraceSummary

# the kernels' names as the profiler gives them (parameters cut short)
SELECT = "void k6::road_select_kernel<true>(int*, int*, float const*, k6::Egos)"
STEP = "void k6::obs_step_kernel(float*, int*, unsigned char*, k6::Norm)"


def scene_and_state():
    """2 worlds x 3 agent rows (3 created), 300 roads: world 0's roads on
    the x axis 0.2 m apart (251 within 50 m of the origin, 250 valid of
    them); world 1's all 60 m away but road 7, at 3 m."""
    pos = torch.zeros((2, 300, 3))
    pos[0, :, 0] = 0.2 * torch.arange(300)
    pos[1, :, 0] = 60.0
    pos[1, 7, 0] = 3.0
    rvalid = torch.ones((2, 300), dtype=torch.bool)
    rvalid[0, 5] = False
    valid = torch.tensor([[True, True, False], [True, False, False]])
    scene = SimpleNamespace(
        agents=SimpleNamespace(valid=valid),
        roads=SimpleNamespace(pos=pos, valid=rvalid))
    return scene, SimpleNamespace(pos=torch.zeros((2, 3, 2)))


def ctx(n_select: int, n_step: int, seconds: float, steps: int = 2,
        kind="sim"):
    scene, state = scene_and_state()
    trace = TraceSummary(window_s=2.0, busy_s=1.0, device_ops=9,
                         by_name={SELECT: [n_select, seconds / 2],
                                  STEP: [n_step, seconds / 2],
                                  "other_kernel": [1, 0.5]})
    return {"driver": kind, "trace": trace, "traced_states": [state] * steps,
            "reference_scene": scene,
            "reference_params": SimpleNamespace(observation_radius=50.0)}


@pytest.fixture
def read():
    return registry.load_reader("k6_roofline.sim")


def test_silent_without_a_trace(read):
    assert read(dict(ctx(2, 2, 1e-3), trace=None)) is None
    assert read(dict(ctx(2, 2, 1e-3), traced_states=[])) is None


def test_silent_in_a_train_cell(read):
    assert read(ctx(2, 2, 1e-3, kind="train")) is None


@pytest.mark.parametrize("n_select,n_step", [(0, 0), (2, 0), (0, 2),
                                             (1, 2), (2, 3), (4, 4)])
def test_silent_unless_each_kernel_ran_once_a_step(read, n_select, n_step):
    assert read(ctx(n_select, n_step, 1e-3)) is None


def test_reads_the_output_and_index_bytes_over_the_device_time(read):
    # a step: 6 rows of 3368 * 4 + 127 * 4 + 200 bytes, the counts of 6
    # rows written and 3 read, 200 + 200 + 1 indices written and read
    per_step = 6 * 14180 + 4 * 9 + 8 * 401
    seconds = 2 * 1e-6
    share = read(ctx(2, 2, seconds))
    assert share == pytest.approx(100 * 2 * per_step / 3.35e12 / seconds)

"""The reader of ``k5_roofline.train``: silent without a trace, in a sim
cell and with another number of K5 launches; a fixed share from a
synthetic trace summary."""

import pytest

from gdbench import registry
from gdbench.trace import TraceSummary

PPO = {"rollout_len": 32, "update_epochs": 4, "num_minibatches": 4}
# the kernel's name as the profiler gives it
K5 = ("void k5::flat_obs_kernel(float*, float const*, float const*, "
      "float const*, int const*, float const*, float const*, unsigned char "
      "const*, int const*, float const*, float const*, float const*, int "
      "const*, unsigned char const*, long long const*, long long const*, "
      "int, int, int, int, k5::Times, k5::Norm)")


def ctx(launches: int, seconds: float, iters: int = 2, kind="train"):
    trace = TraceSummary(window_s=5.0, busy_s=1.0, device_ops=launches + 1,
                         by_name={K5: [launches, seconds],
                                  "other_kernel": [1, 0.5]})
    return {"driver": kind, "trace": trace, "iterations_traced": iters,
            "rows": 4416, "ppo": PPO}


@pytest.fixture
def read():
    return registry.load_reader("k5_roofline.train")


def test_silent_without_a_trace(read):
    assert read(dict(ctx(32, 1e-3), trace=None)) is None
    assert read(dict(ctx(32, 1e-3), iterations_traced=0)) is None


def test_silent_in_a_sim_cell(read):
    assert read(ctx(32, 1e-3, kind="sim")) is None


@pytest.mark.parametrize("launches", [0, 31, 33, 256])
def test_silent_with_another_launch_count(read, launches):
    assert read(ctx(launches, 1e-3)) is None


def test_reads_the_output_bytes_over_the_device_time(read):
    # 2 iterations x 16 minibatches of 4,416 x 8 rows: 476,106,752 bytes
    # a launch, 0.142 ms at 3.35 TB/s; 0.240 ms a launch on the card
    seconds = 32 * 0.240e-3
    share = read(ctx(32, seconds))
    assert share == pytest.approx(100 * 32 * 35328 * 3368 * 4 / 3.35e12
                                  / seconds)
    assert share == pytest.approx(59.20, abs=0.01)

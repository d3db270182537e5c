"""The window's arithmetic: the rate over the window and the 95th
percentile over every step interval."""

import numpy as np
import pytest

from gdbench import window


def test_rate_is_work_over_the_whole_window():
    assert window.rate(4372 * 1000, 10.0) == pytest.approx(437200.0)
    with pytest.raises(ValueError):
        window.rate(1.0, 0.0)


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1001])
def test_percentile_matches_numpy(n):
    xs = np.random.default_rng(n).exponential(5.0, n)
    for q in (0, 50, 95, 100):
        assert window.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)))


def test_p95_takes_every_interval_of_the_event_stamps():
    # 100 steps of 1 ms with one 50 ms stall: the stall is one interval
    stamps = [0.0]
    for i in range(100):
        stamps.append(stamps[-1] + (50.0 if i == 40 else 1.0))
    iv = window.intervals(stamps)
    assert len(iv) == 100 and max(iv) == 50.0
    assert window.percentile(iv, 95) == pytest.approx(1.0)
    assert window.percentile(iv, 100) == 50.0

"""The benchmark on the card: one short run of each one-chip cell, correct.
Skips without a card."""

import time

import pytest

from conftest import tiny_cell

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("name", ["sim_pool512", "train_pool512",
                                  "sim_largemap256"])
def test_short_run_on_the_card_is_correct(name, cuda_device):
    import run

    t0 = time.perf_counter()
    out = run.execute(tiny_cell(name), 12345, 1.0, True,
                      lambda: time.perf_counter() - t0, cuda_device)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0

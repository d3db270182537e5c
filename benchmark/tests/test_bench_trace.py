"""The reduction of a Chrome trace to busy time, operations by name and
idle gaps by what the host was doing."""

import pytest

from gdbench import trace


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_summary_of_a_known_window():
    events = [
        ev(trace.WINDOW, "user_annotation", 100, 1000),
        ev("gdbench.bench_step", "user_annotation", 100, 1000),
        ev("aten::cat", "cpu_op", 150, 100),
        ev("cudaLaunchKernel", "cuda_runtime", 400, 50),
        ev("k_a", "kernel", 200, 100),   # 200-300
        ev("k_b", "kernel", 250, 100),   # overlaps: union 200-350
        ev("Memcpy DtoH", "gpu_memcpy", 600, 100),  # 600-700
        ev("k_a", "kernel", 1050, 100),  # clipped to 1050-1100
        ev("k_out", "kernel", 2000, 10),  # outside the window
    ]
    s = trace.summarize_events(events)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.busy_s == pytest.approx((150 + 100 + 50) * 1e-6)
    assert s.device_ops == 4
    assert s.kernel("k_a") == (2, pytest.approx(150e-6))
    assert s.by_name["Memcpy DtoH"] == [1, pytest.approx(100e-6)]
    # gaps: 100-200 (aten::cat at 150), 350-600 (mid 475: the step span;
    # the launch ended at 450), 700-1050 (the step span)
    assert s.gaps_by_host["aten::cat"] == pytest.approx(100e-6)
    assert s.gaps_by_host["gdbench.bench_step"] == pytest.approx(600e-6)
    b = s.breakdown()
    assert b["device_ops"][0][0] == "k_a"
    assert b["idle_gaps"][0][0] == "gdbench.bench_step"


def test_no_window_span_gives_nothing():
    assert trace.summarize_events([ev("k", "kernel", 0, 1)]) is None

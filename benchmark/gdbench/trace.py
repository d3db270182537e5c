"""Reduction of a torch.profiler trace of the traced window to what the
per-layer metrics read: the device's busy time, its operations by name,
and the idle gaps by what the host was doing.

The trace is exported as Chrome trace JSON (one clock for host and
device events) and read back; only the events inside the ``WINDOW`` span
count.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

# the harness's own spans (record_function names) start with this
SPAN_PREFIX = "gdbench."
WINDOW = SPAN_PREFIX + "profiled_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime",
             "cuda_driver")


@dataclass
class TraceSummary:
    """What one traced window held.  Times in seconds."""

    window_s: float
    busy_s: float
    device_ops: int  # kernels, copies and sets that ran in the window
    by_name: dict = field(default_factory=dict)  # name -> [count, seconds]
    gaps_by_host: dict = field(default_factory=dict)  # host op -> seconds

    def kernel(self, *names):
        """(count, seconds) of the device operations whose function name
        (without return type, namespaces, template arguments and
        parameters) is one of ``names``."""
        n = t = 0
        for name, (c, s) in self.by_name.items():
            if base_name(name) in names:
                n += c
                t += s
        return n, t

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.gaps_by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v[1]] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}


def base_name(name: str) -> str:
    """``embed_pool_fwd_kernel`` of ``void (anonymous
    namespace)::embed_pool_fwd_kernel<0, 2>(float const*, ...)``."""
    head = name.split("(anonymous namespace)::")[-1]
    head = head.split("(", 1)[0].split("<", 1)[0]
    return head.split("::")[-1].split(" ")[-1]


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_at(mid: float, host, starts, outer, scan: int = 500) -> str:
    """The innermost host operation open at time ``mid``: the latest
    started of those containing it, looked for among the ``scan`` last
    started, then among the harness's own spans (``outer``)."""
    i = bisect.bisect_right(starts, mid)
    for hs, ht, name in reversed(host[max(0, i - scan):i]):
        if ht >= mid:
            return name
    best = None
    for hs, ht, name in outer:
        if hs <= mid <= ht and (best is None or hs >= best[0]):
            best = (hs, name)
    return best[1] if best else "host idle"


def summarize_events(events) -> TraceSummary | None:
    """Summary of Chrome trace ``events`` (dicts with ph, cat, name, ts, dur
    in microseconds) inside the ``WINDOW`` span; None without that span."""
    spans = [e for e in events if e.get("name") == WINDOW
             and e.get("ph") == "X"]
    if not spans:
        return None
    w0 = float(spans[0]["ts"])
    w1 = w0 + float(spans[0]["dur"])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        if t <= w0 or s >= w1:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((max(s, w0), min(t, w1), e.get("name", "?")))
        elif cat in HOST_CATS and e.get("name") != WINDOW:
            host.append((s, t, e.get("name", "?")))
    by_name = defaultdict(lambda: [0, 0.0])
    for s, t, name in dev:
        by_name[name][0] += 1
        by_name[name][1] += (t - s) * 1e-6
    busy = _union([(s, t) for s, t, _ in dev])
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if prev < w1:
        gaps.append((prev, w1))
    host.sort()
    starts = [h[0] for h in host]
    outer = [h for h in host if h[2].startswith(SPAN_PREFIX)]
    gaps_by_host = defaultdict(float)
    for s, t in gaps:
        gaps_by_host[_host_at(0.5 * (s + t), host, starts, outer)] += (
            (t - s) * 1e-6)
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(t - s for s, t in busy) * 1e-6,
        device_ops=len(dev),
        by_name=dict(by_name),
        gaps_by_host=dict(gaps_by_host),
    )


def summarize_profile(prof) -> TraceSummary | None:
    """Export ``prof`` (a finished torch.profiler.profile) to a temporary
    Chrome trace, read it back and summarize it."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return summarize_events(events)

"""Training telemetry (port of ``gpudrive_lab_tpu/utils/profiling.py``).

Mirror of the reference's PPO profiling (reference:
gpudrive/integrations/puffer/ppo.py: ``Profile`` per-phase timers and
controlled/padded SPS :426-515, the ``Utilization`` monitor thread
:669-692).  ``Utilization`` reads the device's allocated memory through
``torch.cuda``; ``device_trace`` and ``device_breakdown`` take and read a
torch.profiler trace."""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict, deque

import torch


class Profile:
    """Per-phase wall-clock accounting with agent-SPS summaries."""

    PHASES = ("env", "eval_forward", "train_forward", "learn", "misc")

    def __init__(self):
        self.elapsed = defaultdict(float)
        self.start_t = time.time()
        self.controlled_agent_steps = 0
        self.padded_agent_steps = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.elapsed[name] += time.time() - t0

    def account(self, controlled_steps: int, padded_steps: int):
        self.controlled_agent_steps += controlled_steps
        self.padded_agent_steps += padded_steps

    @property
    def uptime(self) -> float:
        return time.time() - self.start_t

    def summary(self) -> dict:
        total = max(self.uptime, 1e-9)
        out = {f"time_{k}_s": round(v, 2) for k, v in self.elapsed.items()}
        out["uptime_s"] = round(total, 1)
        out["controlled_agent_sps"] = round(self.controlled_agent_steps / total)
        out["padded_agent_sps"] = round(self.padded_agent_steps / total)
        return out


class Utilization(threading.Thread):
    """Background sampler of host cpu/memory (psutil, when installed) and of
    the CUDA device's allocated memory (reference: ppo.py:669-692).
    ``stop()`` ends the thread within one ``delay``."""

    def __init__(self, delay: float = 1.0, maxlen: int = 300):
        super().__init__(daemon=True)
        self.delay = delay
        self.cpu_util = deque(maxlen=maxlen)
        self.mem_util = deque(maxlen=maxlen)
        self.device_mem = deque(maxlen=maxlen)
        self._stop_event = threading.Event()

    def run(self):
        try:
            import psutil
        except ImportError:
            psutil = None
        cuda = torch.cuda.is_available()
        while not self._stop_event.is_set():
            if psutil is not None:
                self.cpu_util.append(psutil.cpu_percent())
                self.mem_util.append(psutil.virtual_memory().percent)
            if cuda:
                self.device_mem.append(torch.cuda.memory_allocated() / 2**30)
            self._stop_event.wait(self.delay)

    def stop(self):
        self._stop_event.set()

    def summary(self) -> dict:
        mean = lambda q: round(sum(q) / len(q), 1) if q else 0.0
        return {
            "cpu_util": mean(self.cpu_util),
            "mem_util": mean(self.mem_util),
            "device_mem_gib": mean(self.device_mem),
        }


@contextlib.contextmanager
def device_trace(log_dir: str | None = None):
    """Trace CPU and CUDA activity around a block with torch.profiler (the
    counterpart of the JAX package's jax.profiler capture).  Yields the
    profiler; writes a chrome trace to <log_dir>/trace.json when given."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_breakdown(prof, ranges=()):
    """Device time of a trace: (busy µs, {activity name: [µs, count]},
    {range: µs}).  ``ranges`` names ``record_function`` ranges: each gets
    the device time of the work launched inside it, and their device-side
    markers are left out of the activities."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events
              if e.device_type == cuda and e.name not in ranges]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        entry = by_name[e.name[:100]]
        entry[0] += e.time_range.elapsed_us()
        entry[1] += 1
    by_range = {r: sum(e.device_time_total for e in events
                       if e.name == r and e.device_type != cuda)
                for r in ranges}
    return sum(v[0] for v in by_name.values()), dict(by_name), by_range

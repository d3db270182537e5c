"""Training telemetry (port of ``gpudrive_lab_tpu/utils/profiling.py``)
and the program's spans.

Mirror of the reference's PPO profiling (reference:
gpudrive/integrations/puffer/ppo.py: ``Profile`` per-phase timers and
controlled/padded SPS :426-515, the ``Utilization`` monitor thread
:669-692).  ``Utilization`` reads the device's allocated memory through
``torch.cuda``; ``device_trace`` and ``device_breakdown`` take and read a
torch.profiler trace, and ``kernel_time_ms`` reads one kernel's device time
per launch from one.

``span(name)`` marks a layer of the program where its work happens (the
bench step, the sim step and its systems, the observation and its blocks,
the PPO phases and minibatches, the official VBD sample's stages and the
env's VBD observation block and reward).  Off, a span costs one check of
two flags.  It records while a torch.profiler session records, and inside a
``recording()`` block (only the spans a ``recording(names)`` block names,
where nothing else records).  Then it opens ``record_function(name)`` when a
profiler session is on (the span sits in the profiler's trace, on the
clock of the device's kernels) and keeps a record in memory: its name, its
parent's record, the sequence number of its top-level span, the host
clock at its start and end and, while CUDA is initialised, a pair of
timing events on the current stream (none while the stream is being
captured into a CUDA graph).  A span launches no device operation.
``recorded()`` resolves the records, ``span_ms()`` reads one span's ms
from them, ``clear()`` drops them.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

class Profile:
    """Per-phase wall-clock accounting with agent-SPS summaries."""

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


# ---- spans -----------------------------------------------------------------

# records kept at most; the spans beyond are counted by dropped()
MAX_RECORDS = 1_000_000

_active = 0  # open recording() blocks, of either kind
_all = 0  # open recording() blocks that record every span
_names: dict = {}  # span name -> open recording(names) blocks that name it
_records: list = []  # _Record, in the order the spans opened
_dropped = 0
_top_seq = itertools.count()
_lock = threading.Lock()  # guards _records' indices and the block counts
_local = threading.local()  # .stack: the thread's open spans' _Records


class SpanRecord(NamedTuple):
    """One span as ``recorded()`` gives it."""

    name: str
    parent: int | None  # index of the enclosing span's record
    seq: int  # sequence number of the top-level span it lies in
    start_ns: int  # host perf_counter_ns
    end_ns: int | None  # None while the span is open
    ms: float | None  # stream ms where events were recorded, else host ms
    on_stream: bool  # whether ``ms`` is read from the stream's events


class _Record:
    __slots__ = ("name", "index", "parent", "seq", "start_ns", "end_ns",
                 "start_ev", "end_ev", "ms")

    def __init__(self, name, index, parent, seq):
        self.name, self.index, self.parent, self.seq = name, index, parent, seq
        self.start_ns = self.end_ns = self.start_ev = self.end_ev = None
        self.ms = None  # the stream ms, once the events are resolved


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _event():
    if (not torch.cuda.is_initialized()
            or torch.cuda.is_current_stream_capturing()):
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class span:
    """``with span("sim.step"):`` marks the block as one span of the
    program.  Off (no profiler session, no ``recording()`` block) it only
    checks the two flags."""

    __slots__ = ("name", "_rec", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rec = None

    def __enter__(self):
        if _active or _autograd_profiler._is_profiler_enabled:
            self._open()
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._close()
        return False

    def _open(self):
        global _dropped
        self._rf = None
        if _autograd_profiler._is_profiler_enabled:
            self._rf = _autograd_profiler.record_function(self.name)
            self._rf.__enter__()
        elif not _all and self.name not in _names:
            return
        stack = _stack()
        up = stack[-1] if stack else None
        with _lock:
            if len(_records) < MAX_RECORDS:
                rec = _Record(self.name, len(_records),
                              None if up is None else up.index,
                              next(_top_seq) if up is None else up.seq)
                _records.append(rec)
            else:
                _dropped += 1
                rec = _Record(self.name, None, None, None)
        stack.append(rec)
        self._rec = rec
        rec.start_ns = time.perf_counter_ns()
        rec.start_ev = _event()

    def _close(self):
        rec = self._rec
        rec.end_ev = _event() if rec.start_ev is not None else None
        rec.end_ns = time.perf_counter_ns()
        _stack().pop()
        self._rec = None
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None


@contextlib.contextmanager
def recording(names=None):
    """Spans record inside this block, with or without a profiler session.
    Yields the index of the first record the block can make (for
    ``recorded(start)``, ``span_ms(start=)`` and ``clear(start)``).

    With ``names``, only the spans of those names record here, so a timer
    pays for the spans it reads and for no layer inside them (every span
    still records under a profiler session or an unrestricted block).
    Such a block drops its records at its end, unless a profiler session
    or another block was recording when it began: those records are then
    left to that recorder.  Read them inside the block."""
    global _active, _all
    names = None if names is None else tuple(names)
    with _lock:
        first = len(_records)
        alone = not _active and not _autograd_profiler._is_profiler_enabled
        _active += 1
        if names is None:
            _all += 1
        for n in names or ():
            _names[n] = _names.get(n, 0) + 1
    try:
        yield first
    finally:
        with _lock:
            _active -= 1
            if names is None:
                _all -= 1
            for n in names or ():
                _names[n] -= 1
                if not _names[n]:
                    del _names[n]
        if names is not None and alone:
            clear(first)


def _resolved(start: int) -> list:
    """The _Records from index ``start`` on, their events read (one
    synchronize for all) into stream ms."""
    recs = _records[start:]
    pending = [r for r in recs if r.end_ev is not None]
    if pending:
        torch.cuda.synchronize()
    for r in pending:
        r.ms = r.start_ev.elapsed_time(r.end_ev)
        r.start_ev = r.end_ev = None
    return recs


def _ms(r: _Record) -> float | None:
    if r.ms is not None:
        return r.ms
    return None if r.end_ns is None else (r.end_ns - r.start_ns) * 1e-6


def recorded(start: int = 0) -> list:
    """The records from index ``start`` on, as ``SpanRecord``s: a closed
    span with events gets the stream ms between them, any other its host
    ms.  Call it with no span open."""
    return [SpanRecord(r.name, r.parent, r.seq, r.start_ns, r.end_ns,
                       _ms(r), r.ms is not None) for r in _resolved(start)]


def span_ms(name: str, under: str | None = None, start: int = 0) -> list:
    """The ms of each recorded ``name`` span from record ``start`` on, in
    the order they opened; only those inside an ``under`` span when
    given.  Call it with no span open."""
    _resolved(start)
    out = []
    for r in _records[start:]:
        if r.name != name:
            continue
        p = r.parent
        while under is not None and p is not None:
            if _records[p].name == under:
                break
            p = _records[p].parent
        if under is None or p is not None:
            out.append(_ms(r))
    return out


def clear(start: int = 0) -> None:
    """Drop the records from index ``start`` on (all of them, and the count
    of dropped spans, by default).  Call it with no span open."""
    global _dropped
    del _records[start:]
    if start == 0:
        _dropped = 0


def dropped() -> int:
    """Spans not recorded since the last ``clear()`` because
    ``MAX_RECORDS`` records were held."""
    return _dropped


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
    {range: µs}).  The activities are the device's kernels, copies and
    sets: the device-side markers of ``record_function`` ranges (the
    program's spans among them) are left out.  ``ranges`` names
    ``record_function`` ranges: each gets the device time of the work
    launched inside it."""
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    device = [e for e in events
              if e.device_type == cuda and not e.is_user_annotation]
    by_name = defaultdict(lambda: [0.0, 0])
    for e in device:
        entry = by_name[e.name[:100]]
        entry[0] += e.time_range.elapsed_us()
        entry[1] += 1
    by_range = {r: sum(e.device_time_total for e in events
                       if e.name == r and e.device_type != cuda)
                for r in ranges}
    return sum(v[0] for v in by_name.values()), dict(by_name), by_range


# torch.profiler sessions that kernel_time_ms tries before it gives up.
PROFILER_SESSIONS = 5


def kernel_time_ms(fn, reps: int, kernel: str) -> float:
    """Mean device time in ms of one launch of the CUDA kernel whose name
    contains ``kernel``, over ``reps`` calls of ``fn`` (after one warm-up
    call) under torch.profiler.  This is the kernel's own time on the card:
    the host's work around each launch (checks, allocation, the launch
    call) is not in it.  Before each call the L2 cache is flushed by
    writing twice its size, so the kernel reads its inputs from device
    memory, as a caller that ran other work in between finds them.  The
    mean is over the launches the trace holds.  torch.profiler drops
    events now and then: up to 11 of 100 seen on an H100, and in a few
    sessions most or all of them.  A session whose trace holds fewer than
    half of the launches is therefore run again, up to PROFILER_SESSIONS
    in all; it raises if none holds half, or if a trace holds more
    launches than calls."""
    from torch.profiler import ProfilerActivity, profile

    l2 = torch.cuda.get_device_properties(torch.cuda.current_device())
    flush = torch.empty(2 * l2.L2_cache_size, dtype=torch.uint8,
                        device="cuda")
    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    traced = []
    for _ in range(PROFILER_SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == cuda and kernel in e.name]
        traced.append(len(times))
        if len(times) > reps:
            break
        if len(times) >= reps / 2:
            return sum(times) / len(times) / 1e3
    raise RuntimeError(f"{kernel}: {traced} launches traced in each session "
                       f"over {reps} calls")

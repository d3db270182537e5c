"""road_obs_ms.sim: stream ms per bench step in the observation's road
block (the ``obs.road`` spans under ``bench.step``: the KNN top-200, the
gather and the one-hot), over the traced bench steps.

Read from the port's span records
(``gpudrive_lab_torch.utils.profiling.span_ms()``): a span's stream ms
is the time between its two CUDA events on the stream, the layer's
device work and the device's wait for the host to launch it. Silent
without a trace, in a cell of the other kind, where the port keeps no
records or none of the span, and where the top-level ``bench.step``
records are not one per traced step."""

KIND, COUNT = "sim", "steps_traced"
TOP, SPAN, UNDER = "bench.step", "obs.road", "bench.step"


def read(ctx):
    n = ctx.get(COUNT, 0)
    if ctx.get("driver") != KIND or ctx.get("trace") is None or not n:
        return None
    try:
        from gpudrive_lab_torch.utils.profiling import span_ms
    except ImportError:  # a port without spans
        return None
    ms = span_ms(SPAN, UNDER)
    return sum(ms) / n if ms and len(span_ms(TOP)) == n else None

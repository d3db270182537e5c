"""vbd_denoise_ms.vbd: stream ms per diffusion step in the denoiser (the
``vbd.denoise`` spans inside ``vbd.sample``: the denoiser's call, its
agent and scene attention over every agent, and the scheduler's step),
over the traced episodes' samples.

Read from the port's span records (``profiling.span_ms()``); silent
without a trace, in a cell of another driver, where the port keeps no
records or no sampler counts, and unless the counts and the ``vbd.sample``
records show one sample an episode of ``diffusion_steps`` steps
(``gdbench/vbd.py``'s ``span_reading``)."""

from gdbench.vbd import span_reading


def read(ctx):
    return span_reading(ctx, "vbd.denoise", per_step=True)

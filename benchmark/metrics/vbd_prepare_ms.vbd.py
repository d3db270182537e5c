"""vbd_prepare_ms.vbd: stream ms per VBD sample in its preparation (the
``vbd.prepare`` span inside ``vbd.sample``: the host's sample batch,
``vbd.batch``, and the inputs with the pairwise relations on the device,
``vbd.inputs``), over the traced episodes.

Read from the port's span records (``profiling.span_ms()``); silent
without a trace, in a cell of another driver, where the port keeps no
records or no sampler counts, and unless the counts and the ``vbd.sample``
records show one sample an episode of ``diffusion_steps`` steps
(``gdbench/vbd.py``'s ``span_reading``)."""

from gdbench.vbd import span_reading


def read(ctx):
    return span_reading(ctx, "vbd.prepare")

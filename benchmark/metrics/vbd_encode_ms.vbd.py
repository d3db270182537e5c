"""vbd_encode_ms.vbd: stream ms per VBD sample in the encoder (the
``vbd.encode`` span inside ``vbd.sample``: the agent GRU, the map and
light tokens, the Fourier relation embedding of every token pair and the
6 QCMHA layers), over the traced episodes.

Read from the port's span records (``profiling.span_ms()``); silent
without a trace, in a cell of another driver, where the port keeps no
records or no sampler counts, and unless the counts and the ``vbd.sample``
records show one sample an episode of ``diffusion_steps`` steps
(``gdbench/vbd.py``'s ``span_reading``)."""

from gdbench.vbd import span_reading


def read(ctx):
    return span_reading(ctx, "vbd.encode")

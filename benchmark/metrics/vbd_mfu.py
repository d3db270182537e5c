"""vbd_mfu: the VBD episode's share (%) of the card's float32 peak.

The matrix-product operations of one sample (``gdbench/vbd_flops.py``:
the encoder once, with the relation MLPs over every token pair and the
QCMHA stack, and the denoiser at each diffusion step), counted from the
configuration's published widths and the cell's shapes, divided by the
untraced window's time per episode and the 67 TFLOP/s float32 peak
(``gdbench/roofline.py``; TF32 is off).  The env steps' work is not
counted.  Silent outside this driver's runs on a card, where the port
keeps no sampler counts, and unless the counts show one sample an episode
of ``diffusion_steps`` steps."""

from gdbench import roofline, vbd_flops


def read(ctx):
    if (ctx.get("driver") != "vbd" or not ctx.get("episode_s")
            or ctx["device"].type != "cuda"):
        return None
    n = ctx["episodes"]
    if ctx.get("counts_window") != (n, n * ctx["diffusion_steps"]):
        return None
    flops = vbd_flops.sample_flops(ctx["model"], **ctx["vbd_shapes"])
    return 100.0 * flops / (ctx["episode_s"] * roofline.PEAK_FP32)

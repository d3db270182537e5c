"""launches_per_step.sim: device operations (kernels, copies, sets) per
bench step in the traced window."""


def read(ctx):
    tr = ctx.get("trace")
    n = ctx.get("steps_traced", 0)
    if ctx.get("driver") != "sim" or tr is None or not n:
        return None
    return tr.device_ops / n

"""launches_per_iter.train: device operations (kernels, copies, sets) per
PPO iteration in the traced window."""


def read(ctx):
    tr = ctx.get("trace")
    n = ctx.get("iterations_traced", 0)
    if ctx.get("driver") != "train" or tr is None or not n:
        return None
    return tr.device_ops / n

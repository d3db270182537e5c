"""idle_share.train: the share (%) of the traced window of PPO iterations
in which no operation ran on the device (rank 0)."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("driver") != "train" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

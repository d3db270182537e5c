"""idle_share.vbd: the share (%) of the traced window of VBD episodes (a
reset, a sample and 91 env steps each) in which no operation ran on the
device."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("driver") != "vbd" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

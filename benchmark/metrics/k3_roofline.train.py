"""k3_roofline.train: the share (%) of kernel K3's device time that its
least time takes, over the traced PPO iterations.

K3 (``embed_pool_fwd_kernel``) runs the partner and road embed + pool of
every policy forward: per iteration the rollout's ``rollout_len`` steps and
the bootstrap value on ``compact`` rows, and each of the update's
``update_epochs`` x ``num_minibatches`` minibatches on rollout_len /
num_minibatches x compact rows.  Its least time is the frozen K3 bound
(gdbench/roofline.py) of each launch's shape.  Silent when the trace holds
another number of launches."""

from gdbench import roofline

BLOCKS = ((127, 6), (200, 13))  # partner and road: entities, features


def launch_rows(ppo: dict, rows: int) -> list:
    """Rows of each policy forward of one iteration."""
    T, E, M = ppo["rollout_len"], ppo["update_epochs"], ppo["num_minibatches"]
    return [rows] * (T + 1) + [rows * T // M] * (E * M)


def read(ctx):
    tr = ctx.get("trace")
    iters = ctx.get("iterations_traced", 0)
    if ctx.get("driver") != "train" or tr is None or not iters:
        return None
    n, seconds = tr.kernel("embed_pool_fwd_kernel")
    shapes = launch_rows(ctx["ppo"], ctx["rows"])
    if n != iters * len(shapes) * len(BLOCKS) or seconds <= 0:
        return None
    least = iters * sum(roofline.k3_bound(r, e, f) for r in shapes
                        for e, f in BLOCKS)
    return 100.0 * least / seconds

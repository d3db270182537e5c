"""k4_roofline.train: the share (%) of kernel K4's device time (its
partial sums and their fixed-order sum) that its least time takes, over
the traced PPO iterations.

K4 (``embed_pool_bwd_partial`` and ``sum_partials``) runs the partner and
road embed + pool backward of each of the update's ``update_epochs`` x
``num_minibatches`` minibatches, on rollout_len / num_minibatches x
compact rows.  Its least time is the frozen K4 bound (gdbench/roofline.py)
with the winners per row that the reference counts on the first
minibatch it follows.  Silent when the trace holds another number of
launches."""

from gdbench import roofline

BLOCKS = {"partner": 6, "road": 13}  # features per entity


def read(ctx):
    tr = ctx.get("trace")
    iters = ctx.get("iterations_traced", 0)
    wpr = ctx.get("winners_per_row")
    if ctx.get("driver") != "train" or tr is None or not iters or not wpr:
        return None
    ppo = ctx["ppo"]
    n_mb = ppo["update_epochs"] * ppo["num_minibatches"]
    rows = ctx["rows"] * ppo["rollout_len"] // ppo["num_minibatches"]
    n, partial_s = tr.kernel("embed_pool_bwd_partial")
    _, sum_s = tr.kernel("sum_partials")
    if n != iters * n_mb * len(BLOCKS) or partial_s <= 0:
        return None
    least = iters * n_mb * sum(roofline.k4_bound(rows, f, rows * wpr[b])
                               for b, f in BLOCKS.items())
    return 100.0 * least / (partial_s + sum_s)

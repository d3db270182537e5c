"""k5_roofline.train: the share (%) of kernel K5's device time that its
least time takes, over the traced PPO iterations.

K5 (``flat_obs_kernel``) writes the observations that the update
recomputes for each of its ``update_epochs`` x ``num_minibatches``
minibatches, rollout_len / num_minibatches x compact rows of 3,368 float32,
in one launch.  Its least time is that output written once to device
memory (``roofline.bound``): 476 MB a launch in the train cell, far past
the 50 MB L2.  What it reads, the stored states and the scene, is shared
by the egos of a world and by the time steps and is left out, so the
share cannot pass 100 %.  Silent when the trace holds another number of
launches: a port without K5, or a spec that K5 does not cover."""

from gdbench import roofline

OBS_DIM = 3368  # floats in a row


def read(ctx):
    tr = ctx.get("trace")
    iters = ctx.get("iterations_traced", 0)
    if ctx.get("driver") != "train" or tr is None or not iters:
        return None
    ppo = ctx["ppo"]
    n_mb = ppo["update_epochs"] * ppo["num_minibatches"]
    rows = ctx["rows"] * ppo["rollout_len"] // ppo["num_minibatches"]
    n, seconds = tr.kernel("flat_obs_kernel")
    if n != iters * n_mb or seconds <= 0:
        return None
    least = iters * n_mb * roofline.bound(4 * rows * OBS_DIM, 0)[0]
    return 100.0 * least / seconds

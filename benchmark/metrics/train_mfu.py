"""train_mfu: the PPO iteration's share (%) of the card's float32 peak.

The policy's matrix-product operations over the iteration's rows, counted
once from the configuration's published widths: one forward for each of
the rollout's steps and the bootstrap value on ``compact`` rows, and a
forward and a backward (twice the forward) over every row of each
minibatch; neither the observations' recompute nor the simulator is
counted.  Divided by the untraced window's time per iteration and the
67 TFLOP/s float32 peak (gdbench/roofline.py)."""

from gdbench import roofline


def read(ctx):
    if (ctx.get("driver") != "train" or not ctx.get("iter_s")
            or ctx["device"].type != "cuda"):
        return None
    pol, ppo = ctx["policy"], ctx["ppo"]
    f = roofline.late_fusion_forward_flops(
        pol["ego_feat_dim"], pol["max_agents"] - 1, 6, pol["top_k_roads"],
        13, pol["hidden_dim"], pol["action_dim"], pol["input_dim"])
    T, E = ppo["rollout_len"], ppo["update_epochs"]
    flops = f * ctx["rows"] * ((T + 1) + 3 * E * T)
    return 100.0 * flops / (ctx["iter_s"] * roofline.PEAK_FP32)

"""k2_roofline.sim: the share (%) of kernel K2's device time that its
least time takes, over the traced bench steps.

K2 (``ar_dense_kernel``) runs once a step on the dense path.  Its least
time per step is the frozen K2 bound (gdbench/roofline.py) on that step's
inputs: the agents' kernel rows, rebuilt by the reference from the state
the step returned, and the reference scene's road rows, with the
live-pair operations of reference/sat.py.  Silent when K2 did not run
once per traced step."""

from gdbench import roofline
from gdbench.reference import collision, sat
from gdbench.reference.step import current_step_index


def k2_inputs(scene, state):
    active = ~collision._skip_mask(scene, state, current_step_index(state))
    feat = collision.agent_features(scene, state, active,
                                    collision.agent_half_extents(scene))
    return feat, collision.road_features_t(scene)


def read(ctx):
    tr, states = ctx.get("trace"), ctx.get("traced_states") or []
    if ctx.get("driver") != "sim" or tr is None or not states:
        return None
    n, seconds = tr.kernel("ar_dense_kernel")
    if n != len(states) or seconds <= 0:
        return None
    scene = ctx["reference_scene"]
    least = 0.0
    for s in states:
        feat, roads_t = k2_inputs(scene, s)
        W, A, _ = feat.shape
        least += roofline.k2_bound(W, A, roads_t.shape[2],
                                   sat.live_pair_ops(feat, roads_t))
    return 100.0 * least / seconds

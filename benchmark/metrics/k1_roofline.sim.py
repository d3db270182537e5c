"""k1_roofline.sim: the share (%) of kernel K1's device time that its
least time takes, over the traced bench steps.

K1 (``ar_tiled_kernel``) runs once a step when the scene has road tiles.
Its least time per step is the frozen K1 bound (gdbench/roofline.py) on
that step's inputs: the agents' kernel rows rebuilt by the reference from
the state the step returned, Morton-sorted against the reference scene's
own road tiles, the [agent-block, tile] mask and the live-pair operations
inside it (reference/sat.py).  Silent when K1 did not run once per traced
step."""

from gdbench import roofline
from gdbench.reference import collision, sat
from gdbench.reference.step import current_step_index


def read(ctx):
    tr, states = ctx.get("trace"), ctx.get("traced_states") or []
    if ctx.get("driver") != "sim" or tr is None or not states:
        return None
    n, seconds = tr.kernel("ar_tiled_kernel")
    scene = ctx["reference_scene"]
    if n != len(states) or seconds <= 0 or scene.rtiles is None:
        return None
    tiles = scene.rtiles.feat
    least = 0.0
    for s in states:
        active = ~collision._skip_mask(scene, s, current_step_index(s))
        feat = collision.agent_features(
            scene, s, active, collision.agent_half_extents(scene))
        feat_s, mask, _ = collision.tile_mask_and_order(scene, s, feat)
        W, A, _ = feat_s.shape
        live_tiles = int(mask.amax(dim=1).sum())
        least += roofline.k1_bound(
            W, A, tiles.shape[3], mask.numel(), live_tiles,
            sat.live_pair_ops_tiled(feat_s, tiles, mask))
    return 100.0 * least / seconds

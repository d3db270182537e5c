"""k6_roofline.sim: the share (%) of kernel K6's device time that its
least time takes, over the traced bench steps.

K6 builds each bench step's flat observation in two launches,
``road_select_kernel`` (each ego's road indices and their count) and
``obs_step_kernel`` (the rows and both masks), found by name.  Its least
time per step (``roofline.bound``) is its output written once to device
memory, the W x A rows of 3,368 float32 with their partner mask (127
int32) and road mask (200 bool), and the selection that the first launch
writes into the rows and the second reads back: every row's count
written, each created agent's read, and each created agent's road
indices, min(200, the valid roads in the radius), written and read.  The reference counts those roads on the state each
traced step returned (the observed state but for the worlds reset in that
step).  What K6 reads of the state and the scene, shared by the egos of a
world, is left out, so the share cannot pass 100 %.  Silent unless each
kernel ran once per traced step: a port without K6, or a spec that K6
does not cover."""

from gdbench import roofline

OBS_DIM, PARTNERS, ROADS_K = 3368, 127, 200
CHUNK = 16  # worlds per distance lattice


def index_entries(scene, state, radius: float) -> tuple:
    """(created agents, road indices K6 selects for them) in one state."""
    valid = scene.agents.valid
    entries = 0
    for w in range(0, valid.shape[0], CHUNK):
        d = (scene.roads.pos[w:w + CHUNK, None, :, :2]
             - state.pos[w:w + CHUNK, :, None])
        within = (scene.roads.valid[w:w + CHUNK, None]
                  & ((d * d).sum(-1) <= radius ** 2))
        n = within.sum(-1).clamp(max=ROADS_K)
        entries += int(n[valid[w:w + CHUNK]].sum())
    return int(valid.sum()), entries


def read(ctx):
    tr, states = ctx.get("trace"), ctx.get("traced_states") or []
    if ctx.get("driver") != "sim" or tr is None or not states:
        return None
    n_sel, t_sel = tr.kernel("road_select_kernel")
    n_obs, t_obs = tr.kernel("obs_step_kernel")
    if n_sel != len(states) or n_obs != len(states) or t_sel + t_obs <= 0:
        return None
    scene = ctx["reference_scene"]
    radius = ctx["reference_params"].observation_radius
    W, A = scene.agents.valid.shape
    rows = W * A
    least = 0.0
    for s in states:
        agents, entries = index_entries(scene, s, radius)
        nbytes = (rows * (4 * OBS_DIM + 4 * PARTNERS + ROADS_K)
                  + 4 * (rows + agents) + 8 * entries)
        least += roofline.bound(nbytes, 0)[0]
    return 100.0 * least / (t_sel + t_obs)

"""The road order kernel K6 writes, computed with PyTorch ops, for the tests
of ``env/flat_obs_kernel.py`` on the CPU and on the card, and the ego
selection as flat pairs in ``flat_observation``'s row order.

K6 keeps each ego's roads in the observation radius: KNEAREST the 200 of
least d2, nearest first, ties to the lower road index; LINEAR the first 200
in index order.  ``agent_map_observations`` (``torch.topk``, sorted) gives
the same rows but where two of an ego's 201 nearest roads lie at exactly the
same d2: there ``torch.topk`` orders, and at the 200th place picks, in no
stated way.  Imports torch and the port only (the card machine has no jax).
"""

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import observations as obsmod
from gpudrive_lab_torch.core.types import RoadObsAlgorithm


def ego_pairs(ego_idx, W: int, A: int, device) -> tuple:
    """The ego selection as flat (w_idx [N], a_idx [N]) int64 pairs in the
    row order of ``flat_observation``'s output: all agent rows (None), the
    [W, C] per-world slots, or the flat pairs themselves."""
    if isinstance(ego_idx, tuple):
        w, a = ego_idx
        return (w.to(torch.int64).contiguous(),
                a.to(torch.int64).contiguous())
    if ego_idx is None:
        a = torch.arange(A, device=device).repeat(W)
        return torch.arange(W, device=device).repeat_interleave(A), a
    C_ = ego_idx.shape[1]
    return (torch.arange(W, device=device).repeat_interleave(C_),
            ego_idx.reshape(-1).to(torch.int64).contiguous())


def nearest_first(scene, state, params, ego_idx):
    """(idx [N, 200] int64, count [N], ties [N] bool) of each ego row in
    ``flat_observation``'s row order: the roads in the radius (none for a
    padded ego) in K6's order, how many, and whether two of the row's 201
    nearest share a d2 (always False with LINEAR)."""
    K = C.MAX_AGENT_MAP_OBS
    W, A = state.yaw.shape
    dev = state.pos.device
    w, a = ego_pairs(ego_idx, W, A, dev)
    delta = scene.roads.pos[w, :, 0:2] - state.pos[w, a][:, None, :]
    d2 = (delta * delta).sum(-1)  # [N, R], as agent_map_observations
    within = (scene.roads.valid[w] & (d2 <= params.observation_radius ** 2)
              & scene.agents.valid[w, a][:, None])
    knn = params.road_obs_algorithm == RoadObsAlgorithm.KNEAREST
    key = torch.where(within, d2 if knn else torch.zeros_like(d2),
                      torch.full_like(d2, float("inf")))
    order = torch.sort(key, dim=-1, stable=True)
    idx = order.indices[:, :K]
    count = within.sum(-1).clamp(max=K)
    v = order.values[:, :K + 1]
    ties = ((v[:, :-1] == v[:, 1:]) & torch.isfinite(v[:, 1:])).any(-1)
    return idx, count, ties & knn


def road_rows_at(scene, state, params, ego_idx, idx, count):
    """``agent_map_observations``' [.., 200, 9] rows rebuilt from road
    indices, with its leading axes: the roads' rows, then the fillers (a
    padded ego's and LINEAR's MapObservation::zero, KNEAREST's all-zero
    rows)."""
    W, A = state.yaw.shape
    dev = state.pos.device
    w, a = ego_pairs(ego_idx, W, A, dev)
    rows, _, _ = obsmod._gather_road_features(
        obsmod._packed_road_columns(scene.roads), idx, state.pos[w, a],
        state.yaw[w, a], w)
    filled = torch.arange(C.MAX_AGENT_MAP_OBS, device=dev) < count[:, None]
    filler = obsmod._map_filler(dev)
    if params.road_obs_algorithm == RoadObsAlgorithm.KNEAREST:
        filler = torch.where(scene.agents.valid[w, a][:, None, None],
                             torch.zeros(9, device=dev), filler)
    rows = torch.where(filled[..., None], rows, filler)
    lead = ((W, A) if ego_idx is None
            else (len(w),) if isinstance(ego_idx, tuple)
            else tuple(ego_idx.shape))
    return rows.reshape(lead + rows.shape[1:])

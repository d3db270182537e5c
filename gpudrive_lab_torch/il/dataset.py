"""Expert dataset with frame stacking (port of
``gpudrive_lab_tpu/il/dataset.py``; reference:
gpudrive/integrations/il/dataloader.py:5-230).

A sample is (the observations of the ``rollout_len`` frames up to t, side
by side; the actions at t..t+pred_len-1; the partner and road masks at t)
for a controlled agent alive at t.  The data lives on ``device`` as
tensors and batches are gathered there; the sample index and the shuffle
order are numpy (an ``np.random.Generator``), so that they equal the JAX
package's.
"""

from __future__ import annotations

import numpy as np
import torch

from gpudrive_lab_torch.device import resolve_device


def _tensor(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class ExpertDataset:
    """``data``: the dict of ``data_generation.generate_state_action_pairs``
    (tensors or numpy arrays; obs [T, W, A, D], dead_mask [T, W, A],
    controlled_mask [W, A], ...).  Every entry is held as a tensor on
    ``device`` (CUDA unless the caller names another)."""

    def __init__(self, data: dict, rollout_len: int = 5, pred_len: int = 1,
                 use_action_indices: bool = False, device=None):
        self.rollout_len = rollout_len
        self.pred_len = pred_len
        self.use_action_indices = use_action_indices
        self.device = resolve_device(device)
        self.data = {k: _tensor(v, self.device) for k, v in data.items()}
        T, _, _, D = self.data["obs"].shape
        dead = _host(data["dead_mask"])
        controlled = _host(data["controlled_mask"])
        # valid sample times: t in [rollout_len-1, T - pred_len], agent
        # controlled and alive at t (reference: dataloader.py:60-120)
        samples = []
        for t in range(rollout_len - 1, T - pred_len + 1):
            ws, asq = np.nonzero(~dead[t] & controlled)
            samples.extend((t, w, a) for w, a in zip(ws, asq))
        self.index = np.array(samples, np.int64).reshape(-1, 3)
        self.index_t = torch.as_tensor(self.index, device=self.device)
        self.frame_dim = D

    def __len__(self):
        return len(self.index)

    def batch(self, ids) -> dict:
        """The samples ``ids`` (numpy or tensor indices into ``index``):
        obs [B, rollout_len * D], actions [B, pred_len, 3] (and
        action_idx [B, pred_len] with use_action_indices), partner_mask
        [B, A-1] bool (set where the slot is not a live partner), road_mask
        [B, K], all on the dataset's device."""
        ids = torch.as_tensor(np.asarray(ids) if not isinstance(
            ids, torch.Tensor) else ids, device=self.device).long()
        t, w, a = self.index_t[ids].unbind(1)
        offs = torch.arange(-self.rollout_len + 1, 1, device=self.device)
        d = self.data
        obs = d["obs"][t[:, None] + offs, w[:, None], a[:, None]]
        fut = torch.arange(self.pred_len, device=self.device)
        out = {
            "obs": obs.reshape(len(ids), -1),
            "partner_mask": d["partner_mask"][t, w, a] != 0,
            "road_mask": d["road_mask"][t, w, a],
        }
        if self.use_action_indices and "action_idx" in d:
            out["action_idx"] = d["action_idx"][t[:, None] + fut, w[:, None],
                                                a[:, None]]
        out["actions"] = d["actions"][t[:, None] + fut, w[:, None],
                                      a[:, None]]
        return out

    def iter_batches(self, batch_size: int, rng: np.random.Generator,
                     shuffle: bool = True):
        """Full batches in ``rng``'s permutation (or in order)."""
        n = len(self.index)
        order = rng.permutation(n) if shuffle else np.arange(n)
        for i in range(0, n - batch_size + 1, batch_size):
            yield self.batch(order[i:i + batch_size])

"""Linear probing of frozen BC features (port of
``gpudrive_lab_tpu/il/linear_probing.py``; reference:
baselines/il/linear_probing.py, gpudrive/integrations/il/linear_probing/
lp_model.py).

Linear classification heads trained on the frozen context of a BC policy
measure what it encodes (the future action bin, the future position cell):
the accuracy of a linear readout is the probe's score.  Features and labels
stay on their device; the sample order is numpy's, so that it equals the
JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass
class ProbeConfig:
    lr: float = 1e-3
    epochs: int = 5
    batch_size: int = 256
    future_step: int = 1  # label horizon (steps ahead)
    pos_grid_cells: int = 9  # 3x3 future-position grid (GRID_CELL_COUNT)
    pos_grid_extent: float = 10.0  # meters covered by the grid


def position_grid_labels(rel_future_pos: torch.Tensor, cells: int = 9,
                         extent: float = 10.0) -> torch.Tensor:
    """Ego-frame future displacement [..., 2] -> its cell on a
    sqrt(cells) x sqrt(cells) grid over ``extent`` meters (the reference's
    position classes, GRID_CELL_COUNT=9)."""
    side = int(np.sqrt(cells))
    half = extent / 2
    ix = torch.clamp(((rel_future_pos[..., 0] + half) / extent * side)
                     .long(), 0, side - 1)
    iy = torch.clamp(((rel_future_pos[..., 1] + half) / extent * side)
                     .long(), 0, side - 1)
    return iy * side + ix


class LinearProbe:
    """One linear classification head on frozen features (reference:
    lp_model.py LinearProbAction/LinearProbPosition), trained with Adam on
    the cross-entropy.  ``params`` holds ``w`` [context_dim, classes]
    (drawn N(0, 1/context_dim) from ``generator``, seeded 0 by default) and
    ``b`` (zeros) on ``device``."""

    def __init__(self, context_dim: int, num_classes: int,
                 config: ProbeConfig, device=None,
                 generator: torch.Generator | None = None):
        self.config = config
        self.num_classes = num_classes
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        w = torch.randn((context_dim, num_classes), generator=generator)
        self.params = {
            "w": (w / np.sqrt(context_dim)).to(device).requires_grad_(),
            "b": torch.zeros(num_classes, device=device, requires_grad=True),
        }
        self.opt = torch.optim.Adam(self.params.values(), lr=config.lr)

    def _loss(self, ctx, labels):
        logits = ctx @ self.params["w"] + self.params["b"]
        loss = F.cross_entropy(logits, labels.long())
        acc = (torch.argmax(logits, -1) == labels).float().mean()
        return loss, acc

    def fit(self, contexts: torch.Tensor, labels: torch.Tensor,
            rng: np.random.Generator) -> Dict[str, float]:
        """``epochs`` passes of full batches in ``rng``'s order; returns
        ``evaluate`` on the whole set."""
        n = len(contexts)
        bs = self.config.batch_size
        for _ in range(self.config.epochs):
            order = rng.permutation(n)
            for i in range(0, n - bs + 1, bs):
                ids = torch.as_tensor(order[i:i + bs],
                                      device=contexts.device)
                loss, _ = self._loss(contexts[ids], labels[ids])
                self.opt.zero_grad(set_to_none=True)
                loss.backward()
                self.opt.step()
        return self.evaluate(contexts, labels)

    @torch.no_grad()
    def evaluate(self, contexts, labels) -> Dict[str, float]:
        loss, acc = self._loss(contexts, labels)
        return {"loss": float(loss), "accuracy": float(acc)}


@torch.no_grad()
def extract_contexts(model, dataset, batch_size: int = 256) -> torch.Tensor:
    """The frozen context of every sample of an ExpertDataset [N, 3 D]
    (the analogue of the reference's forward hooks,
    linear_probing.py:77-96)."""
    out = []
    ids_all = np.arange(len(dataset))
    for i in range(0, len(dataset), batch_size):
        b = dataset.batch(ids_all[i:i + batch_size])
        out.append(model(b["obs"], b["partner_mask"], b["road_mask"])[0])
    return torch.cat(out)


def probe_action_and_position(model, dataset, action_idx=None,
                              config: ProbeConfig | None = None
                              ) -> Dict[str, Dict[str, float]]:
    """The two standard probes on frozen features, the future action class
    and the future position cell; per-probe metrics.  The labels are read
    from ``dataset.data`` (``action_idx`` is accepted as in the JAX
    package, which does not read it)."""
    config = config or ProbeConfig()
    rng = np.random.default_rng(0)
    contexts = extract_contexts(model, dataset)
    d = dataset.data
    t, w, a = dataset.index_t.unbind(1)
    T = d["obs"].shape[0]
    t_fut = torch.clamp(t + config.future_step, 0, T - 1)
    results = {}

    act_labels = d["action_idx"][t_fut, w, a]
    probe = LinearProbe(contexts.shape[1], int(act_labels.max()) + 1, config,
                        device=contexts.device)
    results["future_action"] = probe.fit(contexts, act_labels, rng)

    # ego-frame future displacement -> grid cell, from the logged
    # positions (from the actions when the data has none)
    if "positions" in d:
        rel = d["positions"][t_fut, w, a] - d["positions"][t, w, a]
    else:
        rel = d["actions"][t_fut, w, a][:, :2]
    pos_labels = position_grid_labels(rel, config.pos_grid_cells,
                                      config.pos_grid_extent)
    probe_p = LinearProbe(contexts.shape[1], config.pos_grid_cells, config,
                          device=contexts.device)
    results["future_position"] = probe_p.fit(contexts, pos_labels, rng)
    return results

"""Random actor (port of ``gpudrive_lab_tpu/agents/random_actor.py``;
reference: gpudrive/agents/random_actor.py:4-55).  It draws from
``np.random.default_rng(seed)`` as the JAX actor does, so both give the
same actions for the same seed."""

from __future__ import annotations

import numpy as np
import torch

from gpudrive_lab_torch.agents.sim_agent import SimAgentActor


class RandomActor(SimAgentActor):
    def __init__(self, is_controlled_func, action_space_n: int, seed: int = 0,
                 valid_agent_mask=None):
        super().__init__(is_controlled_func, valid_agent_mask)
        self.action_space_n = action_space_n
        self.rng = np.random.default_rng(seed)

    def select_action(self, obs) -> torch.Tensor:
        """[N] int64 actions on ``obs``'s device."""
        n = obs.shape[0]
        return torch.as_tensor(self.rng.integers(0, self.action_space_n, n),
                               device=obs.device)

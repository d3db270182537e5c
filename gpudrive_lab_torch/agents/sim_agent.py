"""Sim-agent actor abstraction (port of
``gpudrive_lab_tpu/agents/sim_agent.py``; reference:
gpudrive/agents/sim_agent.py:4-49): an actor owns a boolean mask of the
agents it controls and maps their observations to actions, so that several
policies can drive disjoint agents of the same worlds
(utils/multi_policy_rollout.py)."""

from __future__ import annotations

import abc

import torch


class SimAgentActor(abc.ABC):
    def __init__(self, is_controlled_func, valid_agent_mask=None):
        """``is_controlled_func(mask)`` -> [W, A] bool of the agents this
        actor drives; ``valid_agent_mask``: [W, A] bool of the agents alive
        in the sim."""
        self.is_controlled_func = is_controlled_func
        self.valid_agent_mask = valid_agent_mask
        self.actor_ids = None

    @abc.abstractmethod
    def select_action(self, obs) -> torch.Tensor:
        """obs: [N, obs_dim] for this actor's agents -> [N] action
        indices."""

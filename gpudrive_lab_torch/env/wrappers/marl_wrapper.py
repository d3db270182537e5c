"""Dict-per-agent MARL view (port of
``gpudrive_lab_tpu/env/wrappers/marl_wrapper.py``).

The reference's JaxMARL adapter (reference: gpudrive/env/wrappers/
jaxmarl_wrapper.py:25-178, GPUDriveToJaxMARL): one world of the batched
sim through the MultiAgentEnv API, reset and step_env keyed by agent name,
functional over the SimState that the caller carries.  Values are tensors
on the scene's device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.core import step as stepmod
from gpudrive_lab_torch.core.types import Params, Scene, SimState
from gpudrive_lab_torch.env.env_torch import ObsSpec, flat_observation


class GPUDriveMARLEnv:
    """Single-world (W=1) functional MARL view."""

    def __init__(self, scene: Scene, params: Params,
                 action_table: torch.Tensor):
        if scene.num_worlds != 1:
            raise ValueError("the MARL wrapper exposes one world")
        self.scene = scene
        self.params = params
        self.table = action_table
        self.spec = ObsSpec()
        self.max_agents = int(scene.agents.valid.shape[1])
        ctrl = scene.agents.controlled[0]
        self.agent_ids = torch.nonzero(ctrl)[:, 0].tolist()
        self.agents = [f"agent_{i}" for i in self.agent_ids]
        self.num_agents = len(self.agents)
        self._weights = torch.zeros((1, self.max_agents, 3),
                                    device=scene.device)

    def _obs_dict(self, state: SimState) -> Dict[str, torch.Tensor]:
        obs, _, _ = flat_observation(self.scene, state, self.params,
                                     self.spec, self._weights)
        return {name: obs[0, i] for name, i in zip(self.agents,
                                                   self.agent_ids)}

    def reset(self, key=None) -> Tuple[Dict, SimState]:
        state = stepmod.reset(self.scene, None, self.params)
        return self._obs_dict(state), state

    @torch.no_grad()
    def step_env(self, key, state: SimState, actions: Dict[str, int]
                 ) -> Tuple[Dict, SimState, Dict, Dict, Dict]:
        """(obs, state, rewards, dones, infos) keyed per agent
        (reference: jaxmarl_wrapper.py:96-160); ``key`` is unused."""
        act = torch.zeros((1, self.max_agents, C.ACTION_DIM),
                          device=self.scene.device)
        for name, i in zip(self.agents, self.agent_ids):
            act[0, i, :3] = self.table[int(actions[name])]
        state = stepmod.step(self.scene, state, act, self.params)
        obs = self._obs_dict(state)
        rewards = {n: state.reward[0, i]
                   for n, i in zip(self.agents, self.agent_ids)}
        dones = {n: state.done[0, i] != 0
                 for n, i in zip(self.agents, self.agent_ids)}
        dones["__all__"] = bool((state.done[0, self.agent_ids] != 0).all())
        infos = {n: {} for n in self.agents}
        return obs, state, rewards, dones, infos

    def observation_space_dim(self) -> int:
        return ObsSpec().obs_dim

    def action_space_n(self) -> int:
        return int(self.table.shape[0])

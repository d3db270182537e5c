"""Policy-driven actor (port of ``gpudrive_lab_tpu/agents/policy_actor.py``;
reference: gpudrive/agents/policy_actor.py:6-103): rolls out a trained
late-fusion policy for its masked agents.  The weights come from
``variables`` (a state_dict), the port trainer's ``policy.pt`` or the JAX
trainer's ``policy.pkl`` (``networks/convert.load_jax_checkpoint``); the
samples from an explicit ``torch.Generator`` on the policy's device."""

from __future__ import annotations

from pathlib import Path

import torch

from gpudrive_lab_torch.agents.sim_agent import SimAgentActor
from gpudrive_lab_torch.networks.late_fusion import (
    LateFusionPolicy,
    PolicyConfig,
    sample_logits,
)


def load_policy_weights(policy: LateFusionPolicy, checkpoint_path) -> None:
    """Load a ``policy.pt`` of the port trainer (its "policy" entry, or a
    bare state_dict) or a JAX ``policy.pkl`` into ``policy``."""
    path = Path(checkpoint_path)
    if path.suffix == ".pkl":
        from gpudrive_lab_torch.networks import convert

        convert.load_jax_checkpoint(path, policy)
        return
    ckpt = torch.load(path, map_location="cpu")
    policy.load_state_dict(ckpt["policy"] if "policy" in ckpt else ckpt)


class PolicyActor(SimAgentActor):
    def __init__(
        self,
        is_controlled_func,
        variables=None,
        checkpoint_path: str | None = None,
        policy_config: PolicyConfig | None = None,
        deterministic: bool = False,
        seed: int = 0,
        valid_agent_mask=None,
        device=None,
    ):
        super().__init__(is_controlled_func, valid_agent_mask)
        self.policy_config = policy_config or PolicyConfig()
        self.policy = LateFusionPolicy(self.policy_config, device=device)
        if variables is None:
            if not checkpoint_path:
                raise ValueError("need variables or checkpoint_path")
            load_policy_weights(self.policy, checkpoint_path)
        else:
            self.policy.load_state_dict(variables)
        self.policy.eval()
        self.deterministic = deterministic
        dev = next(self.policy.parameters()).device
        self.generator = torch.Generator(device=dev).manual_seed(seed)

    @torch.no_grad()
    def select_action(self, obs) -> torch.Tensor:
        logits, _ = self.policy(obs)
        action, _, _ = sample_logits(self.generator, logits,
                                     deterministic=self.deterministic)
        return action

from gpudrive_lab_torch.agents.core import merge_actions
from gpudrive_lab_torch.agents.policy_actor import PolicyActor
from gpudrive_lab_torch.agents.random_actor import RandomActor
from gpudrive_lab_torch.agents.sim_agent import SimAgentActor

__all__ = ["merge_actions", "PolicyActor", "RandomActor", "SimAgentActor"]

"""Late-fusion actor-critic policy (port of
``gpudrive_lab_tpu/networks/late_fusion.py``; reference:
gpudrive/networks/late_fusion.py:69-248).

Per-modality MLP embeddings (ego 6->64, partner 6->64, road 13->64), a max
over entities, a shared Linear 192->128, then actor logits and a critic
value.  Module names are the reference ``NeuralNet``'s state_dict keys
(ego_embed.{0,1,4}, partner_embed, road_map_embed, shared_embed.0, actor,
critic), so ``networks/convert.params_from_flax`` carries flax weights over.

Numerics follow flax rather than torch's defaults: LayerNorm eps is 1e-6
and gelu is the tanh approximation.  With ``fused_embed`` the partner and
road blocks go through kernel K3 (networks/fused_embed.py); its backward is
not ported yet, so that path serves inference only.  The LSTM variant, the
bf16 compute dtype and activation rematerialisation of the JAX package come
with the training slice.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from gpudrive_lab_torch import constants as C
from gpudrive_lab_torch.device import resolve_device
from gpudrive_lab_torch.networks.fused_embed import LN_EPS, fused_embed_pool


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    action_dim: int = 91  # 7 accel x 13 steer (reference default)
    input_dim: int = 64
    hidden_dim: int = 128
    act_func: str = "tanh"
    ego_feat_dim: int = C.EGO_FEAT_DIM  # +3 when reward_conditioned
    max_agents: int = C.MAX_AGENTS
    top_k_roads: int = C.MAX_AGENT_MAP_OBS
    # Route the partner/road embed+pool through kernel K3 (forward only).
    fused_embed: bool = False

    @property
    def obs_dim(self) -> int:
        return (
            self.ego_feat_dim
            + (self.max_agents - 1) * C.PARTNER_FEAT_DIM
            + self.top_k_roads * C.ROAD_GRAPH_FEAT_DIM
        )


def _embed(in_dim: int, dim: int, act: str) -> nn.Sequential:
    """Linear(0) -> LayerNorm(1) -> act(2) -> Dropout slot(3) -> Linear(4),
    the reference's Sequential (its dropout is off in evaluation and flax
    has none, so slot 3 is an identity)."""
    return nn.Sequential(
        nn.Linear(in_dim, dim),
        nn.LayerNorm(dim, eps=LN_EPS),
        nn.Tanh() if act == "tanh" else nn.GELU(approximate="tanh"),
        nn.Identity(),
        nn.Linear(dim, dim),
    )


class LateFusionPolicy(nn.Module):
    """obs [..., obs_dim] -> (logits [..., action_dim], value [...]).

    Weights are drawn from ``generator`` (a CPU ``torch.Generator``; the
    global RNG when None) with the reference's layer init: orthogonal,
    gain sqrt(2) for the embeds and the shared layer, 0.01 for the actor and
    1.0 for the critic, zero biases.  The module lives on ``device`` (CUDA
    unless the caller names another)."""

    def __init__(self, config: PolicyConfig = PolicyConfig(), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = config
        self.config = cfg
        d = cfg.input_dim
        self.ego_embed = _embed(cfg.ego_feat_dim, d, cfg.act_func)
        self.partner_embed = _embed(C.PARTNER_FEAT_DIM, d, cfg.act_func)
        self.road_map_embed = _embed(C.ROAD_GRAPH_FEAT_DIM, d, cfg.act_func)
        self.shared_embed = nn.Sequential(nn.Linear(3 * d, cfg.hidden_dim),
                                          nn.Identity())
        self.actor = nn.Linear(cfg.hidden_dim, cfg.action_dim)
        self.critic = nn.Linear(cfg.hidden_dim, 1)
        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, nn.Linear):
                    gain = {"actor": 0.01, "critic": 1.0}.get(name, 2 ** 0.5)
                    nn.init.orthogonal_(m.weight, gain, generator=generator)
                    nn.init.zeros_(m.bias)
        self.to(resolve_device(device))

    def _pool(self, embed: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        """max over the entity axis of embed(x); x [..., E, F]."""
        if not self.config.fused_embed:
            return embed(x).max(dim=-2).values
        lin1, ln, _, _, lin2 = embed
        lead = x.shape[:-2]
        pooled = fused_embed_pool(
            x.reshape((-1,) + x.shape[-2:]),
            lin1.weight.t().contiguous(), lin1.bias, ln.weight, ln.bias,
            lin2.weight.t().contiguous(), lin2.bias, self.config.act_func,
        )
        return pooled.reshape(lead + (pooled.shape[-1],))

    def forward(self, obs: torch.Tensor):
        cfg = self.config
        e = cfg.ego_feat_dim
        p = (cfg.max_agents - 1) * C.PARTNER_FEAT_DIM
        lead = obs.shape[:-1]
        ego = obs[..., :e]
        partner = obs[..., e:e + p].unflatten(
            -1, (cfg.max_agents - 1, C.PARTNER_FEAT_DIM)
        )
        road = obs[..., e + p:].unflatten(
            -1, (cfg.top_k_roads, C.ROAD_GRAPH_FEAT_DIM)
        )
        hidden = self.shared_embed(
            torch.cat(
                [
                    self.ego_embed(ego),
                    self._pool(self.partner_embed, partner),
                    self._pool(self.road_map_embed, road),
                ],
                dim=-1,
            )
        )
        logits = self.actor(hidden)
        value = self.critic(hidden)[..., 0]
        return logits.reshape(lead + (cfg.action_dim,)), value


def sample_logits(generator: torch.Generator | None, logits: torch.Tensor,
                  action=None, deterministic: bool = False):
    """Categorical sample, its log-probability and the entropy
    (reference: late_fusion.py sample_logits via pufferlib).  Actions are
    int32; ``generator`` lives on the logits' device."""
    log_probs = torch.log_softmax(logits, dim=-1)
    if action is None:
        if deterministic:
            action = torch.argmax(logits, dim=-1)
        else:
            flat = log_probs.exp().reshape(-1, logits.shape[-1])
            action = torch.multinomial(
                flat, 1, generator=generator
            ).reshape(logits.shape[:-1])
    action = action.to(torch.int32)
    logprob = torch.gather(log_probs, -1, action[..., None].long())[..., 0]
    probs = log_probs.exp()
    entropy = -(probs * log_probs).sum(-1)
    return action, logprob, entropy
